// LSM run merge for Hopper (sm_90a): a bitonic merge of two sorted runs.
//
// Replaces the TPU kernel `_merge_kernel` in
// cockroach_tpu/storage/pallas_merge.py (wrapped there by `_merge_perm`,
// `merge_pair` and `merge_runs`). Two runs sorted in the canonical MVCC
// order, laid out as [A; pads; reversed B], form a bitonic sequence, which
// log2(N) compare-exchange stages sort. Only the permutation into [A; B]
// leaves the kernel, with -1 for pad slots.
//
// Order (a record per row): livemask (0 live, 1 dead, 2 pad), the two key
// words as big-endian unsigned 64-bit values, ts descending, seq
// descending, then the row's index in [A; B]. The index makes the order
// total, so the result equals a stable sort of [A; B] exactly, ties
// included. (The TPU kernel's select collapses equal keys onto one row;
// a swap of the whole record cannot duplicate or lose a row.)
//
// Bound on this card: bytes. The TPU kernel kept the whole merge in VMEM,
// which capped it at 2^17 rows. Here the stages whose stride spans more
// than one tile run as one launch each through device memory (a 40-byte
// record read and written per row per stage), and the last log2(kTile)
// stages run in one shared-memory kernel per tile of kTile records (40 KB
// of the 227 KB a block may use), which also writes the permutation. So
// the only cap is device memory (see `eligible` in storage/cuda_merge.py).
// A merge of N rows moves 40 B/row to build the records, 80 B/row for each
// global stage, 80 B/row for the shared stages and 4 B/row of permutation.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 1024;
constexpr int kLoadThreads = 256;

struct __align__(8) Rec {
  unsigned long long k0, k1, ts, seq;
  unsigned int live;
  int idx;
};

__device__ __forceinline__ unsigned long long bswap64(unsigned long long x) {
  const unsigned lo = static_cast<unsigned>(x);
  const unsigned hi = static_cast<unsigned>(x >> 32);
  return (static_cast<unsigned long long>(__byte_perm(lo, 0, 0x0123)) << 32) |
         __byte_perm(hi, 0, 0x0123);
}

__device__ __forceinline__ bool rec_lt(const Rec& a, const Rec& b) {
  if (a.live != b.live) return a.live < b.live;
  if (a.k0 != b.k0) return a.k0 < b.k0;
  if (a.k1 != b.k1) return a.k1 < b.k1;
  if (a.ts != b.ts) return a.ts < b.ts;
  if (a.seq != b.seq) return a.seq < b.seq;
  return static_cast<unsigned>(a.idx) < static_cast<unsigned>(b.idx);
}

__device__ __forceinline__ Rec load_rec(const ulonglong2* key,
                                        const int64_t* ts,
                                        const int64_t* seq,
                                        const uint8_t* mask, int64_t row,
                                        int idx) {
  const unsigned long long kSign = 1ull << 63;
  const ulonglong2 k = key[row];
  Rec r;
  r.k0 = bswap64(k.x);
  r.k1 = bswap64(k.y);
  r.ts = ~(static_cast<unsigned long long>(ts[row]) ^ kSign);
  r.seq = ~(static_cast<unsigned long long>(seq[row]) ^ kSign);
  r.live = mask[row] ? 0u : 1u;
  r.idx = idx;
  return r;
}

// Slot s of [A; pads; reversed(B; pads)], N = 2 * half slots.
__global__ void load_kernel(const ulonglong2* a_key, const int64_t* a_ts,
                            const int64_t* a_seq, const uint8_t* a_mask,
                            int64_t n_a, const ulonglong2* b_key,
                            const int64_t* b_ts, const int64_t* b_seq,
                            const uint8_t* b_mask, int64_t n_b, int64_t half,
                            Rec* out) {
  const int64_t s = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  const int64_t n = 2 * half;
  if (s >= n) return;
  Rec r{0ull, 0ull, 0ull, 0ull, 2u, -1};
  if (s < half) {
    if (s < n_a) r = load_rec(a_key, a_ts, a_seq, a_mask, s,
                              static_cast<int>(s));
  } else {
    const int64_t t = n - 1 - s;
    if (t < n_b) r = load_rec(b_key, b_ts, b_seq, b_mask, t,
                              static_cast<int>(n_a + t));
  }
  out[s] = r;
}

// One compare-exchange stage at stride s >= kTile over all N/2 pairs.
__global__ void exchange_global(Rec* r, int64_t pairs, int64_t s) {
  const int64_t p = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (p >= pairs) return;
  const int64_t lo = ((p & ~(s - 1)) << 1) | (p & (s - 1));
  const int64_t hi = lo + s;
  const Rec x = r[lo];
  const Rec y = r[hi];
  if (rec_lt(y, x)) {
    r[lo] = y;
    r[hi] = x;
  }
}

// The stages at strides tile/2 .. 1 for one tile, then the permutation.
__global__ void __launch_bounds__(kTile / 2)
    exchange_shared(const Rec* r, int tile, int* perm) {
  __shared__ Rec sm[kTile];
  const int64_t base = static_cast<int64_t>(blockIdx.x) * tile;
  for (int t = threadIdx.x; t < tile; t += blockDim.x) sm[t] = r[base + t];
  __syncthreads();
  for (int s = tile / 2; s >= 1; s >>= 1) {
    for (int p = threadIdx.x; p < tile / 2; p += blockDim.x) {
      const int lo = ((p & ~(s - 1)) << 1) | (p & (s - 1));
      const int hi = lo + s;
      const Rec x = sm[lo];
      const Rec y = sm[hi];
      if (rec_lt(y, x)) {
        sm[lo] = y;
        sm[hi] = x;
      }
    }
    __syncthreads();
  }
  for (int t = threadIdx.x; t < tile; t += blockDim.x)
    perm[base + t] = sm[t].live == 2u ? -1 : sm[t].idx;
}

}  // namespace

extern "C" long long ct_bitonic_record_bytes() { return sizeof(Rec); }

// half: a power of two >= max(n_a, n_b); scratch: 2 * half records;
// perm: 2 * half int32. Returns the first launch error, else 0.
extern "C" int ct_bitonic_merge(const void* a_key, const void* a_ts,
                                const void* a_seq, const void* a_mask,
                                long long n_a, const void* b_key,
                                const void* b_ts, const void* b_seq,
                                const void* b_mask, long long n_b,
                                long long half, void* scratch, void* perm,
                                void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int64_t n = 2 * half;
  Rec* rec = static_cast<Rec*>(scratch);
  load_kernel<<<static_cast<unsigned>((n + kLoadThreads - 1) / kLoadThreads),
                kLoadThreads, 0, st>>>(
      static_cast<const ulonglong2*>(a_key),
      static_cast<const int64_t*>(a_ts), static_cast<const int64_t*>(a_seq),
      static_cast<const uint8_t*>(a_mask), n_a,
      static_cast<const ulonglong2*>(b_key),
      static_cast<const int64_t*>(b_ts), static_cast<const int64_t*>(b_seq),
      static_cast<const uint8_t*>(b_mask), n_b, half, rec);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tile = static_cast<int>(n < kTile ? n : kTile);
  const int64_t pairs = n / 2;
  for (int64_t s = n / 2; s >= tile; s >>= 1) {
    exchange_global<<<static_cast<unsigned>((pairs + 255) / 256), 256, 0,
                      st>>>(rec, pairs, s);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  exchange_shared<<<static_cast<unsigned>(n / tile), kTile / 2, 0, st>>>(
      rec, tile, static_cast<int*>(perm));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* ct_bitonic_merge_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
