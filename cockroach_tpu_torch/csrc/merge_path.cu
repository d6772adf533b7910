// LSM run merge for Hopper (sm_90a): a merge-path (co-rank) merge of two
// sorted runs in one launch.
//
// Replaces the TPU kernel `_merge_kernel` in
// cockroach_tpu/storage/pallas_merge.py:103 (wrapped there by
// `_merge_perm`, `merge_pair` and `merge_runs`). Only the permutation into
// [A; B] leaves the kernel: slots 0 .. n_a+n_b-1 hold the rows of [A; B]
// in merged order, the remaining slots -1.
//
// Order: a row's composite key is (live ? 0 : 1, the two key words as
// big-endian unsigned 64-bit values, ts descending, seq descending),
// compared as unsigned words. On equal composites A wins, and within a
// run the earlier row wins: exactly the index tie-break of a stable sort
// of [A; B], so the permutation equals that sort, ties included.
//
// Precondition: each run is sorted under that full order, dead rows
// included. RunBuilder._merge (storage/ingest.py) gets runs from
// `sort_block`; the compaction merge (Engine._merge_for_compaction,
// storage/lsm.py) gets runs that `sort_block` + `_shrink`, `ingest` or
// `resolve_intents` left sorted; a tournament round's output carries its
// pads as the largest dead rows (`gather_merged`). On unsorted input the
// result is not a merge, but every read stays inside the runs.
//
// Why merge path: the TPU kernel (and this port's first kernel) sorted
// the pair with a bitonic network, O(N log N) compare-exchanges on inputs
// that are already sorted, which on this card meant 8 global stages of
// 40-byte records through device memory and 10 launches a call. A merge
// needs O(N) work and each input row read once.
//
// Design: each block owns kTile consecutive output slots. Two warps find
// where the block's first and last diagonals cross the merge path with a
// warp-cooperative 32-ary search (one ballot a round: 4 dependent rounds
// of loads for 2^17-row runs where a binary search needs 17). The block
// then holds exactly its kTile input rows: it copies its A and B slices
// into shared memory as byte-swapped structure-of-arrays words with
// coalesced loads, each thread co-ranks its own kItems-slot sub-diagonal
// there by binary search, merges its items serially and stages the
// permutation in shared memory for one coalesced store.
//
// kTile = 256 threads x 4 items = 1,024 slots: 33 B/row of keys plus
// 4 B/slot of staged permutation is 37,888 B of static shared memory,
// under the 48 KB that needs no opt-in, so up to 6 blocks share an SM.
// The YCSB load pair (2^18 slots, 256 blocks) is one wave of about two
// blocks per SM. Of 64 to 512 threads per block at 512- and 1,024-slot
// tiles, this shape timed fastest on the card at 2 x 2^17 and 2 x 2^20.
//
// Bound on this card: bytes. Each input row is read once (16 key + 8 ts
// + 8 seq + 1 mask = 33 B) and each slot written once (4 B). At 2 x 2^17
// rows that is 9.7 MB, about 3 us at 3.35 TB/s; one launch of a wave of
// blocks whose search is a chain of dependent loads is latency-bound
// there.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 4;
constexpr int kTile = kThreads * kItems;
constexpr unsigned kAll = 0xffffffffu;

struct Run {
  const ulonglong2* key;
  const int64_t* ts;
  const int64_t* seq;
  const uint8_t* mask;
  int64_t n;
};

// A row's composite sort key as unsigned words.
struct Key {
  unsigned long long k0, k1, ts, seq;
  unsigned dead;
};

struct Tile {
  unsigned long long k0[kTile], k1[kTile], ts[kTile], seq[kTile];
  int out[kTile];
  uint8_t dead[kTile];
};

__device__ __forceinline__ unsigned long long bswap64(unsigned long long x) {
  const unsigned lo = static_cast<unsigned>(x);
  const unsigned hi = static_cast<unsigned>(x >> 32);
  return (static_cast<unsigned long long>(__byte_perm(lo, 0, 0x0123)) << 32) |
         __byte_perm(hi, 0, 0x0123);
}

__device__ __forceinline__ Key load_key(const Run& r, int64_t row) {
  const unsigned long long kSign = 1ull << 63;
  const ulonglong2 k = r.key[row];
  return {bswap64(k.x), bswap64(k.y),
          ~(static_cast<unsigned long long>(r.ts[row]) ^ kSign),
          ~(static_cast<unsigned long long>(r.seq[row]) ^ kSign),
          r.mask[row] ? 0u : 1u};
}

__device__ __forceinline__ Key tile_key(const Tile& s, int r) {
  return {s.k0[r], s.k1[r], s.ts[r], s.seq[r], s.dead[r]};
}

// a <= b: a row of A at a goes before a row of B at b (A wins ties).
__device__ __forceinline__ bool key_le(const Key& a, const Key& b) {
  if (a.dead != b.dead) return a.dead < b.dead;
  if (a.k0 != b.k0) return a.k0 < b.k0;
  if (a.k1 != b.k1) return a.k1 < b.k1;
  if (a.ts != b.ts) return a.ts < b.ts;
  return a.seq <= b.seq;
}

// The number of A rows among the first d merged rows. All 32 lanes of a
// warp call it with the same d. The answer is the first i in [lo, hi)
// whose A row does not go before B row d-1-i (else hi); each round 32
// lanes probe 32 splits and a ballot keeps the bracket holding the first
// "not before", 1/32 of the range.
__device__ int64_t corank(const Run& a, const Run& b, int64_t d) {
  const int lane = threadIdx.x & 31;
  int64_t lo = d > b.n ? d - b.n : 0;
  int64_t hi = d < a.n ? d : a.n;
  while (lo < hi) {
    const int64_t len = hi - lo;
    const int64_t p = len >= 32 ? lo + len * lane / 32 : lo + lane;
    const bool before = (len >= 32 || lane < len) &&
                        key_le(load_key(a, p), load_key(b, d - 1 - p));
    const int first = __ffs(~__ballot_sync(kAll, before)) - 1;  // -1: none
    const int last = first < 0 ? 31 : first - 1;                 // -1: none
    const int64_t p_last = __shfl_sync(kAll, p, last < 0 ? 0 : last);
    const int64_t p_first = __shfl_sync(kAll, p, first < 0 ? 0 : first);
    if (last >= 0) lo = p_last + 1;
    if (first >= 0) hi = p_first;
  }
  return lo;
}

__global__ void __launch_bounds__(kThreads)
    merge_path_kernel(Run a, Run b, int64_t n_out, int* __restrict__ perm) {
  __shared__ Tile sm;
  __shared__ int64_t split[2];
  const int64_t n = a.n + b.n;
  const int64_t slot0 = static_cast<int64_t>(blockIdx.x) * kTile;
  const int64_t d0 = slot0 < n ? slot0 : n;
  const int64_t d1 = slot0 + kTile < n ? slot0 + kTile : n;
  const int warp = threadIdx.x >> 5;
  if (warp < 2) {
    const int64_t i = corank(a, b, warp ? d1 : d0);
    if ((threadIdx.x & 31) == 0) split[warp] = i;
  }
  __syncthreads();
  const int cnt = static_cast<int>(d1 - d0);
  const int64_t a0 = split[0];
  const int64_t b0 = d0 - a0;
  const int64_t span = split[1] - a0;
  const int na = static_cast<int>(span < 0 ? 0 : (span > cnt ? cnt : span));
  const int nb = cnt - na;

  // Stage the block's rows of A then B; the min() keeps reads inside the
  // runs even if an input breaks the precondition.
  for (int r = threadIdx.x; r < cnt; r += kThreads) {
    const bool from_a = r < na;
    const int64_t row = from_a ? a0 + r : b0 + (r - na);
    const int64_t last = (from_a ? a.n : b.n) - 1;
    const Key k = load_key(from_a ? a : b, row < last ? row : last);
    sm.k0[r] = k.k0;
    sm.k1[r] = k.k1;
    sm.ts[r] = k.ts;
    sm.seq[r] = k.seq;
    sm.dead[r] = static_cast<uint8_t>(k.dead);
  }
  __syncthreads();

  // This thread's slots [t0, t1) of the tile: co-rank t0 in shared
  // memory, then merge serially.
  const int t0 = min(static_cast<int>(threadIdx.x) * kItems, cnt);
  const int t1 = min(t0 + kItems, cnt);
  int lo = max(0, t0 - nb);
  int hi = min(t0, na);
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (key_le(tile_key(sm, mid), tile_key(sm, na + t0 - 1 - mid)))
      lo = mid + 1;
    else
      hi = mid;
  }
  int i = lo;
  int j = t0 - lo;
  for (int s = t0; s < t1; ++s) {
    const bool take_a =
        i < na && (j >= nb || key_le(tile_key(sm, i), tile_key(sm, na + j)));
    sm.out[s] = take_a ? static_cast<int>(a0 + i)
                       : static_cast<int>(a.n + b0 + j);
    if (take_a)
      ++i;
    else
      ++j;
  }
  __syncthreads();

  for (int r = threadIdx.x; r < kTile; r += kThreads) {
    const int64_t s = slot0 + r;
    if (s < n_out) perm[s] = r < cnt ? sm.out[r] : -1;
  }
}

}  // namespace

// perm: n_out >= n_a + n_b int32 slots. Returns the launch error, else 0.
extern "C" int ct_merge_path(const void* a_key, const void* a_ts,
                             const void* a_seq, const void* a_mask,
                             long long n_a, const void* b_key,
                             const void* b_ts, const void* b_seq,
                             const void* b_mask, long long n_b,
                             long long n_out, void* perm, void* stream) {
  if (n_out < n_a + n_b) return static_cast<int>(cudaErrorInvalidValue);
  if (n_out <= 0) return 0;
  const Run a{static_cast<const ulonglong2*>(a_key),
              static_cast<const int64_t*>(a_ts),
              static_cast<const int64_t*>(a_seq),
              static_cast<const uint8_t*>(a_mask), n_a};
  const Run b{static_cast<const ulonglong2*>(b_key),
              static_cast<const int64_t*>(b_ts),
              static_cast<const int64_t*>(b_seq),
              static_cast<const uint8_t*>(b_mask), n_b};
  merge_path_kernel<<<static_cast<unsigned>((n_out + kTile - 1) / kTile),
                      kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      a, b, n_out, static_cast<int*>(perm));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* ct_merge_path_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
