// MVCC window scan filter for Hopper (sm_90a): a one-pass strip scan.
//
// Replaces the TPU kernel `_scan_filter_kernel` in
// cockroach_tpu/storage/pallas_scan.py (wrapped there by
// `pallas_scan_filter`). It computes the pebbleMVCCScanner decision over B
// scan windows of CW lanes each, exactly as the port's plain version
// `mvcc_scan_filter(..., window=CW)` does:
//
//   - a key run starts at lane 0, after a dead lane, or where the 16-byte
//     key differs from the previous lane's;
//   - a lane is visible if it is live and committed with ts <= read_ts, or
//     the reader's own intent;
//   - selected: the first visible lane of its run, unless a tombstone;
//   - conflict: a live foreign intent with ts <= read_ts at or before the
//     first visible lane of its run.
//
// Both outputs need only "is there a visible lane in [run start, i)?".
// With A(i) = the last run start at or before i and W(i) = the last
// visible lane before i, that is W(i) >= A(i). A and W are prefix
// maxima, so the TPU kernel's segmented min-scan plus reverse fill
// becomes two plain max-scans.
//
// Layout: one block per window row, kThreads threads of kLanes
// consecutive lanes each, so a pass covers a kChunk-lane chunk (a whole
// 640-lane YCSB window in one pass). A thread issues all its loads up
// front as wide loads (8 mask and 8 tomb bytes as one 64-bit word each,
// ts and txn as 16-byte pairs, keys as 16-byte words), scans its own
// strip serially, gets lane i-1 of its first lane from its left
// neighbour by shuffle (through shared memory at a warp edge, from the
// previous chunk at a chunk edge), and joins one warp max-scan and one
// cross-warp step: two barriers per chunk. Outputs leave as 8-byte
// stores. Longer rows walk chunks with the (A, W) carry in registers, so
// a row may be any length (window growth reaches S * 2^20 lanes).
//
// Bound on this card: bytes. Each lane reads 16 key + 8 ts + 8 txn +
// 1 tomb + 1 mask bytes and writes 2 (36 B/lane); at the YCSB shape
// (128 x 640 lanes, 2.9 MB) that is under a microsecond of HBM traffic,
// below the cost of one launch, so the kernel is latency-bound there:
// one round of loads, one scan and one round of stores per row is the
// least it can do. Keys are compared as two 8-byte words; equality needs
// no byte swap.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kLanes = 8;  // a strip's mask, tomb and outputs: one 8-byte word
constexpr int kChunk = kThreads * kLanes;
constexpr unsigned kAll = 0xffffffffu;

// kVec: the wide loads and stores; false for inputs whose fields are not
// aligned to them (a view at an odd row offset), which take byte-wide and
// 8-byte accesses of the same lanes instead.
template <bool kVec>
__global__ void __launch_bounds__(kThreads)
    scan_filter_kernel(const ulonglong2* __restrict__ key,
                       const int64_t* __restrict__ ts,
                       const int64_t* __restrict__ txn,
                       const uint8_t* __restrict__ tomb,
                       const uint8_t* __restrict__ mask, int64_t read_ts,
                       int64_t reader, int cw, uint8_t* __restrict__ sel,
                       uint8_t* __restrict__ conf) {
  // The last lane of each warp's last strip: key words and bits (bit 0
  // live, bit 1 visible).
  __shared__ unsigned long long edge_k0[kWarps], edge_k1[kWarps];
  __shared__ unsigned edge_bits[kWarps];
  // Each warp's inclusive (A, W) maxima.
  __shared__ int warp_a[kWarps], warp_w[kWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t base = static_cast<int64_t>(blockIdx.x) * cw;
  int carry_a = -1;  // last run start in the previous chunks of the row
  int carry_w = -1;  // last visible lane in the previous chunks
  // The previous chunk's last lane, for thread 0 (nothing at row start).
  unsigned long long last_k0 = 0, last_k1 = 0;
  unsigned last_bits = 0;
  for (int c0 = 0; c0 < cw; c0 += kChunk) {
    const int i0 = c0 + static_cast<int>(threadIdx.x) * kLanes;
    const bool in = i0 < cw;  // cw % kLanes == 0: a strip is all in or out
    const int64_t g = base + i0;
    ulonglong2 k[kLanes];
    int64_t t[kLanes], x[kLanes];
    unsigned long long mk = 0, tb = 0;  // byte l: lane l's mask / tomb
#pragma unroll
    for (int l = 0; l < kLanes; ++l) {
      k[l] = make_ulonglong2(0ull, 0ull);
      t[l] = 0;
      x[l] = 0;
    }
    if (in) {
      if constexpr (kVec) {
        mk = *reinterpret_cast<const unsigned long long*>(mask + g);
        tb = *reinterpret_cast<const unsigned long long*>(tomb + g);
#pragma unroll
        for (int l = 0; l < kLanes; l += 2) {
          const longlong2 tt = *reinterpret_cast<const longlong2*>(ts + g + l);
          const longlong2 xx = *reinterpret_cast<const longlong2*>(txn + g + l);
          t[l] = tt.x;
          t[l + 1] = tt.y;
          x[l] = xx.x;
          x[l + 1] = xx.y;
        }
      } else {
#pragma unroll
        for (int l = 0; l < kLanes; ++l) {
          mk |= static_cast<unsigned long long>(mask[g + l] != 0) << (8 * l);
          tb |= static_cast<unsigned long long>(tomb[g + l] != 0) << (8 * l);
          t[l] = ts[g + l];
          x[l] = txn[g + l];
        }
      }
#pragma unroll
      for (int l = 0; l < kLanes; ++l) k[l] = key[g + l];
    }

    unsigned live = 0, vis = 0;  // bit l: lane l
#pragma unroll
    for (int l = 0; l < kLanes; ++l) {
      const bool m = (mk >> (8 * l)) & 0xffu;
      const bool v = m && (x[l] == 0 ? t[l] <= read_ts : x[l] == reader);
      live |= static_cast<unsigned>(m) << l;
      vis |= static_cast<unsigned>(v) << l;
    }

    // Lane i0-1 (p0, p1, pbits): the left neighbour's last lane.
    const unsigned mine = ((live >> (kLanes - 1)) & 1u) |
                          (((vis >> (kLanes - 1)) & 1u) << 1);
    unsigned long long p0 = __shfl_up_sync(kAll, k[kLanes - 1].x, 1);
    unsigned long long p1 = __shfl_up_sync(kAll, k[kLanes - 1].y, 1);
    unsigned pbits = __shfl_up_sync(kAll, mine, 1);
    if (lane == 31) {
      edge_k0[warp] = k[kLanes - 1].x;
      edge_k1[warp] = k[kLanes - 1].y;
      edge_bits[warp] = mine;
    }
    __syncthreads();
    if (lane == 0) {
      if (warp > 0) {
        p0 = edge_k0[warp - 1];
        p1 = edge_k1[warp - 1];
        pbits = edge_bits[warp - 1];
      } else {
        p0 = last_k0;
        p1 = last_k1;
        pbits = last_bits;
      }
    }
    if (threadIdx.x == 0) {
      last_k0 = edge_k0[kWarps - 1];
      last_k1 = edge_k1[kWarps - 1];
      last_bits = edge_bits[kWarps - 1];
    }

    // The strip's own inclusive maxima, lane by lane; bit l of prev_*
    // is lane l-1's.
    const unsigned prev_live = (live << 1) | (pbits & 1u);
    const unsigned prev_vis = (vis << 1) | ((pbits >> 1) & 1u);
    int la[kLanes], lw[kLanes];
    int a = -1, w = -1;
#pragma unroll
    for (int l = 0; l < kLanes; ++l) {
      if (((live >> l) & 1u) &&
          (!((prev_live >> l) & 1u) || k[l].x != p0 || k[l].y != p1))
        a = i0 + l;
      if ((prev_vis >> l) & 1u) w = i0 + l - 1;
      la[l] = a;
      lw[l] = w;
      p0 = k[l].x;
      p1 = k[l].y;
    }

    // Warp max-scan of the strip totals, then the warps before this one
    // and the previous chunks.
    int sa = a, sw = w;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int ta = __shfl_up_sync(kAll, sa, off);
      const int tw = __shfl_up_sync(kAll, sw, off);
      if (lane >= off) {
        sa = max(sa, ta);
        sw = max(sw, tw);
      }
    }
    int ea = __shfl_up_sync(kAll, sa, 1);
    int ew = __shfl_up_sync(kAll, sw, 1);
    if (lane == 0) ea = ew = -1;
    if (lane == 31) {
      warp_a[warp] = sa;
      warp_w[warp] = sw;
    }
    __syncthreads();
    int chunk_a = carry_a, chunk_w = carry_w;
#pragma unroll
    for (int v = 0; v < kWarps; ++v) {
      if (v == warp) {
        ea = max(ea, chunk_a);
        ew = max(ew, chunk_w);
      }
      chunk_a = max(chunk_a, warp_a[v]);
      chunk_w = max(chunk_w, warp_w[v]);
    }
    carry_a = chunk_a;
    carry_w = chunk_w;

    if (in) {
      unsigned long long s_out = 0, c_out = 0;
#pragma unroll
      for (int l = 0; l < kLanes; ++l) {
        // live and no visible lane precedes it in its run
        if (((live >> l) & 1u) && max(ew, lw[l]) < max(ea, la[l])) {
          const bool s = ((vis >> l) & 1u) && !((tb >> (8 * l)) & 0xffu);
          const bool c = x[l] != 0 && x[l] != reader && t[l] <= read_ts;
          s_out |= static_cast<unsigned long long>(s) << (8 * l);
          c_out |= static_cast<unsigned long long>(c) << (8 * l);
        }
      }
      if constexpr (kVec) {
        *reinterpret_cast<unsigned long long*>(sel + g) = s_out;
        *reinterpret_cast<unsigned long long*>(conf + g) = c_out;
      } else {
#pragma unroll
        for (int l = 0; l < kLanes; ++l) {
          sel[g + l] = static_cast<uint8_t>(s_out >> (8 * l));
          conf[g + l] = static_cast<uint8_t>(c_out >> (8 * l));
        }
      }
    }
  }
}

bool aligned(const void* p, uintptr_t n) {
  return reinterpret_cast<uintptr_t>(p) % n == 0;
}

}  // namespace

extern "C" int ct_scan_filter(const void* key, const void* ts,
                              const void* txn, const void* tomb,
                              const void* mask, long long read_ts,
                              long long reader, long long rows,
                              long long cw, void* sel, void* conf,
                              void* stream) {
  if (rows <= 0 || cw <= 0) return 0;
  if (cw % kLanes) return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = aligned(ts, 16) && aligned(txn, 16) && aligned(tomb, 8) &&
                   aligned(mask, 8) && aligned(sel, 8) && aligned(conf, 8);
  const auto kernel =
      vec ? &scan_filter_kernel<true> : &scan_filter_kernel<false>;
  kernel<<<static_cast<unsigned>(rows), kThreads, 0,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const ulonglong2*>(key), static_cast<const int64_t*>(ts),
      static_cast<const int64_t*>(txn), static_cast<const uint8_t*>(tomb),
      static_cast<const uint8_t*>(mask), read_ts, reader,
      static_cast<int>(cw), static_cast<uint8_t*>(sel),
      static_cast<uint8_t*>(conf));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* ct_scan_filter_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
