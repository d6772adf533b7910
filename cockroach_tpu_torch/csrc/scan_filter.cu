// MVCC window scan filter for Hopper (sm_90a).
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
// becomes two plain max-scans, and thread i reads lane i-1 itself to
// form W's contribution.
//
// Layout: one block per window row. The block walks its row in chunks of
// kThreads lanes and carries (A, W) from one chunk to the next, so a row
// may be any length (window growth reaches S * 2^20 lanes); nothing
// assumes that a row fits in one block or in shared memory.
//
// Bound on this card: bytes. Each lane reads 16 key + 8 ts + 8 txn +
// 1 tomb + 1 mask bytes and writes 2 (36 B/lane); at the YCSB shape
// (128 x 640 lanes, 2.9 MB) that is under a microsecond of HBM traffic,
// so the kernel is launch-bound there. The lane i-1 re-reads hit L1/L2.
// Keys are read as two 8-byte words; equality needs no byte swap.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ bool visible_at(const int64_t* ts,
                                           const int64_t* txn,
                                           const uint8_t* mask, int64_t j,
                                           int64_t read_ts, int64_t reader) {
  if (!mask[j]) return false;
  const int64_t x = txn[j];
  return x == 0 ? ts[j] <= read_ts : x == reader;
}

// Inclusive block-wide max-scan of the pair (a, b); every thread of the
// block must call it.
__device__ __forceinline__ void block_max_scan2(int& a, int& b, int* sa,
                                                int* sb) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int ta = __shfl_up_sync(0xffffffffu, a, off);
    const int tb = __shfl_up_sync(0xffffffffu, b, off);
    if (lane >= off) {
      a = max(a, ta);
      b = max(b, tb);
    }
  }
  if (lane == 31) {
    sa[warp] = a;
    sb[warp] = b;
  }
  __syncthreads();
  if (warp == 0) {
    int va = lane < kWarps ? sa[lane] : -1;
    int vb = lane < kWarps ? sb[lane] : -1;
#pragma unroll
    for (int off = 1; off < kWarps; off <<= 1) {
      const int ta = __shfl_up_sync(0xffffffffu, va, off);
      const int tb = __shfl_up_sync(0xffffffffu, vb, off);
      if (lane >= off) {
        va = max(va, ta);
        vb = max(vb, tb);
      }
    }
    if (lane < kWarps) {
      sa[lane] = va;
      sb[lane] = vb;
    }
  }
  __syncthreads();
  if (warp > 0) {
    a = max(a, sa[warp - 1]);
    b = max(b, sb[warp - 1]);
  }
}

__global__ void __launch_bounds__(kThreads)
    scan_filter_kernel(const ulonglong2* __restrict__ key,
                       const int64_t* __restrict__ ts,
                       const int64_t* __restrict__ txn,
                       const uint8_t* __restrict__ tomb,
                       const uint8_t* __restrict__ mask, int64_t read_ts,
                       int64_t reader, int cw, uint8_t* __restrict__ sel,
                       uint8_t* __restrict__ conf) {
  __shared__ int sa[kWarps];
  __shared__ int sb[kWarps];
  __shared__ int carry[2];
  const int64_t base = static_cast<int64_t>(blockIdx.x) * cw;
  int carry_a = -1;  // last run start so far in this row
  int carry_w = -1;  // last visible lane so far in this row
  for (int c0 = 0; c0 < cw; c0 += kThreads) {
    const int i = c0 + static_cast<int>(threadIdx.x);
    const bool in = i < cw;
    const int64_t g = base + i;
    bool live = false, vis = false, prev_vis = false, boundary = false;
    if (in) {
      live = mask[g] != 0;
      if (live) {
        vis = visible_at(ts, txn, mask, g, read_ts, reader);
        if (i == 0) {
          boundary = true;
        } else {
          const ulonglong2 k = key[g];
          const ulonglong2 kp = key[g - 1];
          boundary = !mask[g - 1] || k.x != kp.x || k.y != kp.y;
          prev_vis = visible_at(ts, txn, mask, g - 1, read_ts, reader);
        }
      }
    }
    int a = (live && boundary) ? i : -1;
    int w = prev_vis ? i - 1 : -1;
    block_max_scan2(a, w, sa, sb);
    a = max(a, carry_a);
    w = max(w, carry_w);
    if (in) {
      const bool seen = w >= a;  // a visible lane precedes i in its run
      uint8_t s = 0, c = 0;
      if (live && !seen) {
        const int64_t x = txn[g];
        s = (vis && !tomb[g]) ? 1 : 0;
        c = (x != 0 && x != reader && ts[g] <= read_ts) ? 1 : 0;
      }
      sel[g] = s;
      conf[g] = c;
    }
    if (threadIdx.x == kThreads - 1) {
      carry[0] = a;
      carry[1] = w;
    }
    __syncthreads();
    carry_a = carry[0];
    carry_w = carry[1];
    __syncthreads();
  }
}

}  // namespace

extern "C" int ct_scan_filter(const void* key, const void* ts,
                              const void* txn, const void* tomb,
                              const void* mask, long long read_ts,
                              long long reader, long long rows,
                              long long cw, void* sel, void* conf,
                              void* stream) {
  if (rows <= 0 || cw <= 0) return 0;
  scan_filter_kernel<<<static_cast<unsigned>(rows), kThreads, 0,
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
