// Kernels K3-fwd and K3-bwd: the segmented (checkpointed) banded 3-state
// pair-HMM forward-backward over a pack of problems, with the posterior
// cells above a threshold compacted into extraction words on the device.
//
// Replaces: margin_tpu/ops/pallas_banded.py:_fwd_seg_kernel (:873, via
// _seg_fwd_call :1151, driven by _fb_seg_forward :1186 and, with its
// forward block stored, by _fb_seg_backward :1238) with the totals of
// _seg_totals (:1228), and _bwd_seg_kernel (:964, pallas_call :1294) with
// the streaming flat extraction of _fb_seg_backward (:1305-1332).
//
// Why: the monolithic K2 stores the (D, 3, W) forward grid and writes a
// posterior grid of the same size, 2 * 12 * W bytes per diagonal. A
// 100 kb polish read (D ~ 1.5e5 diagonals of run-length symbols) at
// W = 32 needs ~115 MB for one problem and ~15 GB for a pack of 128.
// These kernels keep O(S) memory per problem at any depth.
//
// What bounds them on this card: as K2, operations and latency along each
// problem's serial walk over anti-diagonals; the design pays a second
// forward sweep (the recompute) to drop the grids. The bytes that must
// move are the inputs and the extraction words.
//
// Design (one thread block per problem, W threads over the band offset k,
// the three-deep diagonal ring of K2 in shared memory, the per-cell
// arithmetic of banded_cell.cuh shared with K2, so every cell equals K2's
// bit for bit):
//   * K3-fwd walks diagonals 0..lx+ly and, at the start of every segment
//     of S diagonals, writes the ring's two previous diagonals (d0-1,
//     d0-2) to the checkpoint buffer (segments of problem b from
//     seg_off[b], each (2, 3, W)); then the total at the final corner.
//   * K3-bwd loops over the problem's segments from last to first: it
//     recomputes the segment's forward from its checkpoint into a
//     per-problem scratch block (S, 3, W) in device memory, then runs the
//     backward through the segment with its own ring (carried across
//     segments), computes each posterior exp(min(f + b - total, 0)) and
//     appends each cell with posterior >= threshold that passes the
//     x > 0 / y > 0 checks of extract_packed as two int32 words
//     lo = floor(min(p,1)*1e7) | k << 24, hi = d | (3b+s) << 22 at an
//     atomicAdd on one global count (one atomic per warp and diagonal).
//     Words beyond the capacity are dropped and counted; the host re-runs
//     only K3-bwd with the exact count. Word order is free: the host sorts
//     by (tag, x, y).
// Built with --fmad=false.
#include "banded_cell.cuh"

using namespace margin;

template <bool LUT, bool RLE>
__global__ void k3_fwd_kernel(BandArgs a, const int64_t* seg_off,
                              float* ckpt, float* totals, int W, int S) {
  extern __shared__ float ring[];  // 3 diagonals x 3 states x W
  __shared__ float tabs[35], tr[9];
  const int b = blockIdx.x;
  const int k = threadIdx.x;
  load_tables(a, b, tabs, tr);
  const Problem p = problem(a, b);
  float* ck = ckpt + seg_off[b] * 6 * W;
  for (int s = 0; s < 3; ++s) {
    ring[s * W + k] = init_cell(a, b, s, k);
    ring[2 * 3 * W + s * W + k] = LOG_ZERO_F;  // diagonal -1
    ck[s * W + k] = LOG_ZERO_F;                // segment 0: nothing before
    ck[3 * W + s * W + k] = LOG_ZERO_F;
  }
  __syncthreads();
  for (int g = 1; g <= p.D; ++g) {
    const float* p1 = ring + ((g + 2) % 3) * 3 * W;
    const float* p2 = ring + ((g + 1) % 3) * 3 * W;
    if (g % S == 0) {  // the carry into segment g / S
      float* c = ck + (size_t)(g / S) * 6 * W;
      for (int s = 0; s < 3; ++s) {
        c[s * W + k] = p1[s * W + k];
        c[3 * W + s * W + k] = p2[s * W + k];
      }
    }
    float c[3];
    forward_cell<LUT, RLE>(a, p, tabs, tr, g, k, W, p1, p2, c);
    float* cur = ring + (g % 3) * 3 * W;
    for (int s = 0; s < 3; ++s) cur[s * W + k] = c[s];
    __syncthreads();
  }
  if (k == a.k_final[b])
    totals[b] = corner_total<LUT>(a, b, ring + (p.D % 3) * 3 * W, W, k);
}

// Append this thread's selected cells (up to one per state) as extraction
// words: one atomicAdd per warp, each lane at its prefix in the warp.
__device__ __forceinline__ void emit_words(const bool sel[3],
                                           const int lo[3], const int hi[3],
                                           int W, int* count, int* lo_buf,
                                           int* hi_buf, int cap) {
  const int lane = threadIdx.x & 31;
  const unsigned member = W >= 32 ? 0xffffffffu : ((1u << W) - 1u);
  unsigned m[3];
  int n = 0;
  for (int s = 0; s < 3; ++s) {
    m[s] = __ballot_sync(member, sel[s]);
    n += __popc(m[s]);
  }
  if (n == 0) return;  // uniform across the warp
  int base = 0;
  if (lane == 0) base = atomicAdd(count, n);
  base = __shfl_sync(member, base, 0);
  const unsigned below = (1u << lane) - 1u;
  for (int s = 0; s < 3; ++s) {
    if (sel[s]) {
      const int idx = base + __popc(m[s] & below);
      if (idx < cap) {
        lo_buf[idx] = lo[s];
        hi_buf[idx] = hi[s];
      }
    }
    base += __popc(m[s]);
  }
}

template <bool LUT, bool RLE>
__global__ void k3_bwd_kernel(BandArgs a, const int64_t* seg_off,
                              const float* ckpt, const float* totals,
                              float* scratch, float threshold, int* count,
                              int* lo_buf, int* hi_buf, int cap, int W,
                              int S) {
  extern __shared__ float rings[];  // forward ring, then backward ring
  float* fring = rings;
  float* bring = rings + 9 * W;
  __shared__ float tabs[35], tr[9];
  const int b = blockIdx.x;
  const int k = threadIdx.x;
  load_tables(a, b, tabs, tr);
  const Problem p = problem(a, b);
  const float* ck = ckpt + seg_off[b] * 6 * W;
  float* blk = scratch + (size_t)b * S * 3 * W;
  const float total = totals[b];
  // diagonals D+1 and D+2 are empty
  for (int s = 0; s < 3; ++s) {
    bring[((p.D + 1) % 3) * 3 * W + s * W + k] = LOG_ZERO_F;
    bring[((p.D + 2) % 3) * 3 * W + s * W + k] = LOG_ZERO_F;
  }
  for (int seg = p.D / S; seg >= 0; --seg) {
    const int d0 = seg * S;
    const int d1 = min(d0 + S, p.D + 1);
    // recompute the segment's forward from its checkpoint
    int g = d0;
    if (seg == 0) {
      for (int s = 0; s < 3; ++s) {
        const float v = init_cell(a, b, s, k);
        fring[s * W + k] = v;
        fring[2 * 3 * W + s * W + k] = LOG_ZERO_F;
        blk[s * W + k] = v;
      }
      g = 1;
    } else {
      const float* c = ck + (size_t)seg * 6 * W;
      for (int s = 0; s < 3; ++s) {
        fring[((d0 - 1) % 3) * 3 * W + s * W + k] = c[s * W + k];
        fring[((d0 - 2) % 3) * 3 * W + s * W + k] = c[3 * W + s * W + k];
      }
    }
    __syncthreads();
    for (; g < d1; ++g) {
      float c[3];
      forward_cell<LUT, RLE>(a, p, tabs, tr, g, k, W,
                             fring + ((g + 2) % 3) * 3 * W,
                             fring + ((g + 1) % 3) * 3 * W, c);
      float* cur = fring + (g % 3) * 3 * W;
      float* row = blk + (size_t)(g - d0) * 3 * W;
      for (int s = 0; s < 3; ++s) {
        cur[s * W + k] = c[s];
        row[s * W + k] = c[s];
      }
      __syncthreads();
    }
    // backward + posterior + extraction through the segment
    for (g = d1 - 1; g >= d0; --g) {
      float c[3];
      backward_cell<LUT, RLE>(a, p, tabs, tr, g, k, W,
                              bring + ((g + 1) % 3) * 3 * W,
                              bring + ((g + 2) % 3) * 3 * W, c);
      const bool vm = in_band(p, g, k);
      const float* f = blk + (size_t)(g - d0) * 3 * W;
      const bool x_ok = x_base(p, g) + 1 + k > 0;
      const bool y_ok = y_base(p, g) + 1 - k > 0;
      const bool need[3] = {x_ok && y_ok, x_ok, y_ok};
      float* cur = bring + (g % 3) * 3 * W;
      bool sel[3];
      int lo[3], hi[3];
      for (int s = 0; s < 3; ++s) {
        cur[s * W + k] = c[s];
        const float q = posterior(vm, f[s * W + k], c[s], total);
        sel[s] = q >= threshold && need[s];
        lo[s] = (int)floorf(fminf(q, 1.0f) * 10000000.0f) | (k << 24);
        hi[s] = g | ((3 * b + s) << 22);
      }
      emit_words(sel, lo, hi, W, count, lo_buf, hi_buf, cap);
      __syncthreads();
    }
  }
}

template <bool LUT, bool RLE>
static int launch_fwd(const BandArgs& a, const int64_t* seg_off, float* ckpt,
                      float* totals, int B, int W, int S, cudaStream_t st) {
  k3_fwd_kernel<LUT, RLE><<<B, W, 9 * W * sizeof(float), st>>>(
      a, seg_off, ckpt, totals, W, S);
  return (int)cudaGetLastError();
}

template <bool LUT, bool RLE>
static int launch_bwd(const BandArgs& a, void** q, float threshold, int cap,
                      int B, int W, int S, cudaStream_t st) {
  k3_bwd_kernel<LUT, RLE><<<B, W, 18 * W * sizeof(float), st>>>(
      a, (const int64_t*)q[0], (const float*)q[1], (const float*)q[2],
      (float*)q[3], threshold, (int*)q[4], (int*)q[5], (int*)q[6], cap, W,
      S);
  return (int)cudaGetLastError();
}

// ptrs: the 18 BandArgs pointers in field order (rep_* may be null), then
// seg_off, ckpt, totals
extern "C" int k3_forward(void** ptrs, int B, int W, int S, int use_lut,
                          void* stream) {
  if (B == 0) return 0;
  const BandArgs a = band_args(ptrs);
  const int64_t* seg_off = (const int64_t*)ptrs[BAND_ARGS_N];
  float* ckpt = (float*)ptrs[BAND_ARGS_N + 1];
  float* totals = (float*)ptrs[BAND_ARGS_N + 2];
  cudaStream_t st = (cudaStream_t)stream;
  const bool rle = a.rep_x != nullptr;
  if (use_lut)
    return rle ? launch_fwd<true, true>(a, seg_off, ckpt, totals, B, W, S, st)
               : launch_fwd<true, false>(a, seg_off, ckpt, totals, B, W, S,
                                         st);
  return rle ? launch_fwd<false, true>(a, seg_off, ckpt, totals, B, W, S, st)
             : launch_fwd<false, false>(a, seg_off, ckpt, totals, B, W, S,
                                        st);
}

// ptrs: the 18 BandArgs pointers, then seg_off, ckpt, totals, scratch,
// count, lo, hi
extern "C" int k3_backward(void** ptrs, int B, int W, int S, int use_lut,
                           float threshold, int cap, void* stream) {
  if (B == 0) return 0;
  const BandArgs a = band_args(ptrs);
  void** q = ptrs + BAND_ARGS_N;
  cudaStream_t st = (cudaStream_t)stream;
  const bool rle = a.rep_x != nullptr;
  if (use_lut)
    return rle ? launch_bwd<true, true>(a, q, threshold, cap, B, W, S, st)
               : launch_bwd<true, false>(a, q, threshold, cap, B, W, S, st);
  return rle ? launch_bwd<false, true>(a, q, threshold, cap, B, W, S, st)
             : launch_bwd<false, false>(a, q, threshold, cap, B, W, S, st);
}
