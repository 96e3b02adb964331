// Kernels K2-fwd and K2-bwd: banded 3-state pair-HMM forward, then
// backward + posterior, over a pack of problems.
//
// Replaces: margin_tpu/ops/pallas_banded.py:_fwd_kernel (:174) and
// _bwd_kernel (:253), launched by _fb_pallas (:390, :426), plus the total
// at (lx+ly, k_final) with the end weights (:401-411).
//
// What bounds them on this card: operations and latency, not bytes. Each
// band cell costs three 3-way logAdds (forward) and three more plus one
// exp (backward); the bytes are the two (D, 3, W) float grids, written
// once by the forward and read back once by the backward. Along one
// problem the recurrence is serial over anti-diagonals, so a problem's
// parallelism is its band width W <= 128.
//
// Design: the TPU put the problems on the 128 lanes and walked diagonals
// on a sequential grid. Here each problem gets its own thread block, with
// W threads over the band storage offset k, and a loop inside the block
// over that problem's own diagonals 0..lx+ly (a pack needs no padding to a
// common depth). The band storage base xmy moves by exactly +-1 per
// diagonal (the smoothed track of BandGeometry.build(smooth=True)), so
// each dependency is a neighbour k-1, k or k+1 on one of the two previous
// diagonals, read from a three-deep ring in shared memory with one
// __syncthreads() per diagonal. The meta rows S1, S2, T1, T2, the x/y
// bases and the validity interval [k_lo, width) are derived in the kernel
// from the per-diagonal xmy track with the formulas of _derive_geom
// (:556-575). Emissions are read from the problem's symbols and its
// 35-entry table as _kernel_emissions (:142-167) builds them, with the RLE
// addend repeat[slot(base), rep_x, rep_y] of the cell. The forward stores
// every diagonal's (3, W) cells to a problem-major grid (row
// geo_off[b] + d); the backward reads it and writes the posterior
// exp(min(f + b - total, 0)) to a grid of the same layout. The per-cell
// arithmetic lives in banded_cell.cuh, shared with the segmented kernels
// K3 (banded_seg.cu); built with --fmad=false.
#include "banded_cell.cuh"

using namespace margin;

template <bool LUT, bool RLE>
__global__ void k2_fwd_kernel(BandArgs a, float* fwd, float* totals, int W) {
  extern __shared__ float ring[];  // 3 diagonals x 3 states x W
  __shared__ float tabs[35], tr[9];
  const int b = blockIdx.x;
  const int k = threadIdx.x;
  load_tables(a, b, tabs, tr);
  const Problem p = problem(a, b);
  float* out = fwd + a.geo_off[b] * 3 * W;
  for (int s = 0; s < 3; ++s) {
    const float v = init_cell(a, b, s, k);
    ring[s * W + k] = v;
    ring[2 * 3 * W + s * W + k] = LOG_ZERO_F;  // diagonal -1
    out[s * W + k] = v;
  }
  __syncthreads();
  for (int g = 1; g <= p.D; ++g) {
    float* cur = ring + (g % 3) * 3 * W;
    float c[3];
    forward_cell<LUT, RLE>(a, p, tabs, tr, g, k, W,
                           ring + ((g + 2) % 3) * 3 * W,
                           ring + ((g + 1) % 3) * 3 * W, c);
    float* row = out + (size_t)g * 3 * W;
    for (int s = 0; s < 3; ++s) {
      cur[s * W + k] = c[s];
      row[s * W + k] = c[s];
    }
    __syncthreads();
  }
  if (k == a.k_final[b])
    totals[b] = corner_total<LUT>(a, b, ring + (p.D % 3) * 3 * W, W, k);
}

template <bool LUT, bool RLE>
__global__ void k2_bwd_kernel(BandArgs a, const float* fwd_all,
                              const float* totals, float* post_all, int W) {
  extern __shared__ float ring[];
  __shared__ float tabs[35], tr[9];
  const int b = blockIdx.x;
  const int k = threadIdx.x;
  load_tables(a, b, tabs, tr);
  const Problem p = problem(a, b);
  const float* fwd = fwd_all + a.geo_off[b] * 3 * W;
  float* post = post_all + a.geo_off[b] * 3 * W;
  const float total = totals[b];
  // diagonals D+1 and D+2 are empty
  for (int s = 0; s < 3; ++s) {
    ring[((p.D + 1) % 3) * 3 * W + s * W + k] = LOG_ZERO_F;
    ring[((p.D + 2) % 3) * 3 * W + s * W + k] = LOG_ZERO_F;
  }
  __syncthreads();
  for (int g = p.D; g >= 0; --g) {
    float* cur = ring + (g % 3) * 3 * W;
    float c[3];
    backward_cell<LUT, RLE>(a, p, tabs, tr, g, k, W,
                            ring + ((g + 1) % 3) * 3 * W,
                            ring + ((g + 2) % 3) * 3 * W, c);
    const bool vm = in_band(p, g, k);
    const float* f = fwd + (size_t)g * 3 * W;
    float* q = post + (size_t)g * 3 * W;
    for (int s = 0; s < 3; ++s) {
      cur[s * W + k] = c[s];
      q[s * W + k] = posterior(vm, f[s * W + k], c[s], total);
    }
    __syncthreads();
  }
}

template <bool LUT, bool RLE>
static int launch_fwd(const BandArgs& a, float* fwd, float* totals, int B,
                      int W, cudaStream_t st) {
  k2_fwd_kernel<LUT, RLE><<<B, W, 9 * W * sizeof(float), st>>>(a, fwd,
                                                               totals, W);
  return (int)cudaGetLastError();
}

template <bool LUT, bool RLE>
static int launch_bwd(const BandArgs& a, const float* fwd,
                      const float* totals, float* post, int B, int W,
                      cudaStream_t st) {
  k2_bwd_kernel<LUT, RLE><<<B, W, 9 * W * sizeof(float), st>>>(
      a, fwd, totals, post, W);
  return (int)cudaGetLastError();
}

// ptrs: the 18 BandArgs pointers in field order (rep_* may be null), then
// fwd, totals, post (post may be null for the forward)
extern "C" int k2_forward(void** ptrs, int B, int W, int use_lut,
                          void* stream) {
  if (B == 0) return 0;
  const BandArgs a = band_args(ptrs);
  float* fwd = (float*)ptrs[BAND_ARGS_N];
  float* totals = (float*)ptrs[BAND_ARGS_N + 1];
  cudaStream_t st = (cudaStream_t)stream;
  const bool rle = a.rep_x != nullptr;
  if (use_lut)
    return rle ? launch_fwd<true, true>(a, fwd, totals, B, W, st)
               : launch_fwd<true, false>(a, fwd, totals, B, W, st);
  return rle ? launch_fwd<false, true>(a, fwd, totals, B, W, st)
             : launch_fwd<false, false>(a, fwd, totals, B, W, st);
}

extern "C" int k2_backward(void** ptrs, int B, int W, int use_lut,
                           void* stream) {
  if (B == 0) return 0;
  const BandArgs a = band_args(ptrs);
  const float* fwd = (const float*)ptrs[BAND_ARGS_N];
  const float* totals = (const float*)ptrs[BAND_ARGS_N + 1];
  float* post = (float*)ptrs[BAND_ARGS_N + 2];
  cudaStream_t st = (cudaStream_t)stream;
  const bool rle = a.rep_x != nullptr;
  if (use_lut)
    return rle ? launch_bwd<true, true>(a, fwd, totals, post, B, W, st)
               : launch_bwd<true, false>(a, fwd, totals, post, B, W, st);
  return rle ? launch_bwd<false, true>(a, fwd, totals, post, B, W, st)
             : launch_bwd<false, false>(a, fwd, totals, post, B, W, st);
}
