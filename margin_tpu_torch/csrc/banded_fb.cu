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
// exp(min(f + b - total, 0)) to a grid of the same layout. The arithmetic
// and its order follow the Pallas kernels; built with --fmad=false.
#include <cuda_runtime.h>
#include <stdint.h>

#include "logadd.cuh"

using namespace margin;

struct K2Args {
  const uint8_t* xs;      // flat symbols, problem b at x_off[b]
  const uint8_t* ys;
  const int* rep_x;       // flat run lengths (RLE only), same offsets
  const int* rep_y;
  const int64_t* x_off;
  const int64_t* y_off;
  const int* lxs;
  const int* lys;
  const int64_t* geo_off; // first diagonal row of problem b
  const int* xmy;         // per-diagonal storage base (smoothed track)
  const int* width;       // exclusive upper valid k
  const int* klo;         // first valid k
  const int* k_final;     // k of the corner (lx, ly) at d = lx+ly
  const float* tabs;      // (B, 35): match 25, gapX 5, gapY 5
  const float* trans;     // (B, 9)
  const float* init;      // (B, 3) start weights at diagonal 0, k = 0
  const float* end_w;     // (B, 3) end weights at (lx+ly, k_final)
  const float* rep_tab;   // (B, 4*51*51), RLE only
  float* fwd;             // (rows, 3, W)
  float* totals;          // (B,)
  float* post;            // (rows, 3, W)
};

struct Cell {
  int sx, sy, rx, ry;
};

// symbols (and run lengths) consumed by a cell; out-of-range positions
// read symbol 4 with run length 0, as the Pallas windows' fill does
template <bool RLE>
__device__ __forceinline__ Cell cell_symbols(const K2Args& a, int b, int ix,
                                             int iy, int lx, int ly) {
  Cell c;
  const bool inx = ix >= 0 && ix < lx;
  const bool iny = iy >= 0 && iy < ly;
  c.sx = inx ? a.xs[a.x_off[b] + ix] : 4;
  c.sy = iny ? a.ys[a.y_off[b] + iy] : 4;
  c.rx = (RLE && inx) ? a.rep_x[a.x_off[b] + ix] : 0;
  c.ry = (RLE && iny) ? a.rep_y[a.y_off[b] + iy] : 0;
  return c;
}

template <bool RLE>
__device__ __forceinline__ float match_emission(const K2Args& a, int b,
                                                const float* tabs,
                                                const Cell& c) {
  float e_m = tabs[c.sx * 5 + c.sy];
  if (RLE) {
    const int base = c.sx >= 4 ? 0 : c.sx;  // N -> A (repeatSubMatrix.c:16-27)
    e_m = e_m + a.rep_tab[(size_t)b * 4 * REP_N * REP_N +
                          base * REP_N * REP_N + c.rx * REP_N + c.ry];
  }
  return e_m;
}

__device__ __forceinline__ float ring_at(const float* diag, int W, int state,
                                         int k) {
  return (k >= 0 && k < W) ? diag[state * W + k] : LOG_ZERO_F;
}

template <bool LUT, bool RLE>
__global__ void k2_fwd_kernel(K2Args a, int W) {
  extern __shared__ float ring[];  // 3 diagonals x 3 states x W
  __shared__ float tabs[35], tr[9];
  const int b = blockIdx.x;
  const int k = threadIdx.x;
  for (int i = k; i < 35; i += blockDim.x) tabs[i] = a.tabs[b * 35 + i];
  for (int i = k; i < 9; i += blockDim.x) tr[i] = a.trans[b * 9 + i];
  const int lx = a.lxs[b], ly = a.lys[b];
  const int D = lx + ly;
  const int64_t g0 = a.geo_off[b];
  const int* xmy = a.xmy + g0;
  const int* width = a.width + g0;
  const int* klo = a.klo + g0;
  float* out = a.fwd + g0 * 3 * W;
  // diagonal 0 carries the start weights at k = 0 (stateMachine.c:521-530)
  for (int s = 0; s < 3; ++s) {
    const float v = (k == 0) ? a.init[b * 3 + s] : LOG_ZERO_F;
    ring[s * W + k] = v;
    ring[2 * 3 * W + s * W + k] = LOG_ZERO_F;  // diagonal -1
    out[s * W + k] = v;
  }
  __syncthreads();
  for (int g = 1; g <= D; ++g) {
    float* cur = ring + (g % 3) * 3 * W;
    const float* p1 = ring + ((g + 2) % 3) * 3 * W;
    const float* p2 = ring + ((g + 1) % 3) * 3 * W;
    const int xm = xmy[g];
    const int s1 = (xm - 1 - xmy[g - 1]) >> 1;
    const int s2 = g >= 2 ? (xm - xmy[g - 2]) >> 1 : 0;
    const int xb = ((g + xm) >> 1) - 1;
    const int yb = ((g - xm) >> 1) - 1;
    const int x_pos = xb + 1 + k, y_pos = yb + 1 - k;
    const bool vm = k >= klo[g] && k < width[g] && x_pos >= 0 &&
                    x_pos <= lx && y_pos >= 0 && y_pos <= ly;
    float nm = LOG_ZERO_F, ngx = LOG_ZERO_F, ngy = LOG_ZERO_F;
    if (vm) {
      const Cell c = cell_symbols<RLE>(a, b, xb + k, yb - k, lx, ly);
      const float e_m = match_emission<RLE>(a, b, tabs, c);
      const float e_gx = tabs[25 + c.sx];
      const float e_gy = tabs[30 + c.sy];
      // low = (x-1, y), up = (x, y-1) on diagonal g-1; mid = (x-1, y-1)
      // on diagonal g-2
      const int kl = k + s1, ku = k + s1 + 1, km = k + s2;
      ngx = e_gx + log_add3<LUT>(ring_at(p1, W, 0, kl) + tr[T_OPEN_X],
                                 ring_at(p1, W, 1, kl) + tr[T_EXT_X],
                                 ring_at(p1, W, 2, kl) + tr[T_SW_X]);
      nm = e_m + log_add3<LUT>(ring_at(p2, W, 0, km) + tr[T_MM],
                               ring_at(p2, W, 1, km) + tr[T_M_FROM_GX],
                               ring_at(p2, W, 2, km) + tr[T_M_FROM_GY]);
      ngy = e_gy + log_add3<LUT>(ring_at(p1, W, 0, ku) + tr[T_OPEN_Y],
                                 ring_at(p1, W, 2, ku) + tr[T_EXT_Y],
                                 ring_at(p1, W, 1, ku) + tr[T_SW_Y]);
      nm = fmaxf(nm, LOG_ZERO_F);
      ngx = fmaxf(ngx, LOG_ZERO_F);
      ngy = fmaxf(ngy, LOG_ZERO_F);
    }
    cur[k] = nm;
    cur[W + k] = ngx;
    cur[2 * W + k] = ngy;
    float* row = out + (size_t)g * 3 * W;
    row[k] = nm;
    row[W + k] = ngx;
    row[2 * W + k] = ngy;
    __syncthreads();
  }
  // total log prob at the final corner with the end weights
  // (pallas_banded.py:401-411)
  if (k == a.k_final[b]) {
    const float* f = ring + (D % 3) * 3 * W;
    const float* e = a.end_w + b * 3;
    a.totals[b] = log_add<LUT>(log_add<LUT>(f[k] + e[0], f[W + k] + e[1]),
                               f[2 * W + k] + e[2]);
  }
}

template <bool LUT, bool RLE>
__global__ void k2_bwd_kernel(K2Args a, int W) {
  extern __shared__ float ring[];
  __shared__ float tabs[35], tr[9];
  const int b = blockIdx.x;
  const int k = threadIdx.x;
  for (int i = k; i < 35; i += blockDim.x) tabs[i] = a.tabs[b * 35 + i];
  for (int i = k; i < 9; i += blockDim.x) tr[i] = a.trans[b * 9 + i];
  const int lx = a.lxs[b], ly = a.lys[b];
  const int D = lx + ly;
  const int64_t g0 = a.geo_off[b];
  const int* xmy = a.xmy + g0;
  const int* width = a.width + g0;
  const int* klo = a.klo + g0;
  const float* fwd = a.fwd + g0 * 3 * W;
  float* post = a.post + g0 * 3 * W;
  const float total = a.totals[b];
  const int kf = a.k_final[b];
  // diagonals D+1 and D+2 are empty
  for (int s = 0; s < 3; ++s) {
    ring[((D + 1) % 3) * 3 * W + s * W + k] = LOG_ZERO_F;
    ring[((D + 2) % 3) * 3 * W + s * W + k] = LOG_ZERO_F;
  }
  __syncthreads();
  for (int g = D; g >= 0; --g) {
    float* cur = ring + (g % 3) * 3 * W;
    const float* n1 = ring + ((g + 1) % 3) * 3 * W;
    const float* n2 = ring + ((g + 2) % 3) * 3 * W;
    const int xm = xmy[g];
    const int xb = ((g + xm) >> 1) - 1;
    const int yb = ((g - xm) >> 1) - 1;
    const int x_pos = xb + 1 + k, y_pos = yb + 1 - k;
    const bool vm = k >= klo[g] && k < width[g] && x_pos >= 0 &&
                    x_pos <= lx && y_pos >= 0 && y_pos <= ly;
    float bm = LOG_ZERO_F, bgx = LOG_ZERO_F, bgy = LOG_ZERO_F;
    if (g == D) {
      // the final diagonal carries the end weights at k_final
      // (pairwiseAligner.c:882-892)
      if (k == kf) {
        bm = a.end_w[b * 3 + 0];
        bgx = a.end_w[b * 3 + 1];
        bgy = a.end_w[b * 3 + 2];
      }
    } else if (vm) {
      const int t1 = (xm + 1 - xmy[g + 1]) >> 1;
      const int t2 = g + 2 <= D ? (xm - xmy[g + 2]) >> 1 : 0;
      const float gx_n = ring_at(n1, W, 1, k + t1);      // (x+1, y)
      const float gy_n = ring_at(n1, W, 2, k + t1 - 1);  // (x, y+1)
      const float m_n = ring_at(n2, W, 0, k + t2);       // (x+1, y+1)
      const Cell c = cell_symbols<RLE>(a, b, xb + k + 1, yb + 1 - k, lx, ly);
      const float e_m = match_emission<RLE>(a, b, tabs, c);
      const float e_gx = tabs[25 + c.sx];
      const float e_gy = tabs[30 + c.sy];
      bm = log_add3<LUT>(gx_n + e_gx + tr[T_OPEN_X], m_n + e_m + tr[T_MM],
                         gy_n + e_gy + tr[T_OPEN_Y]);
      bgx = log_add3<LUT>(gx_n + e_gx + tr[T_EXT_X],
                          m_n + e_m + tr[T_M_FROM_GX],
                          gy_n + e_gy + tr[T_SW_Y]);
      bgy = log_add3<LUT>(gx_n + e_gx + tr[T_SW_X],
                          m_n + e_m + tr[T_M_FROM_GY],
                          gy_n + e_gy + tr[T_EXT_Y]);
      bm = fmaxf(bm, LOG_ZERO_F);
      bgx = fmaxf(bgx, LOG_ZERO_F);
      bgy = fmaxf(bgy, LOG_ZERO_F);
    }
    cur[k] = bm;
    cur[W + k] = bgx;
    cur[2 * W + k] = bgy;
    const float* f = fwd + (size_t)g * 3 * W;
    float* p = post + (size_t)g * 3 * W;
    p[k] = vm ? expf(fminf(f[k] + bm - total, 0.0f)) : 0.0f;
    p[W + k] = vm ? expf(fminf(f[W + k] + bgx - total, 0.0f)) : 0.0f;
    p[2 * W + k] = vm ? expf(fminf(f[2 * W + k] + bgy - total, 0.0f)) : 0.0f;
    __syncthreads();
  }
}

typedef void (*K2Kernel)(K2Args, int);

static int launch(K2Kernel kern, const K2Args& a, int B, int W,
                  void* stream) {
  if (B == 0) return 0;
  const size_t smem = (size_t)9 * W * sizeof(float);
  kern<<<B, W, smem, (cudaStream_t)stream>>>(a, W);
  return (int)cudaGetLastError();
}

static K2Args make_args(void** p) {
  K2Args a;
  a.xs = (const uint8_t*)p[0];
  a.ys = (const uint8_t*)p[1];
  a.rep_x = (const int*)p[2];
  a.rep_y = (const int*)p[3];
  a.x_off = (const int64_t*)p[4];
  a.y_off = (const int64_t*)p[5];
  a.lxs = (const int*)p[6];
  a.lys = (const int*)p[7];
  a.geo_off = (const int64_t*)p[8];
  a.xmy = (const int*)p[9];
  a.width = (const int*)p[10];
  a.klo = (const int*)p[11];
  a.k_final = (const int*)p[12];
  a.tabs = (const float*)p[13];
  a.trans = (const float*)p[14];
  a.init = (const float*)p[15];
  a.end_w = (const float*)p[16];
  a.rep_tab = (const float*)p[17];
  a.fwd = (float*)p[18];
  a.totals = (float*)p[19];
  a.post = (float*)p[20];
  return a;
}

// ptrs: the 21 K2Args pointers in field order (rep_* and post may be null)
extern "C" int k2_forward(void** ptrs, int B, int W, int use_lut,
                          void* stream) {
  const K2Args a = make_args(ptrs);
  const bool rle = a.rep_x != nullptr;
  K2Kernel kern = use_lut ? (rle ? &k2_fwd_kernel<true, true>
                                 : &k2_fwd_kernel<true, false>)
                          : (rle ? &k2_fwd_kernel<false, true>
                                 : &k2_fwd_kernel<false, false>);
  return launch(kern, a, B, W, stream);
}

extern "C" int k2_backward(void** ptrs, int B, int W, int use_lut,
                           void* stream) {
  const K2Args a = make_args(ptrs);
  const bool rle = a.rep_x != nullptr;
  K2Kernel kern = use_lut ? (rle ? &k2_bwd_kernel<true, true>
                                 : &k2_bwd_kernel<true, false>)
                          : (rle ? &k2_bwd_kernel<false, true>
                                 : &k2_bwd_kernel<false, false>);
  return launch(kern, a, B, W, stream);
}
