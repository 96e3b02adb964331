// Per-cell arithmetic of the banded pair-HMM forward-backward, shared by
// the monolithic kernels K2 (banded_fb.cu) and the segmented kernels K3
// (banded_seg.cu), so both run one copy of it and their cells agree bit
// for bit.
//
// Layout of a pack (ops/cuda_banded.py:BandPack): problem b's diagonal d
// is row geo_off[b] + d of the flat per-diagonal arrays (xmy, width, klo);
// a diagonal holds (3, W) cells, state-major, k = band storage offset,
// cell k at x - y = xmy[d] + 2k. The storage base moves by exactly +-1 per
// diagonal, so every dependency is a neighbour k-1, k or k+1 on one of the
// two previous (forward) or next (backward) diagonals, read from a
// three-deep ring of diagonals in shared memory (slot g % 3).
//
// The expressions and their order follow the Pallas kernels
// (margin_tpu/ops/pallas_banded.py:_fwd_kernel :206-247, _bwd_kernel
// :294-340); built with --fmad=false.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "logadd.cuh"

namespace margin {

struct BandArgs {
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
};

// the 18 BandArgs pointers in field order (rep_* may be null)
inline BandArgs band_args(void* const* p) {
  BandArgs a;
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
  return a;
}
constexpr int BAND_ARGS_N = 18;

// One problem's view, set up by every thread of its block.
struct Problem {
  int b, lx, ly, D;
  const int* xmy;
  const int* width;
  const int* klo;
};

__device__ __forceinline__ Problem problem(const BandArgs& a, int b) {
  Problem p;
  p.b = b;
  p.lx = a.lxs[b];
  p.ly = a.lys[b];
  p.D = p.lx + p.ly;
  const int64_t g0 = a.geo_off[b];
  p.xmy = a.xmy + g0;
  p.width = a.width + g0;
  p.klo = a.klo + g0;
  return p;
}

// the problem's 35 emission and 9 transition entries into shared memory
__device__ __forceinline__ void load_tables(const BandArgs& a, int b,
                                            float* tabs, float* tr) {
  for (int i = threadIdx.x; i < 35; i += blockDim.x)
    tabs[i] = a.tabs[b * 35 + i];
  for (int i = threadIdx.x; i < 9; i += blockDim.x)
    tr[i] = a.trans[b * 9 + i];
}

struct Cell {
  int sx, sy, rx, ry;
};

// symbols (and run lengths) consumed by a cell; out-of-range positions
// read symbol 4 with run length 0, as the Pallas windows' fill does
template <bool RLE>
__device__ __forceinline__ Cell cell_symbols(const BandArgs& a, int b, int ix,
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
__device__ __forceinline__ float match_emission(const BandArgs& a, int b,
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

// band storage bases of diagonal g: x of the character consumed at k = 0,
// minus one, and the same for y (_derive_geom, pallas_banded.py:556-558)
__device__ __forceinline__ int x_base(const Problem& p, int g) {
  return ((g + p.xmy[g]) >> 1) - 1;
}
__device__ __forceinline__ int y_base(const Problem& p, int g) {
  return ((g - p.xmy[g]) >> 1) - 1;
}

// whether cell k of diagonal g lies in the band and the DP rectangle
__device__ __forceinline__ bool in_band(const Problem& p, int g, int k) {
  const int x_pos = x_base(p, g) + 1 + k, y_pos = y_base(p, g) + 1 - k;
  return k >= p.klo[g] && k < p.width[g] && x_pos >= 0 && x_pos <= p.lx &&
         y_pos >= 0 && y_pos <= p.ly;
}

// The start diagonal 0 carries the start weights at k = 0
// (stateMachine.c:521-530).
__device__ __forceinline__ float init_cell(const BandArgs& a, int b, int s,
                                           int k) {
  return (k == 0) ? a.init[b * 3 + s] : LOG_ZERO_F;
}

// Forward cell k of diagonal g >= 1 from the ring's previous two diagonals
// p1 (g-1) and p2 (g-2): out = (match, gapX, gapY).
template <bool LUT, bool RLE>
__device__ __forceinline__ void forward_cell(const BandArgs& a,
                                             const Problem& p,
                                             const float* tabs,
                                             const float* tr, int g, int k,
                                             int W, const float* p1,
                                             const float* p2, float* out) {
  float nm = LOG_ZERO_F, ngx = LOG_ZERO_F, ngy = LOG_ZERO_F;
  if (in_band(p, g, k)) {
    const int xm = p.xmy[g];
    const int s1 = (xm - 1 - p.xmy[g - 1]) >> 1;
    const int s2 = g >= 2 ? (xm - p.xmy[g - 2]) >> 1 : 0;
    const int xb = x_base(p, g), yb = y_base(p, g);
    const Cell c = cell_symbols<RLE>(a, p.b, xb + k, yb - k, p.lx, p.ly);
    const float e_m = match_emission<RLE>(a, p.b, tabs, c);
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
  out[0] = nm;
  out[1] = ngx;
  out[2] = ngy;
}

// Backward cell k of diagonal g <= D from the ring's next two diagonals
// n1 (g+1) and n2 (g+2); the final diagonal carries the end weights at
// k_final (pairwiseAligner.c:882-892).
template <bool LUT, bool RLE>
__device__ __forceinline__ void backward_cell(const BandArgs& a,
                                              const Problem& p,
                                              const float* tabs,
                                              const float* tr, int g, int k,
                                              int W, const float* n1,
                                              const float* n2, float* out) {
  float bm = LOG_ZERO_F, bgx = LOG_ZERO_F, bgy = LOG_ZERO_F;
  if (g == p.D) {
    if (k == a.k_final[p.b]) {
      bm = a.end_w[p.b * 3 + 0];
      bgx = a.end_w[p.b * 3 + 1];
      bgy = a.end_w[p.b * 3 + 2];
    }
  } else if (in_band(p, g, k)) {
    const int xm = p.xmy[g];
    const int xb = x_base(p, g), yb = y_base(p, g);
    const int t1 = (xm + 1 - p.xmy[g + 1]) >> 1;
    const int t2 = g + 2 <= p.D ? (xm - p.xmy[g + 2]) >> 1 : 0;
    const float gx_n = ring_at(n1, W, 1, k + t1);      // (x+1, y)
    const float gy_n = ring_at(n1, W, 2, k + t1 - 1);  // (x, y+1)
    const float m_n = ring_at(n2, W, 0, k + t2);       // (x+1, y+1)
    const Cell c =
        cell_symbols<RLE>(a, p.b, xb + k + 1, yb + 1 - k, p.lx, p.ly);
    const float e_m = match_emission<RLE>(a, p.b, tabs, c);
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
  out[0] = bm;
  out[1] = bgx;
  out[2] = bgy;
}

// posterior exp(min(f + b - total, 0)) of a band cell, 0 outside the band
__device__ __forceinline__ float posterior(bool vm, float f, float bw,
                                           float total) {
  return vm ? expf(fminf(f + bw - total, 0.0f)) : 0.0f;
}

// total log prob at the final corner with the end weights
// (pallas_banded.py:401-411, _seg_totals :1228-1233)
template <bool LUT>
__device__ __forceinline__ float corner_total(const BandArgs& a, int b,
                                              const float* diag, int W,
                                              int k) {
  const float* e = a.end_w + b * 3;
  return log_add<LUT>(log_add<LUT>(diag[k] + e[0], diag[W + k] + e[1]),
                      diag[2 * W + k] + e[2]);
}

}  // namespace margin
