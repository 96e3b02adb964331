// Per-cell arithmetic of the banded pair-HMM forward-backward, shared by
// the monolithic kernels K2 (banded_fb.cu) and the segmented kernels K3
// (banded_seg.cu), so both run one copy of it and their cells agree bit
// for bit. A cell has two parts: its input part (band membership, the
// shifts to its sources, its symbols and three emissions), which does not
// depend on the DP values, and its recurrence on the neighbours' values.
// banded_step.cuh builds the diagonal step of both kernels from them.
//
// Layout of a pack (ops/cuda_banded.py:BandPack): problem b's diagonal d
// is row geo_off[b] + d of the flat per-diagonal arrays (xmy, width, klo);
// a diagonal holds (3, W) cells, state-major, k = band storage offset,
// cell k at x - y = xmy[d] + 2k. The storage base moves by exactly +-1 per
// diagonal, so every dependency is a neighbour k-1, k or k+1 on one of the
// two previous (forward) or next (backward) diagonals.
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

// the symbols and run lengths a cell consumes; out-of-range positions
// read symbol 4 with run length 0, as the Pallas windows' fill does
struct Cell {
  int sx, sy, rx, ry;
};

// ---------------------------------------------------------------------------
// The input part of a cell: where it lies and what it emits. None of it
// depends on the DP values, so a kernel may compute it ahead of the
// recurrence, from device or from shared memory.
// ---------------------------------------------------------------------------

struct Emis {
  float m, gx, gy;
};

// the three emissions of a cell consuming symbols c; tabs = the problem's
// 35 entries (match 25, gapX 5, gapY 5), rep = its (4, 51, 51) repeat
// table (RLE only)
template <bool RLE>
__device__ __forceinline__ Emis emissions(const float* tabs, const float* rep,
                                          const Cell& c) {
  Emis e;
  e.m = tabs[c.sx * 5 + c.sy];
  if (RLE) {
    const int base = c.sx >= 4 ? 0 : c.sx;  // N -> A (repeatSubMatrix.c:16-27)
    e.m = e.m + rep[base * REP_N * REP_N + c.rx * REP_N + c.ry];
  }
  e.gx = tabs[25 + c.sx];
  e.gy = tabs[30 + c.sy];
  return e;
}

// band storage bases of diagonal g with storage base xm: x of the
// character consumed at k = 0, minus one, and the same for y
// (_derive_geom, pallas_banded.py:556-558)
__device__ __forceinline__ int x_base_of(int g, int xm) {
  return ((g + xm) >> 1) - 1;
}
__device__ __forceinline__ int y_base_of(int g, int xm) {
  return ((g - xm) >> 1) - 1;
}

// whether cell k of diagonal g (storage base xm, valid k in [klo, wid))
// lies in the band and the DP rectangle
__device__ __forceinline__ bool band_cell(int g, int xm, int klo, int wid,
                                          int k, int lx, int ly) {
  const int x_pos = x_base_of(g, xm) + 1 + k, y_pos = y_base_of(g, xm) + 1 - k;
  return k >= klo && k < wid && x_pos >= 0 && x_pos <= lx && y_pos >= 0 &&
         y_pos <= ly;
}

// the shifts of the forward's sources: (x-1, y) at k + s1 and (x, y-1) at
// k + s1 + 1 on diagonal g-1 (storage base xm1), (x-1, y-1) at k + s2 on
// diagonal g-2 (xm2); s1 in {-1, 0}, s2 in {-1, 0, 1}
__device__ __forceinline__ int fwd_s1(int xm, int xm1) {
  return (xm - 1 - xm1) >> 1;
}
__device__ __forceinline__ int fwd_s2(int g, int xm, int xm2) {
  return g >= 2 ? (xm - xm2) >> 1 : 0;
}
// the backward's: (x+1, y) at k + t1 and (x, y+1) at k + t1 - 1 on
// diagonal g+1 (xn1), (x+1, y+1) at k + t2 on diagonal g+2 (xn2);
// t1 in {0, 1}, t2 in {-1, 0, 1}
__device__ __forceinline__ int bwd_t1(int xm, int xn1) {
  return (xm + 1 - xn1) >> 1;
}
__device__ __forceinline__ int bwd_t2(bool has2, int xm, int xn2) {
  return has2 ? (xm - xn2) >> 1 : 0;
}

// ---------------------------------------------------------------------------
// The recurrence part: a band cell's three states from its neighbours'
// values, in the Pallas kernels' expression order.
// ---------------------------------------------------------------------------

// Forward: l = the (x-1, y) cell, d = (x-1, y-1), u = (x, y-1), each
// (match, gapX, gapY); out = (match, gapX, gapY).
template <bool LUT>
__device__ __forceinline__ void forward_recurrence(const float* tr,
                                                   const Emis& e,
                                                   const float l[3],
                                                   const float d[3],
                                                   const float u[3],
                                                   float out[3]) {
  const float ngx = e.gx + log_add3<LUT>(l[0] + tr[T_OPEN_X],
                                         l[1] + tr[T_EXT_X],
                                         l[2] + tr[T_SW_X]);
  const float nm = e.m + log_add3<LUT>(d[0] + tr[T_MM],
                                       d[1] + tr[T_M_FROM_GX],
                                       d[2] + tr[T_M_FROM_GY]);
  const float ngy = e.gy + log_add3<LUT>(u[0] + tr[T_OPEN_Y],
                                         u[2] + tr[T_EXT_Y],
                                         u[1] + tr[T_SW_Y]);
  out[0] = fmaxf(nm, LOG_ZERO_F);
  out[1] = fmaxf(ngx, LOG_ZERO_F);
  out[2] = fmaxf(ngy, LOG_ZERO_F);
}

// Backward: gx_n = gapX of (x+1, y), m_n = match of (x+1, y+1), gy_n =
// gapY of (x, y+1); e = the emissions of (x+1, y+1)'s characters. to =
// the "to" terms of the cell's transitions, by target state (match,
// gapX, gapY): each successor's backward value plus the emission consumed
// leaving the cell (the transition expectations reuse them).
template <bool LUT>
__device__ __forceinline__ void backward_recurrence(const float* tr,
                                                    const Emis& e,
                                                    float gx_n, float m_n,
                                                    float gy_n, float out[3],
                                                    float to[3]) {
  to[0] = m_n + e.m;
  to[1] = gx_n + e.gx;
  to[2] = gy_n + e.gy;
  const float bm = log_add3<LUT>(to[1] + tr[T_OPEN_X], to[0] + tr[T_MM],
                                 to[2] + tr[T_OPEN_Y]);
  const float bgx = log_add3<LUT>(to[1] + tr[T_EXT_X],
                                  to[0] + tr[T_M_FROM_GX],
                                  to[2] + tr[T_SW_Y]);
  const float bgy = log_add3<LUT>(to[1] + tr[T_SW_X],
                                  to[0] + tr[T_M_FROM_GY],
                                  to[2] + tr[T_EXT_Y]);
  out[0] = fmaxf(bm, LOG_ZERO_F);
  out[1] = fmaxf(bgx, LOG_ZERO_F);
  out[2] = fmaxf(bgy, LOG_ZERO_F);
}

// The transition expectations of a band cell (updateExpectations,
// pairwiseAligner.c:349-366): add exp(f[from] + to[to] + t[from, to] -
// total) into acc[3 * from + to]; tm = the (3, 3) [from, to] transition
// log-probabilities. The order of the adds is margin_tpu's
// (ops/banded.py:478-486).
__device__ __forceinline__ void add_expectations(const float f[3],
                                                 const float to[3],
                                                 const float tm[9],
                                                 float total, float acc[9]) {
#pragma unroll
  for (int s = 0; s < 3; ++s)
#pragma unroll
    for (int t = 0; t < 3; ++t)
      acc[3 * s + t] += expf(f[s] + to[t] + tm[3 * s + t] - total);
}

// posterior exp(min(f + b - total, 0)) of a band cell, 0 outside the band
__device__ __forceinline__ float posterior(bool vm, float f, float bw,
                                           float total) {
  return vm ? expf(fminf(f + bw - total, 0.0f)) : 0.0f;
}

// total log prob at the final corner with the end weights
// (pallas_banded.py:401-411, _seg_totals :1228-1233)
template <bool LUT>
__device__ __forceinline__ float corner_value(const float* e, float m,
                                              float gx, float gy) {
  return log_add<LUT>(log_add<LUT>(m + e[0], gx + e[1]), gy + e[2]);
}

}  // namespace margin
