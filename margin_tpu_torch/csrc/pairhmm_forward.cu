// Kernel K1: batched total forward log-probability of the 3-state pair-HMM.
//
// Replaces: margin_tpu/ops/pairhmm.py:_forward_total (:194), the XLA
// lax.scan that walks anti-diagonals with the batch on the TPU's lanes.
//
// What bounds it on this card: operations. Every cell of the (lx+1)(ly+1)
// rectangle costs three 3-way logAdds (six cubic or exp/log1p evaluations)
// on data that stays in shared memory; the bytes are the two sequences and
// one float out per pair. The recurrence is serial along anti-diagonals,
// so a pair's parallelism is its diagonal width.
//
// Design: one thread block per pair, threads over the rows y of an
// anti-diagonal (a thread takes rows y, y+blockDim, ... when ly+1 exceeds
// the block). The block walks d = 1..lx+ly of ITS OWN pair, so padding of
// the batch costs nothing; the previous two diagonals (3 states x (ly+1))
// live in a three-deep ring in shared memory with one __syncthreads() per
// diagonal, and only the valid rows [max(0, d-lx), min(d, ly)] run the
// logAdds (the others are written LOG_ZERO, as the JAX mask does).
// Emissions are table reads of the 25/5/5-entry per-strand tables staged
// in shared memory, plus the optional RLE addend
// repeat[slot(base), rep_x, rep_y] (pairhmm.py:300-305). The arithmetic
// and its order follow pairhmm.py:240-345 exactly; built with
// --fmad=false.
#include <cuda_runtime.h>
#include <stdint.h>

#include "logadd.cuh"

using namespace margin;

template <bool LUT, bool RLE>
__global__ void k1_kernel(const uint8_t* __restrict__ xs,
                          const uint8_t* __restrict__ ys,
                          const int* __restrict__ lxs,
                          const int* __restrict__ lys,
                          const int* __restrict__ strands,
                          const uint8_t* __restrict__ ragged_left,
                          const uint8_t* __restrict__ ragged_right,
                          const int* __restrict__ rep_x,
                          const int* __restrict__ rep_y,
                          const float* __restrict__ match,
                          const float* __restrict__ gap_x,
                          const float* __restrict__ gap_y,
                          const float* __restrict__ trans,
                          const float* __restrict__ repeat,
                          float* __restrict__ out, int Lx, int Ly) {
  extern __shared__ float smem[];
  const int b = blockIdx.x;
  const int lx = lxs[b];
  const int ly = lys[b];
  const int W = ly + 1;
  const int s = strands[b];
  __shared__ float m_tab[25], gx_tab[5], gy_tab[5], tr[9];
  for (int i = threadIdx.x; i < 25; i += blockDim.x) m_tab[i] = match[s * 25 + i];
  for (int i = threadIdx.x; i < 5; i += blockDim.x) {
    gx_tab[i] = gap_x[s * 5 + i];
    gy_tab[i] = gap_y[s * 5 + i];
  }
  for (int i = threadIdx.x; i < 9; i += blockDim.x) tr[i] = trans[s * 9 + i];
  // ring of three diagonals x three states, each W floats
  float* ring = smem;
  const bool rl = ragged_left[b] != 0;
  for (int y = threadIdx.x; y < W; y += blockDim.x) {
    // diagonal 0: start cell (0, 0) (stateMachine.c:521-530)
    ring[0 * W + y] = (y == 0 && !rl) ? 0.0f : LOG_ZERO_F;  // match
    ring[1 * W + y] = (y == 0 && rl) ? 0.0f : LOG_ZERO_F;   // gapX
    ring[2 * W + y] = (y == 0 && rl) ? 0.0f : LOG_ZERO_F;   // gapY
    for (int q = 6; q < 9; ++q) ring[q * W + y] = LOG_ZERO_F;  // diagonal -1
  }
  __syncthreads();
  const int d_final = lx + ly;
  if (d_final == 0) {
    if (threadIdx.x == 0) out[b] = 0.0f;  // LOG_ONE (pairwiseAligner.c:860-862)
    return;
  }
  const uint8_t* X = xs + (size_t)b * Lx;
  const uint8_t* Y = ys + (size_t)b * Ly;
  const int* RX = RLE ? rep_x + (size_t)b * Lx : nullptr;
  const int* RY = RLE ? rep_y + (size_t)b * Ly : nullptr;
  const float* rep = RLE ? repeat + (size_t)s * 4 * REP_N * REP_N : nullptr;
  const float t_mm = tr[T_MM], t_mgx = tr[T_M_FROM_GX], t_mgy = tr[T_M_FROM_GY];
  const float t_ox = tr[T_OPEN_X], t_oy = tr[T_OPEN_Y];
  const float t_ex = tr[T_EXT_X], t_ey = tr[T_EXT_Y];
  const float t_sx = tr[T_SW_X], t_sy = tr[T_SW_Y];

  for (int d = 1; d <= d_final; ++d) {
    float* cur = ring + (d % 3) * 3 * W;
    const float* p1 = ring + ((d + 2) % 3) * 3 * W;  // diagonal d-1
    const float* p2 = ring + ((d + 1) % 3) * 3 * W;  // diagonal d-2
    const int y_lo = max(0, d - lx);
    const int y_hi = min(d, ly);
    for (int y = threadIdx.x; y < W; y += blockDim.x) {
      float nm = LOG_ZERO_F, ngx = LOG_ZERO_F, ngy = LOG_ZERO_F;
      if (y >= y_lo && y <= y_hi) {
        const int xi = d - 1 - y;  // x symbol consumed at this cell
        const int cx = (xi >= 0 && xi < lx) ? X[xi] : 4;
        const int cy = (y >= 1) ? Y[y - 1] : 4;
        float e_m = m_tab[cx * 5 + cy];
        const float e_gx = gx_tab[cx];
        const float e_gy = gy_tab[cy];
        if (RLE) {
          const int rx = (xi >= 0 && xi < lx) ? RX[xi] : 0;
          const int ry = (y >= 1) ? RY[y - 1] : 0;
          const int base = cx >= 4 ? 0 : cx;  // N -> A (repeatSubMatrix.c:16-27)
          e_m = e_m + rep[base * REP_N * REP_N + rx * REP_N + ry];
        }
        // gapX <- (x-1, y): diagonal d-1, row y
        const float p1m = p1[y], p1x = p1[W + y], p1y = p1[2 * W + y];
        // gapY <- (x, y-1): diagonal d-1, row y-1; match <- (x-1, y-1):
        // diagonal d-2, row y-1
        float u1m = LOG_ZERO_F, u1x = LOG_ZERO_F, u1y = LOG_ZERO_F;
        float s2m = LOG_ZERO_F, s2x = LOG_ZERO_F, s2y = LOG_ZERO_F;
        if (y >= 1) {
          u1m = p1[y - 1]; u1x = p1[W + y - 1]; u1y = p1[2 * W + y - 1];
          s2m = p2[y - 1]; s2x = p2[W + y - 1]; s2y = p2[2 * W + y - 1];
        }
        ngx = e_gx + log_add3<LUT>(p1m + t_ox, p1x + t_ex, p1y + t_sx);
        nm = e_m + log_add3<LUT>(s2m + t_mm, s2x + t_mgx, s2y + t_mgy);
        ngy = e_gy + log_add3<LUT>(u1m + t_oy, u1y + t_ey, u1x + t_sy);
        // clamp accumulated underflow to the finite LOG_ZERO
        nm = fmaxf(nm, LOG_ZERO_F);
        ngx = fmaxf(ngx, LOG_ZERO_F);
        ngy = fmaxf(ngy, LOG_ZERO_F);
        if (d == d_final && y == ly) {
          // total at (lx, ly) with the end-state weights
          // (pairwiseAligner.c:882-892; stateMachine.c:531-560)
          const bool rr = ragged_right[b] != 0;
          const float em = rr ? (t_ox + t_oy) / 2.0f : t_mm;
          const float ex = rr ? t_ex : t_mgx;
          const float ey = rr ? t_ey : t_mgy;
          out[b] = log_add<LUT>(log_add<LUT>(nm + em, ngx + ex), ngy + ey);
        }
      }
      cur[y] = nm;
      cur[W + y] = ngx;
      cur[2 * W + y] = ngy;
    }
    __syncthreads();
  }
}

extern "C" int k1_forward_total(const void* xs, const void* ys,
                                const void* lxs, const void* lys,
                                const void* strands, const void* ragged_left,
                                const void* ragged_right, const void* rep_x,
                                const void* rep_y, const void* match,
                                const void* gap_x, const void* gap_y,
                                const void* trans, const void* repeat,
                                void* out, int B, int Lx, int Ly, int use_lut,
                                void* stream) {
  const int W = Ly + 1;
  int threads = ((W + 31) / 32) * 32;
  if (threads > 256) threads = 256;
  if (threads < 32) threads = 32;
  const size_t smem = (size_t)9 * W * sizeof(float);
  const bool rle = rep_x != nullptr;
  void (*kern)(const uint8_t*, const uint8_t*, const int*, const int*,
               const int*, const uint8_t*, const uint8_t*, const int*,
               const int*, const float*, const float*, const float*,
               const float*, const float*, float*, int, int);
  if (use_lut) {
    kern = rle ? k1_kernel<true, true> : k1_kernel<true, false>;
  } else {
    kern = rle ? k1_kernel<false, true> : k1_kernel<false, false>;
  }
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kern<<<B, threads, smem, (cudaStream_t)stream>>>(
      (const uint8_t*)xs, (const uint8_t*)ys, (const int*)lxs,
      (const int*)lys, (const int*)strands, (const uint8_t*)ragged_left,
      (const uint8_t*)ragged_right, (const int*)rep_x, (const int*)rep_y,
      (const float*)match, (const float*)gap_x, (const float*)gap_y,
      (const float*)trans, (const float*)repeat, (float*)out, Lx, Ly);
  return (int)cudaGetLastError();
}
