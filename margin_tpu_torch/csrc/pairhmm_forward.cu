// Kernel K1: batched total forward log-probability of the 3-state pair-HMM.
//
// Replaces: margin_tpu/ops/pairhmm.py:_forward_total (:194), the XLA
// lax.scan that walks anti-diagonals with the batch on the TPU's lanes.
//
// What bounds it on this card: operations. Every cell of the (lx+1)(ly+1)
// rectangle costs three 3-way logAdds (six cubic or exp/log1p evaluations);
// the bytes are the two sequences and one float out per pair. The
// recurrence is serial along anti-diagonals, so a pair's parallelism is its
// diagonal width and a launch lasts as long as its deepest pair's chain of
// lx + ly diagonal steps.
//
// Design: the diagonal step of csrc/banded_step.cuh, one block a pair.
// Lane t holds rows y = t*R .. t*R+R-1 of the pair and computes cell
// (d-1-y, y) of diagonal d at step d, with everything a cell reads in
// registers: its own three states of diagonal d-1 (gapX), the row above's
// states of d-1 (gapY) and of d-2 (match). Within a lane the row above is
// the lane's previous row; at its top edge it comes from the lane above by
// __shfl_up_sync, and at a warp's top edge from lane 31 of the warp above
// through a two-slot shared-memory exchange behind one named barrier a
// diagonal, counting only the warps that hold a row of the pair's own ly
// (the others leave at the start; a pair held in one warp uses no
// barrier). A warp none of whose rows holds a cell of diagonal d (rows
// max(0, d-lx) .. min(d, ly)) writes LOG_ZERO without computing; the total
// is taken from the last diagonal after the walk. Y and its run lengths
// are loaded into registers once a lane. X (by cp.async where whole words)
// and its run lengths (as bytes: counts are clamped to 50) are staged in
// shared memory once a block when they fit there beside the tables and
// the exchange (SX); a longer X is read from device memory where a cell
// needs it. The per-strand emission and transition tables are staged; the
// RLE repeat table is read through the read-only cache.
//
// The block has ceil((Ly+1) / (32 R)) warps, R in {1, 2, 4, 8} the fewest
// rows a lane that keep it at <= 1024 threads (Ly <= 8191); the wrapper
// computes the configuration (ops/pairhmm.py:k1_launch) and the kernel
// checks it (config_ok).
// Emissions are table reads plus the optional RLE addend
// repeat[slot(base), rep_x, rep_y] (pairhmm.py:300-305). The arithmetic and
// its order follow pairhmm.py:240-345 exactly; built with --fmad=false.
#include <cuda_runtime.h>
#include <stdint.h>

#include "banded_step.cuh"

using namespace margin;

namespace {

constexpr int MAX_THREADS = 1024;
constexpr int TAB_FLOATS = 44;  // match 25, gapX 5, gapY 5, transitions 9

struct K1Args {
  const uint8_t* xs;
  const uint8_t* ys;
  const int* lxs;
  const int* lys;
  const int* strands;
  const uint8_t* ragged_left;
  const uint8_t* ragged_right;
  const int* rep_x;
  const int* rep_y;
  const float* match;
  const float* gap_x;
  const float* gap_y;
  const float* trans;
  const float* repeat;
  float* out;
};

// A block's shared memory, in bytes: its tables; when X is staged (sx),
// the x symbols and (RLE) x run lengths, each in xbytes(Lx) (room for the
// 0-3 bytes that align the symbols' whole words); then the exchange's two
// slots of warps x 3 floats.
__host__ __device__ inline int xbytes(int Lx) { return round_up(Lx + 4, 16); }
__host__ __device__ inline int stage_bytes(int Lx, bool rle, bool sx) {
  return TAB_FLOATS * 4 + (sx ? (rle ? 2 : 1) * xbytes(Lx) : 0);
}
__host__ __device__ inline int block_bytes(int Lx, bool rle, int warps,
                                           bool sx) {
  return stage_bytes(Lx, rle, sx) + 2 * warps * 3 * 4;
}

// The wrapper's launch configuration (ops/pairhmm.py:k1_launch): `warps`
// warps of `rows` rows a lane, rows in {1, 2, 4, 8}, enough lanes for the
// Ly + 1 rows.
bool config_ok(int Ly, int warps, int rows) {
  return Ly >= 0 && warps >= 1 && warps <= MAX_THREADS / 32 &&
         (rows == 1 || rows == 2 || rows == 4 || rows == 8) &&
         32 * warps * rows >= Ly + 1;
}

__device__ __forceinline__ void named_sync(int n) {
  asm volatile("bar.sync 1, %0;\n" ::"r"(n) : "memory");
}

// u <- the states v of the row above this lane's top row: from lane-1, at
// a warp's top edge from lane 31 of the warp above (xch: two slots of
// warps x 3 floats, alternating by step, so one barrier a diagonal orders
// both the write and the read), LOG_ZERO above row 0. nt: the active
// threads.
__device__ __forceinline__ void from_above(const float v[3], float u[3],
                                           float* xch, int nt, int& step) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int s = 0; s < 3; ++s) {
    u[s] = __shfl_up_sync(FULL, v[s], 1);
    if (lane == 0) u[s] = LOG_ZERO_F;
  }
  if (nt > 32) {
    const int w = threadIdx.x >> 5;
    float* x = xch + (step & 1) * 3 * (blockDim.x >> 5);
    if (lane == 31)
      for (int s = 0; s < 3; ++s) x[w * 3 + s] = v[s];
    named_sync(nt);
    if (lane == 0 && w > 0)
      for (int s = 0; s < 3; ++s) u[s] = x[(w - 1) * 3 + s];
    ++step;
  }
}

// SX: X and its run lengths staged in shared memory (else read from
// device memory). Registers: at most 64 a thread, so that a block of 1024
// threads fits an SM, and at most 56 at R = 2, so that two blocks of 17-18
// warps (Ly 1024-1151) share one; left to itself ptxas gives R = 2 with
// RLE and the LUT logAdd 60, which holds one such block an SM.
template <bool LUT, bool RLE, int R, bool SX>
__global__ void __maxnreg__(R == 2 ? 56 : 64)
    k1_kernel(const K1Args a, int Lx, int Ly) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int b = blockIdx.x;
  const int t = threadIdx.x;
  const int lx = a.lxs[b];
  const int ly = a.lys[b];
  // the warps that hold a row of [0, ly]; the others leave
  const int nt = 32 * ((ly + 32 * R) / (32 * R));
  if (t >= nt) return;
  const int D = lx + ly;
  if (D == 0) {
    if (t == 0) a.out[b] = 0.0f;  // LOG_ONE (pairwiseAligner.c:860-862)
    return;
  }

  // --- stage the pair's tables, x symbols and x run lengths
  const int s = a.strands[b];
  float* tabs = (float*)smem;
  for (int i = t; i < 25; i += nt) tabs[i] = a.match[s * 25 + i];
  for (int i = t; i < 5; i += nt) {
    tabs[25 + i] = a.gap_x[s * 5 + i];
    tabs[30 + i] = a.gap_y[s * 5 + i];
  }
  for (int i = t; i < 9; i += nt) tabs[35 + i] = a.trans[s * 9 + i];
  const uint8_t* xrow = a.xs + (int64_t)b * Lx;
  const int head = (int)((uintptr_t)xrow & 3);
  uint8_t* sx = smem + TAB_FLOATS * 4 + head;  // sx[i] = X[i]
  uint8_t* srx = smem + TAB_FLOATS * 4 + xbytes(Lx);
  if (SX) {
    // the whole 4-byte words by cp.async, the 0-3 bytes on either side of
    // them by plain loads
    const int pre = (4 - head) & 3;
    const int nw = lx > pre ? (lx - pre) >> 2 : 0;
    for (int i = t; i < nw; i += nt)
      cp_async4(sx + pre + 4 * i, xrow + pre + 4 * i);
    for (int i = t; i < lx; i += nt)
      if (i < pre || i >= pre + 4 * nw) sx[i] = xrow[i];
    if (RLE)
      for (int i = t; i < lx; i += nt)
        srx[i] = (uint8_t)a.rep_x[(int64_t)b * Lx + i];
    cp_commit();
    cp_wait_all();
  }
  named_sync(nt);

  const float* m_tab = tabs;
  const float* gx_tab = tabs + 25;
  const float* gy_tab = tabs + 30;
  const float* tr = tabs + 35;
  const float t_mm = tr[T_MM], t_mgx = tr[T_M_FROM_GX], t_mgy = tr[T_M_FROM_GY];
  const float t_ox = tr[T_OPEN_X], t_oy = tr[T_OPEN_Y];
  const float t_ex = tr[T_EXT_X], t_ey = tr[T_EXT_Y];
  const float t_sx = tr[T_SW_X], t_sy = tr[T_SW_Y];
  const float* rep = RLE ? a.repeat + (size_t)s * 4 * REP_N * REP_N : nullptr;
  float* xch = (float*)(smem + stage_bytes(Lx, RLE, SX));

  // --- a lane's rows: y symbol, its gapY emission and run length
  const int y0 = t * R;
  int cy[R], ry[R];
  float e_gy[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int y = y0 + r;
    const bool hy = y >= 1 && y <= ly;
    cy[r] = hy ? a.ys[(int64_t)b * Ly + y - 1] : 4;
    e_gy[r] = gy_tab[cy[r]];
    ry[r] = (RLE && hy) ? a.rep_y[(int64_t)b * Ly + y - 1] : 0;
  }

  // --- diagonal 0: the start cell (0, 0) (stateMachine.c:521-530);
  // diagonal -1: LOG_ZERO
  const bool rl = a.ragged_left[b] != 0;
  float p1[R][3], p2[R][3], up1[3], up2[3];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const bool y_0 = y0 + r == 0;
    p1[r][0] = (y_0 && !rl) ? 0.0f : LOG_ZERO_F;
    p1[r][1] = p1[r][2] = (y_0 && rl) ? 0.0f : LOG_ZERO_F;
#pragma unroll
    for (int q = 0; q < 3; ++q) p2[r][q] = LOG_ZERO_F;
  }
#pragma unroll
  for (int q = 0; q < 3; ++q) up2[q] = LOG_ZERO_F;
  int step = 0;
  from_above(p1[R - 1], up1, xch, nt, step);

  for (int d = 1; d <= D; ++d) {
    float c[R][3];
    // a warp whose rows [wy, wy + 32 R) hold none of the diagonal's cells
    // (rows max(0, d - lx) .. min(d, ly)) writes LOG_ZERO and skips them
    const int wy = (t & ~31) * R;
    if (wy <= min(d, ly) && wy + 32 * R > d - lx) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int y = y0 + r;
        const int xi = d - 1 - y;  // x symbol consumed at this cell
        const bool inx = (unsigned)xi < (unsigned)lx;
        const int cx = inx ? (SX ? sx[xi] : __ldg(xrow + xi)) : 4;
        float e_m = m_tab[cx * 5 + cy[r]];
        const float e_gx = gx_tab[cx];
        if (RLE) {
          const int rx =
              inx ? (SX ? srx[xi] : __ldg(a.rep_x + (int64_t)b * Lx + xi))
                  : 0;
          const int base = cx >= 4 ? 0 : cx;  // N -> A (repeatSubMatrix.c:16-27)
          e_m = e_m + __ldg(rep + base * REP_N * REP_N + rx * REP_N + ry[r]);
        }
        // gapX <- (x-1, y): diagonal d-1, row y; gapY <- (x, y-1):
        // diagonal d-1, row y-1; match <- (x-1, y-1): diagonal d-2, row y-1
        const int ra = r > 0 ? r - 1 : 0;
        float u1[3], s2[3];
#pragma unroll
        for (int q = 0; q < 3; ++q) {
          u1[q] = r == 0 ? up1[q] : p1[ra][q];
          s2[q] = r == 0 ? up2[q] : p2[ra][q];
        }
        float ngx = e_gx + log_add3<LUT>(p1[r][0] + t_ox, p1[r][1] + t_ex,
                                         p1[r][2] + t_sx);
        float nm = e_m + log_add3<LUT>(s2[0] + t_mm, s2[1] + t_mgx,
                                       s2[2] + t_mgy);
        float ngy = e_gy[r] + log_add3<LUT>(u1[0] + t_oy, u1[2] + t_ey,
                                            u1[1] + t_sy);
        // clamp accumulated underflow to the finite LOG_ZERO; the valid
        // cells are rows y <= ly with 0 <= d - y <= lx
        const bool valid = y <= ly && (unsigned)(d - y) <= (unsigned)lx;
        c[r][0] = valid ? fmaxf(nm, LOG_ZERO_F) : LOG_ZERO_F;
        c[r][1] = valid ? fmaxf(ngx, LOG_ZERO_F) : LOG_ZERO_F;
        c[r][2] = valid ? fmaxf(ngy, LOG_ZERO_F) : LOG_ZERO_F;
      }
    } else {
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int q = 0; q < 3; ++q) c[r][q] = LOG_ZERO_F;
    }
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int q = 0; q < 3; ++q) {
        p2[r][q] = p1[r][q];
        p1[r][q] = c[r][q];
      }
#pragma unroll
    for (int q = 0; q < 3; ++q) up2[q] = up1[q];
    if (d < D) from_above(p1[R - 1], up1, xch, nt, step);
  }
  // the total at (lx, ly) with the end-state weights
  // (pairwiseAligner.c:882-892; stateMachine.c:531-560)
#pragma unroll
  for (int r = 0; r < R; ++r)
    if (y0 + r == ly) {
      const bool rr = a.ragged_right[b] != 0;
      const float em = rr ? (t_ox + t_oy) / 2.0f : t_mm;
      const float ex = rr ? t_ex : t_mgx;
      const float ey = rr ? t_ey : t_mgy;
      a.out[b] = log_add<LUT>(log_add<LUT>(p1[r][0] + em, p1[r][1] + ex),
                              p1[r][2] + ey);
    }
}

template <bool LUT, bool RLE, bool SX>
int launch(const K1Args& a, int B, int Lx, int Ly, int warps, int rows,
           int smem, cudaStream_t stream) {
  void (*kern)(const K1Args, int, int) =
      rows == 1   ? k1_kernel<LUT, RLE, 1, SX>
      : rows == 2 ? k1_kernel<LUT, RLE, 2, SX>
      : rows == 4 ? k1_kernel<LUT, RLE, 4, SX>
                  : k1_kernel<LUT, RLE, 8, SX>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  kern<<<B, 32 * warps, smem, stream>>>(a, Lx, Ly);
  return (int)cudaGetLastError();
}

template <bool LUT, bool RLE>
int launch(const K1Args& a, int B, int Lx, int Ly, int warps, int rows,
           int stage_x, int smem, cudaStream_t stream) {
  return stage_x ? launch<LUT, RLE, true>(a, B, Lx, Ly, warps, rows, smem,
                                          stream)
                 : launch<LUT, RLE, false>(a, B, Lx, Ly, warps, rows, smem,
                                           stream);
}

}  // namespace

// Shared-memory bytes of a block of `warps` warps at a batch's padded Lx,
// RLE state and X staged or not (ops/pairhmm.py:k1_launch mirrors it).
extern "C" int k1_smem_bytes(int Lx, int rle, int warps, int stage_x) {
  return block_bytes(Lx, rle != 0, warps, stage_x != 0);
}

// warps, rows, stage_x: the wrapper's launch configuration; smem: the
// shared-memory bytes it computed. The launch is refused for a
// configuration the kernel does not take or less shared memory than its
// layout needs.
extern "C" int k1_forward_total(const void* xs, const void* ys,
                                const void* lxs, const void* lys,
                                const void* strands, const void* ragged_left,
                                const void* ragged_right, const void* rep_x,
                                const void* rep_y, const void* match,
                                const void* gap_x, const void* gap_y,
                                const void* trans, const void* repeat,
                                void* out, int B, int Lx, int Ly, int use_lut,
                                int warps, int rows, int stage_x, int smem,
                                void* stream) {
  const bool rle = rep_x != nullptr;
  if (!config_ok(Ly, warps, rows) || Lx < 0 ||
      smem < block_bytes(Lx, rle, warps, stage_x != 0))
    return (int)cudaErrorInvalidValue;
  const K1Args a{(const uint8_t*)xs,     (const uint8_t*)ys,
                 (const int*)lxs,        (const int*)lys,
                 (const int*)strands,    (const uint8_t*)ragged_left,
                 (const uint8_t*)ragged_right, (const int*)rep_x,
                 (const int*)rep_y,      (const float*)match,
                 (const float*)gap_x,    (const float*)gap_y,
                 (const float*)trans,    (const float*)repeat,
                 (float*)out};
  const cudaStream_t st = (cudaStream_t)stream;
  if (use_lut)
    return rle ? launch<true, true>(a, B, Lx, Ly, warps, rows, stage_x, smem,
                                    st)
               : launch<true, false>(a, B, Lx, Ly, warps, rows, stage_x, smem,
                                     st);
  return rle ? launch<false, true>(a, B, Lx, Ly, warps, rows, stage_x, smem,
                                   st)
             : launch<false, false>(a, B, Lx, Ly, warps, rows, stage_x, smem,
                                    st);
}
