// Kernels K5-fwd and K5-exp: the banded 3-state pair-HMM forward, then
// the backward walk summing the Baum-Welch transition expectations of
// every band cell, for bands wider than K2's 128 cells (the transition
// expectations of getExpectationsUsingAnchors on kmer anchors give bands
// of 100-424 cells).
//
// Replaces: the XLA scan margin_tpu/ops/banded.py:_banded_fb_core (:267,
// compute_expectations :478-486), which margin_tpu's banded_expectations
// (:1910) runs at any band width on its device. K5-fwd writes the forward
// grid (rows, 3, W) and the totals as K2-fwd does; K5-exp sums the nine
// expectations of a problem as K4 does, into (B, 3, 3) [from, to].
//
// What bounds them on this card: the latency of each problem's serial
// walk over its anti-diagonals, as for K2 (~100 float operations a band
// cell; the bytes are the inputs and the forward grid, written once and
// read back once): one block a problem, so a launch lasts its deepest
// problem's diagonal count times one diagonal step.
//
// Two designs, chosen from W by the wrappers (ops/cuda_banded.py:
// k5_design):
//   * The step design, bands of 136..512 cells (a multiple of 8): K2's
//     kernels (banded_k2.cuh), K2-fwd and K2-bwd's EXP instance (K4), at
//     NW = block_warps(W) = 6, 8, .., 16 warps. Lane k holds band cell k
//     in registers (lanes k >= W idle), neighbours come from shuffles and
//     warp edges from the exchange behind a named barrier, inputs and
//     forward rows are staged one chunk ahead by cp.async, K5-fwd's rows
//     go out by cp.async.bulk; the exchange slots and EXP's reduction
//     are sized by NW, so K2's layouts at W <= 128 do not change. The
//     strided design below spent its step on a __syncthreads() a
//     diagonal, 9 ring loads and 3 ring stores a cell, geometry and
//     symbol loads from device memory on the chain, and (K5-fwd) a
//     direct store of each row. At more than 4 warps a block is bound
//     by instruction issue (two warps or more on each of the SM's four
//     schedulers, a cell's ~100 float operations each), so a warp with
//     no band cell on a diagonal skips its emissions and recurrence
//     (banded_step.cuh:warp_live): a kmer-anchored band's own width
//     moves far below its pack width W along the walk, and over 70% of
//     the warp-diagonals of chip_smoke's em phase have no cell.
//   * The strided design, the route for bands wider than 512 (it serves
//     any width): one block a problem whose threads stride over the
//     band's cells, one __syncthreads() a diagonal.
//       - A block of min(1024, W rounded up to 32) threads; thread t
//         takes cells t, t + T, ... of each diagonal, so any width runs.
//       - The last three diagonals (3 states x W cells each, with a
//         LOG_ZERO cell at both ends of a row for the neighbours beyond
//         the band storage) sit in a ring in shared memory, or, for a
//         band too wide for the 227 KB of a block (W > ~6400), in the
//         block's slice of a device-memory buffer the wrapper allocates.
//         A diagonal reads the two before it (forward) or after it
//         (backward) and writes its own slot, which no thread reads in
//         that step: one barrier a diagonal orders it all.
//       - The problem's emissions sit in shared memory; symbols, run
//         lengths, the per-diagonal geometry and (RLE) the repeat table
//         are read from device memory through the caches.
// The per-cell arithmetic is banded_cell.cuh's, shared with K2 and K3, so
// the forward cells and totals of both designs equal the plain twins'
// (and K2's) bit for bit; built with --fmad=false. The expectations' sums
// run in another order than the twin's: each thread keeps its own running
// sums over the whole walk, then the block reduces them (a warp's
// butterfly, then the warps in order).
#include "banded_k2.cuh"

namespace {

constexpr int MAX_THREADS = 1024;

// Shared-memory layout of a K5 block, in bytes
// (ops/cuda_banded.py:k5_smem mirrors it): the emissions, the warps' nine
// sums for the block reduction, then (ring_shared) the ring of three
// diagonals, 3 x 3 x (W + 2) floats.
struct WideLayout {
  int tabs, red, ring, total;
};

__host__ __device__ inline WideLayout k5_layout(int W, bool ring_shared) {
  WideLayout L;
  L.tabs = 0;
  L.red = 36 * 4;
  L.ring = L.red + (MAX_THREADS / 32) * 9 * 4;
  L.total = L.ring + (ring_shared ? 9 * (W + 2) * 4 : 0);
  return L;
}

struct Block {
  int b, t, T, R;
  Ctx c;
  const float* tabs;
  const float* rep;
  float* ring;  // slot i, state s, cell k at ring[(3 i + s) R + 1 + k]
  float tr[9];
};

// The block's problem, emissions (into shared memory), transitions and
// ring, every ring cell set to LOG_ZERO (the diagonals before the first
// and after the last are empty); ends with a barrier.
template <bool RLE>
__device__ __forceinline__ Block setup(const BandArgs& a, unsigned char* smem,
                                       float* ring_dev, int W,
                                       bool ring_shared) {
  const WideLayout L = k5_layout(W, ring_shared);
  Block pb;
  pb.b = blockIdx.x;
  pb.t = threadIdx.x;
  pb.T = blockDim.x;
  pb.R = W + 2;
  pb.c.b = pb.b;
  pb.c.lx = a.lxs[pb.b];
  pb.c.ly = a.lys[pb.b];
  pb.c.D = pb.c.lx + pb.c.ly;
  pb.c.W = W;
  pb.c.kf = a.k_final[pb.b];
  pb.c.x_off = a.x_off[pb.b];
  pb.c.y_off = a.y_off[pb.b];
  const int64_t g0 = a.geo_off[pb.b];
  pb.c.xmy = a.xmy + g0;
  pb.c.wid = a.width + g0;
  pb.c.klo = a.klo + g0;
  float* tabs = (float*)(smem + L.tabs);
  for (int i = pb.t; i < 35; i += pb.T) tabs[i] = a.tabs[pb.b * 35 + i];
  pb.tabs = tabs;
  pb.rep = RLE ? a.rep_tab + (size_t)pb.b * 4 * REP_N * REP_N : nullptr;
#pragma unroll
  for (int i = 0; i < 9; ++i) pb.tr[i] = a.trans[pb.b * 9 + i];
  pb.ring = ring_shared ? (float*)(smem + L.ring)
                       : ring_dev + (size_t)pb.b * 9 * pb.R;
  for (int i = pb.t; i < 9 * pb.R; i += pb.T) pb.ring[i] = LOG_ZERO_F;
  __syncthreads();
  return pb;
}

// cell k of ring slot i, state s
__device__ __forceinline__ float* slot(const Block& pb, int i) {
  return pb.ring + 3 * i * pb.R + 1;
}

// the emissions of a cell consuming x index ix and y index iy (symbol 4
// with run length 0 out of range, as the Pallas windows' fill does)
template <bool RLE>
__device__ __forceinline__ Emis cell_emissions(const BandArgs& a,
                                               const Block& pb, int ix,
                                               int iy) {
  Cell cs;
  const bool inx = ix >= 0 && ix < pb.c.lx;
  const bool iny = iy >= 0 && iy < pb.c.ly;
  cs.sx = inx ? a.xs[pb.c.x_off + ix] : 4;
  cs.sy = iny ? a.ys[pb.c.y_off + iy] : 4;
  cs.rx = (RLE && inx) ? a.rep_x[pb.c.x_off + ix] : 0;
  cs.ry = (RLE && iny) ? a.rep_y[pb.c.y_off + iy] : 0;
  return emissions<RLE>(pb.tabs, pb.rep, cs);
}

template <bool LUT, bool RLE>
__global__ void __launch_bounds__(MAX_THREADS)
    k5_fwd_kernel(BandArgs a, float* fwd_all, float* totals, float* ring_dev,
                  int W, int ring_shared) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Block pb = setup<RLE>(a, smem, ring_dev, W, ring_shared != 0);
  const Ctx& c = pb.c;
  const int R = pb.R;
  float* out = fwd_all + a.geo_off[pb.b] * 3 * W;
  // diagonal 0: the start weights at k = 0 (stateMachine.c:521-530)
  for (int q = pb.t; q < W; q += pb.T)
#pragma unroll
    for (int s = 0; s < 3; ++s) {
      const float v = q == 0 ? a.init[pb.b * 3 + s] : LOG_ZERO_F;
      slot(pb, 0)[s * R + q] = v;
      out[s * W + q] = v;
    }
  __syncthreads();
  for (int g = 1; g <= c.D; ++g) {
    const float* p1 = slot(pb, (g - 1) % 3);
    const float* p2 = slot(pb, (g + 1) % 3);  // diagonal g - 2
    float* cur = slot(pb, g % 3);
    float* row = out + (size_t)g * 3 * W;
    const int xm = c.xmy[g];
    const int sa = fwd_s1(xm, c.xmy[g - 1]);
    const int sb = fwd_s2(g, xm, g >= 2 ? c.xmy[g - 2] : 0);
    const int xb = x_base_of(g, xm), yb = y_base_of(g, xm);
    const int klo = c.klo[g], wid = c.wid[g];
    for (int q = pb.t; q < W; q += pb.T) {
      const bool vm = band_cell(g, xm, klo, wid, q, c.lx, c.ly);
      const Emis e = cell_emissions<RLE>(a, pb, xb + q, yb - q);
      float l[3], d[3], u[3], o[3];
#pragma unroll
      for (int s = 0; s < 3; ++s) {
        l[s] = p1[s * R + q + sa];
        u[s] = p1[s * R + q + sa + 1];
        d[s] = p2[s * R + q + sb];
      }
      forward_recurrence<LUT>(pb.tr, e, l, d, u, o);
#pragma unroll
      for (int s = 0; s < 3; ++s) {
        const float v = vm ? o[s] : LOG_ZERO_F;
        cur[s * R + q] = v;
        row[s * W + q] = v;
      }
    }
    __syncthreads();
  }
  // the total at the final corner, from diagonal D
  if (pb.t == 0) {
    const float* last = slot(pb, c.D % 3);
    totals[pb.b] = corner_value<LUT>(a.end_w + pb.b * 3, last[c.kf],
                                    last[R + c.kf], last[2 * R + c.kf]);
  }
}

template <bool LUT, bool RLE>
__global__ void __launch_bounds__(MAX_THREADS)
    k5_exp_kernel(BandArgs a, const float* fwd_all, const float* totals,
                  float* exp_all, float* ring_dev, int W, int ring_shared) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Block pb = setup<RLE>(a, smem, ring_dev, W, ring_shared != 0);
  const Ctx& c = pb.c;
  const int R = pb.R;
  const float* tr = pb.tr;
  float end_w[3];
#pragma unroll
  for (int s = 0; s < 3; ++s) end_w[s] = a.end_w[pb.b * 3 + s];
  // [from, to] transition log-probabilities, states (match, gapX, gapY)
  const float tm[9] = {tr[T_MM],        tr[T_OPEN_X], tr[T_OPEN_Y],
                       tr[T_M_FROM_GX], tr[T_EXT_X],  tr[T_SW_Y],
                       tr[T_M_FROM_GY], tr[T_SW_X],   tr[T_EXT_Y]};
  float acc[9];
#pragma unroll
  for (int i = 0; i < 9; ++i) acc[i] = 0.0f;
  const float total = totals[pb.b];
  const float* fwd = fwd_all + a.geo_off[pb.b] * 3 * W;
  for (int g = c.D; g >= 0; --g) {
    const float* n1 = slot(pb, (g + 1) % 3);
    const float* n2 = slot(pb, (g + 2) % 3);
    float* cur = slot(pb, g % 3);
    const float* frow = fwd + (size_t)g * 3 * W;
    const int xm = c.xmy[g];
    // diagonal D has no successor: its neighbours are all LOG_ZERO
    const int t1 = g < c.D ? bwd_t1(xm, c.xmy[g + 1]) : 0;
    const bool has2 = g + 2 <= c.D;
    const int t2 = bwd_t2(has2, xm, has2 ? c.xmy[g + 2] : 0);
    const int xb = x_base_of(g, xm), yb = y_base_of(g, xm);
    const int klo = c.klo[g], wid = c.wid[g];
    for (int q = pb.t; q < W; q += pb.T) {
      const bool vm = band_cell(g, xm, klo, wid, q, c.lx, c.ly);
      const Emis e = cell_emissions<RLE>(a, pb, xb + q + 1, yb + 1 - q);
      float o[3], to[3];
      backward_recurrence<LUT>(tr, e, n1[R + q + t1], n2[q + t2],
                               n1[2 * R + q + t1 - 1], o, to);
#pragma unroll
      for (int s = 0; s < 3; ++s)
        cur[s * R + q] = g == c.D ? (q == c.kf ? end_w[s] : LOG_ZERO_F)
                                  : (vm ? o[s] : LOG_ZERO_F);
      if (vm) {
        const float f[3] = {frow[q], frow[W + q], frow[2 * W + q]};
        add_expectations(f, to, tm, total, acc);
      }
    }
    __syncthreads();
  }
  // the block's sums: warp shuffles, then the warps in order
#pragma unroll
  for (int i = 0; i < 9; ++i)
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) acc[i] += __shfl_xor_sync(FULL, acc[i], o);
  float* red = (float*)(smem + k5_layout(W, ring_shared != 0).red);
  if ((pb.t & 31) == 0)
#pragma unroll
    for (int i = 0; i < 9; ++i) red[(pb.t >> 5) * 9 + i] = acc[i];
  __syncthreads();
  if (pb.t < 9) {
    float v = 0.0f;
    for (int w = 0; w < pb.T / 32; ++w) v += red[w * 9 + pb.t];
    exp_all[pb.b * 9 + pb.t] = v;
  }
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

template <class Kern>
int prepare(Kern kern, int smem) {
  if (smem <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

bool refused(int W, int threads, int smem, int ring_shared,
             const void* ring) {
  return W < 1 || threads < 32 || threads > MAX_THREADS || threads % 32 ||
         smem < k5_layout(W, ring_shared != 0).total ||
         (!ring_shared && ring == nullptr);
}

template <bool LUT, bool RLE>
int strided_fwd(const BandArgs& a, void** q, int B, int W, int threads,
                int smem, int ring_shared, cudaStream_t st) {
  auto kern = k5_fwd_kernel<LUT, RLE>;
  const int e = prepare(kern, smem);
  if (e) return e;
  kern<<<B, threads, smem, st>>>(a, (float*)q[0], (float*)q[1], (float*)q[2],
                                 W, ring_shared);
  return (int)cudaGetLastError();
}

template <bool LUT, bool RLE>
int strided_exp(const BandArgs& a, void** q, int B, int W, int threads,
                int smem, int ring_shared, cudaStream_t st) {
  auto kern = k5_exp_kernel<LUT, RLE>;
  const int e = prepare(kern, smem);
  if (e) return e;
  kern<<<B, threads, smem, st>>>(a, (const float*)q[0], (const float*)q[1],
                                 (float*)q[2], (float*)q[3], W, ring_shared);
  return (int)cudaGetLastError();
}

// the step design: K2-fwd and K2-bwd EXP at block_warps(W) = 6..16 warps
template <bool LUT, bool RLE>
int step_forward_block(const BandArgs& a, void** q, int B, int W, int C,
                       int smem, cudaStream_t st) {
  BLOCK_OF_WIDE_WIDTH(launch_fwd, a, q, B, W, C, smem, st)
}

template <bool LUT, bool RLE>
int step_exp_block(const BandArgs& a, void** q, int B, int W, int C,
                   int smem, cudaStream_t st) {
  using K = Bwd<OUT_EXP>;
  BLOCK_OF_WIDE_WIDTH(K::template launch, a, q, WordsOut{}, B, W, C, smem,
                      st)
}

template <bool EXP>
int step_entry(void** ptrs, int B, int W, int C, int use_lut, int smem,
               void* stream) {
  if (B == 0) return 0;
  const BandArgs a = band_args(ptrs);
  const bool rle = a.rep_x != nullptr;
  if (C < 1 || smem < k2_layout(W, C, rle).total)
    return (int)cudaErrorInvalidValue;
  void** q = ptrs + BAND_ARGS_N;
  cudaStream_t st = (cudaStream_t)stream;
  if (EXP) {
    if (use_lut)
      return rle ? step_exp_block<true, true>(a, q, B, W, C, smem, st)
                 : step_exp_block<true, false>(a, q, B, W, C, smem, st);
    return rle ? step_exp_block<false, true>(a, q, B, W, C, smem, st)
               : step_exp_block<false, false>(a, q, B, W, C, smem, st);
  }
  if (use_lut)
    return rle ? step_forward_block<true, true>(a, q, B, W, C, smem, st)
               : step_forward_block<true, false>(a, q, B, W, C, smem, st);
  return rle ? step_forward_block<false, true>(a, q, B, W, C, smem, st)
             : step_forward_block<false, false>(a, q, B, W, C, smem, st);
}

}  // namespace

// Shared-memory bytes of a step-design K5 block at width W and chunk
// depth C (K2's layout, banded_k2.cuh:k2_layout; K5-fwd's and K5-exp's
// are alike).
extern "C" int k5_step_smem_bytes(int W, int C, int rle) {
  return k2_layout(W, C, rle != 0).total;
}

// K5-fwd, step design (W in 136..512, a multiple of 8). ptrs: the 18
// BandArgs pointers in field order (rep_* may be null), then fwd (rows,
// 3, W) and totals (B,); smem at least k5_step_smem_bytes(W, C, rle).
extern "C" int k5_step_forward(void** ptrs, int B, int W, int C,
                               int use_lut, int smem, void* stream) {
  return step_entry<false>(ptrs, B, W, C, use_lut, smem, stream);
}

// K5-exp, step design: ptrs: the 18 BandArgs pointers, then fwd, totals,
// exp (B, 3, 3); smem at least k5_step_smem_bytes(W, C, rle).
extern "C" int k5_step_expectations(void** ptrs, int B, int W, int C,
                                    int use_lut, int smem, void* stream) {
  return step_entry<true>(ptrs, B, W, C, use_lut, smem, stream);
}

// Shared-memory bytes of a strided K5 block (K5-fwd's and K5-exp's are
// alike); ring_shared: whether the ring of three diagonals is in it.
extern "C" int k5_smem_bytes(int W, int ring_shared) {
  return k5_layout(W, ring_shared != 0).total;
}

// K5-fwd, strided design (any W). ptrs: the 18 BandArgs pointers in field
// order (rep_* may be null), then fwd (rows, 3, W), totals (B,) and the
// device-memory ring (B x 9 x (W + 2) floats; null when ring_shared);
// threads: a multiple of 32 up to 1024; smem at least k5_smem_bytes(W,
// ring_shared).
extern "C" int k5_forward(void** ptrs, int B, int W, int threads,
                          int use_lut, int smem, int ring_shared,
                          void* stream) {
  if (B == 0) return 0;
  const BandArgs a = band_args(ptrs);
  void** q = ptrs + BAND_ARGS_N;
  if (refused(W, threads, smem, ring_shared, q[2]))
    return (int)cudaErrorInvalidValue;
  const bool rle = a.rep_x != nullptr;
  cudaStream_t st = (cudaStream_t)stream;
  if (use_lut)
    return rle ? strided_fwd<true, true>(a, q, B, W, threads, smem,
                                         ring_shared, st)
               : strided_fwd<true, false>(a, q, B, W, threads, smem,
                                          ring_shared, st);
  return rle ? strided_fwd<false, true>(a, q, B, W, threads, smem,
                                        ring_shared, st)
             : strided_fwd<false, false>(a, q, B, W, threads, smem,
                                         ring_shared, st);
}

// K5-exp, strided design. ptrs: the 18 BandArgs pointers, then fwd,
// totals, exp (B, 3, 3) and the ring (as for k5_forward).
extern "C" int k5_expectations(void** ptrs, int B, int W, int threads,
                               int use_lut, int smem, int ring_shared,
                               void* stream) {
  if (B == 0) return 0;
  const BandArgs a = band_args(ptrs);
  void** q = ptrs + BAND_ARGS_N;
  if (refused(W, threads, smem, ring_shared, q[3]))
    return (int)cudaErrorInvalidValue;
  const bool rle = a.rep_x != nullptr;
  cudaStream_t st = (cudaStream_t)stream;
  if (use_lut)
    return rle ? strided_exp<true, true>(a, q, B, W, threads, smem,
                                         ring_shared, st)
               : strided_exp<true, false>(a, q, B, W, threads, smem,
                                          ring_shared, st);
  return rle ? strided_exp<false, true>(a, q, B, W, threads, smem,
                                        ring_shared, st)
             : strided_exp<false, false>(a, q, B, W, threads, smem,
                                         ring_shared, st);
}
