// The kernels of the banded pair-HMM forward-backward over a pack with the
// forward grid in device memory, K2-fwd and K2-bwd's walk (POST, WORDS,
// EXP instances), on banded_step.cuh's step: banded_fb.cu instantiates
// them at the width buckets 16..128 (K2, K4), banded_wide.cu the forward
// and the EXP instance at bands of 136..512 cells (K5-fwd and K5-exp's
// step design, 6..16 warps). The design is banded_fb.cu's header's.
#pragma once

#include "banded_step.cuh"

using namespace margin;

namespace {

// Shared-memory layout of a K2 block, in bytes; ops/cuda_banded.py:k2_smem
// mirrors it. A staging buffer carries the chunk's forward rows: K2-fwd
// writes them there for a bulk copy to the grid, K2-bwd reads them. The
// WORDS instance's tail holds the staged words.
__host__ __device__ inline Layout k2_layout(int W, int C, bool rle,
                                            bool words = false) {
  return layout(W, C, rle, C * 3 * W * 4, words ? WORDS_PER_BLOCK * 8 : 0);
}

// What K2-bwd's walk writes (see the header).
enum BwdOut { OUT_POST, OUT_EXP, OUT_WORDS };

// The WORDS instance's outputs: the count of selected cells (all of
// them, also beyond cap) and the first cap words.
struct WordsOut {
  float threshold;
  int* count;
  int* lo;
  int* hi;
  int cap;
};

template <bool LUT, bool RLE, int NW>
__global__ void __launch_bounds__(32 * NW)
    k2_fwd_kernel(BandArgs a, float* fwd_all, float* totals, int W, int C) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout L = k2_layout(W, C, RLE);
  const int b = blockIdx.x;
  const int k = threadIdx.x;
  const Ctx c = context(a, b, W);
  const Smem sm = smem_of(smem, L);
  float tr[9];
  load_block_tables<RLE>(a, b, (float*)(smem + L.tabs), (float*)(smem + L.rep),
                         tr);
  float* out = fwd_all + a.geo_off[b] * 3 * W;
  const int n_chunk = c.D / C + 1;
  unsigned char* const buf0 = smem + L.stage0;  // staging buffers i & 1
  Win cur = stage_fwd<RLE>(a, c, L, buf0, 0, min(C, c.D + 1), c.xmy[0]);
  int step = 0;
  Diag p1, p2;
  set_zero(p2);
  for (int ch = 0; ch < n_chunk; ++ch) {
    // the previous chunk's rows are complete: one thread copies them out
    fence_proxy_async();
    if (k == 0) bulk_wait_read();  // the copy out of this buffer is done
    cp_wait_all();
    __syncthreads();
    if (ch > 0 && k == 0) {
      const int q0 = (ch - 1) * C;
      bulk_store(out + (size_t)q0 * 3 * W,
                 buf0 + ((ch - 1) & 1) * L.stage + L.rows, C * 3 * W * 4);
    }
    unsigned char* const sb = buf0 + (ch & 1) * L.stage;
    const Stage st = stage_at(sb, L);
    float* const rows = (float*)(sb + L.rows);
    const int d0 = ch * C, d1 = min(d0 + C, c.D + 1);
    Win nxt = cur;
    if (ch + 1 < n_chunk)  // the next chunk's inputs, while this one runs
      nxt = stage_fwd<RLE>(a, c, L, buf0 + ((ch + 1) & 1) * L.stage, d1,
                           min(d1 + C, c.D + 1), st.xm[d1 - cur.gl]);
    int g = d0;
    if (ch == 0) {  // diagonal 0: the start weights at k = 0
      init_diag(a, b, k, p1);
      link<NW>(p1, sm.xch, step);
      store_row(rows, W, k, p1);
      g = 1;
    }
    if (g < d1) {
      Inputs nx = fwd_inputs<RLE, NW>(sm, st, cur, c, g, k);
      for (; g < d1; ++g) {
        const Inputs in = nx;
        nx = fwd_inputs<RLE, NW>(sm, st, cur, c, min(g + 1, d1 - 1), k);
        Diag nd;
        fwd_step<LUT, NW>(sm, tr, in, p1, p2, nd, step);
        store_row(rows + (g - d0) * 3 * W, W, k, nd);
        p2 = p1;
        p1 = nd;
      }
    }
    cur = nxt;
  }
  // the last chunk's rows
  fence_proxy_async();
  __syncthreads();
  if (k == 0) {
    const int q0 = (n_chunk - 1) * C;
    bulk_store(out + (size_t)q0 * 3 * W,
               buf0 + ((n_chunk - 1) & 1) * L.stage + L.rows,
               (c.D + 1 - q0) * 3 * W * 4);
    bulk_wait_read();
  }
  // the total at the final corner, from diagonal D
  if (k == c.kf)
    totals[b] = corner_value<LUT>(a.end_w + b * 3, p1.v[0], p1.v[1], p1.v[2]);
}

// K2-bwd (POST, WORDS) and K4 / K5-exp (EXP): the same backward walk.
// POST stores each diagonal's posteriors; WORDS stages the selected
// posterior cells' words (flushed when a warp's buffer nears full and at
// the end); EXP sums each band cell's nine transition expectations
// (updateExpectations, pairwiseAligner.c:349-366), from the "to" terms the
// step hands out and the staged forward row, into the lane's own nine
// running sums, and the block reduces them once at the end (warp
// shuffles, then the warps in order) into exp_all[b] (3 x 3, [from,
// to]). No barrier is added to the walk.
template <bool LUT, bool RLE, int NW, int OUT>
__global__ void __launch_bounds__(32 * NW)
    k2_bwd_kernel(BandArgs a, const float* fwd_all, const float* totals,
                  float* post_all, float* exp_all, WordsOut wo, int W,
                  int C) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout L = k2_layout(W, C, RLE, OUT == OUT_WORDS);
  const int b = blockIdx.x;
  const int k = threadIdx.x;
  const Ctx c = context(a, b, W);
  const Smem sm = smem_of(smem, L);
  float tr[9];
  load_block_tables<RLE>(a, b, (float*)(smem + L.tabs), (float*)(smem + L.rep),
                         tr);
  float end_w[3];
#pragma unroll
  for (int s = 0; s < 3; ++s) end_w[s] = a.end_w[b * 3 + s];
  // [from, to] transition log-probabilities, states (match, gapX, gapY)
  const float tm[9] = {tr[T_MM],        tr[T_OPEN_X], tr[T_OPEN_Y],
                       tr[T_M_FROM_GX], tr[T_EXT_X],  tr[T_SW_Y],
                       tr[T_M_FROM_GY], tr[T_SW_X],   tr[T_EXT_Y]};
  float acc[9];
#pragma unroll
  for (int i = 0; i < 9; ++i) acc[i] = 0.0f;
  constexpr int WCAP = WORDS_PER_BLOCK / NW;  // a warp's staged words
  int2* const wbuf = (int2*)(smem + L.tail) + (k >> 5) * WCAP;
  int wc = 0;
  const float total = totals[b];
  const float* fwd = fwd_all + a.geo_off[b] * 3 * W;
  float* post = OUT == OUT_POST ? post_all + a.geo_off[b] * 3 * W : nullptr;
  const int n_chunk = c.D / C + 1;
  unsigned char* const buf0 = smem + L.stage0;  // staging buffers i & 1
  const int last0 = (n_chunk - 1) * C;
  Win cur = stage_bwd<RLE>(a, c, L, buf0, last0, c.D + 1, c.xmy[c.D],
                           fwd + (size_t)last0 * 3 * W,
                           (c.D + 1 - last0) * 3 * W);
  int step = 0;
  Diag n1, n2;  // diagonals D+1 and D+2 are empty
  set_zero(n1);
  set_zero(n2);
  for (int ch = n_chunk - 1; ch >= 0; --ch) {
    cp_wait_all();
    __syncthreads();
    const Stage st = stage_at(buf0 + ((n_chunk - 1 - ch) & 1) * L.stage, L);
    const int d0 = ch * C, d1 = min(d0 + C, c.D + 1);
    Win nxt = cur;
    if (ch > 0)  // the previous chunk's inputs, while this one runs
      nxt = stage_bwd<RLE>(a, c, L, buf0 + ((n_chunk - ch) & 1) * L.stage,
                           d0 - C, d0, st.xm[d0 - 1 - cur.gl],
                           fwd + (size_t)(d0 - C) * 3 * W, C * 3 * W);
    Inputs nx = bwd_inputs<RLE, NW>(sm, st, cur, c, d1 - 1, k);
    for (int g = d1 - 1; g >= d0; --g) {
      const Inputs in = nx;
      nx = bwd_inputs<RLE, NW>(sm, st, cur, c, max(g - 1, d0), k);
      Diag nd;
      float to[3];
      bwd_step<LUT, NW>(sm, tr, in, g == c.D, end_w, k == c.kf, n1, n2, nd,
                        step, to);
      Diag f;
      if (OUT != OUT_EXP || in.live)
        load_row(st.rows + (g - d0) * 3 * W, W, k, f);
      if (OUT == OUT_EXP && in.vm) add_expectations(f.v, to, tm, total, acc);
      if (OUT != OUT_EXP) {
#pragma unroll
        for (int s = 0; s < 3; ++s)
          f.v[s] = posterior(in.vm, f.v[s], nd.v[s], total);
      }
      if (OUT == OUT_POST) store_row(post + (size_t)g * 3 * W, W, k, f);
      if (OUT == OUT_WORDS) {
        const int xm = st.xm[g - cur.gl];
        stage_words(f.v, x_base_of(g, xm) + 1 + k > 0,
                    y_base_of(g, xm) + 1 - k > 0, k, W, wo.threshold, g, b,
                    wbuf, wc);
        if (wc > WCAP - 3 * 32)
          flush_words(wbuf, wc, wo.count, wo.lo, wo.hi, wo.cap);
      }
      n2 = n1;
      n1 = nd;
    }
    cur = nxt;
  }
  if (OUT == OUT_WORDS) flush_words(wbuf, wc, wo.count, wo.lo, wo.hi, wo.cap);
  if (OUT == OUT_EXP) {
#pragma unroll
    for (int i = 0; i < 9; ++i)
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) acc[i] += __shfl_xor_sync(FULL, acc[i], o);
    // the warps' sums through the exchange slots, once the walk is done
    __syncthreads();
    if ((k & 31) == 0)
#pragma unroll
      for (int i = 0; i < 9; ++i) sm.xch[(k >> 5) * 9 + i] = acc[i];
    __syncthreads();
    if (k < 9) {
      float v = 0.0f;
      for (int w = 0; w < NW; ++w) v += sm.xch[w * 9 + k];
      exp_all[b * 9 + k] = v;
    }
  }
}

// ---------------------------------------------------------------------------
// launches of one block shape (BLOCK_OF_WIDTH, BLOCK_OF_WIDE_WIDTH)
// ---------------------------------------------------------------------------

template <bool LUT, bool RLE, int NW>
int launch_fwd(const BandArgs& a, void** q, int B, int W, int C, int smem,
               cudaStream_t st) {
  auto kern = k2_fwd_kernel<LUT, RLE, NW>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  kern<<<B, 32 * NW, smem, st>>>(a, (float*)q[0], (float*)q[1], W, C);
  return (int)cudaGetLastError();
}

template <int OUT>
struct Bwd {
  template <bool LUT, bool RLE, int NW>
  static int launch(const BandArgs& a, void** q, const WordsOut& wo, int B,
                    int W, int C, int smem, cudaStream_t st) {
    auto kern = k2_bwd_kernel<LUT, RLE, NW, OUT>;
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    // q: fwd, totals, then the posterior grid (POST) or the expectations
    // (EXP); WORDS writes through wo
    kern<<<B, 32 * NW, smem, st>>>(a, (const float*)q[0], (const float*)q[1],
                                   OUT == OUT_POST ? (float*)q[2] : nullptr,
                                   OUT == OUT_EXP ? (float*)q[2] : nullptr, wo,
                                   W, C);
    return (int)cudaGetLastError();
  }
};

}  // namespace
