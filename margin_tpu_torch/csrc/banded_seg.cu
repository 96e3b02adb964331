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
// Why segments: the monolithic K2 stores the (D, 3, W) forward grid and
// writes a posterior grid of the same size. A 100 kb polish read (D ~
// 1.5e5 diagonals) at W = 32 needs ~115 MB for one problem and ~15 GB for
// a pack of 128. K3-fwd keeps the carry into every segment of S diagonals
// (two diagonals); K3-bwd recomputes each segment's forward from it.
//
// What bounds them on this card: the latency of each problem's serial
// walk over its anti-diagonals. The work is ~100 float operations a band
// cell and the bytes are the inputs, the checkpoints and the words, both
// far below a millisecond for a pack; a problem's diagonals depend on each
// other, so the kernel time is the deepest problem's diagonal count times
// the time one diagonal step takes. Packs hold <= 128 problems, so
// the card's 132 SMs run one block each and the step time is all that is
// left to cut. The design takes everything but the recurrence off a
// step's dependency chain:
//   * One block per problem, of NW = max(W, 32) / 32 warps; lane k holds
//     band cell k (W = 16 leaves half a warp idle). A diagonal's cells
//     stay in registers. The neighbours k-1 and k+1 (every dependency,
//     since the storage base moves by +-1 a diagonal) come from
//     __shfl_up_sync / __shfl_down_sync and, at a warp's edge, from a
//     two-slot exchange in shared memory behind a named barrier over the
//     block's warps: no block-wide barrier per diagonal, none at all at
//     W <= 32. (One warp holding W / 32 cells a lane, with no barrier,
//     was slower at W = 64 and 128 on the H100: its cells' instructions
//     issue from one warp; PERF.md has both.)
//   * Inputs staged in shared memory, one segment ahead: cp.async copies
//     a segment's per-diagonal geometry (xmy, width, klo over [d0-2,
//     d1+2)), the symbol and run-length windows its cells consume (x_base
//     and y_base move monotonically, so these are contiguous, of at most
//     S + W entries, bounded from one diagonal's base), and (K3-bwd) its
//     checkpoint, into a second buffer while the block walks the current
//     segment. The problem's 35 emissions and (RLE) its (4, 51, 51) repeat
//     table are copied once; the 9 transitions sit in registers. A
//     diagonal step reads only shared memory and registers, and computes
//     its next diagonal's input part (emissions, band mask, shifts) before
//     the current recurrence, so its loads overlap the logAdds.
//   * K3-bwd keeps the recomputed segment, (S, 3, W) float32, in shared
//     memory (S is a launch property: the largest S whose block fits the
//     227 KB of shared memory, ops/cuda_banded.py:k3_smem); each lane
//     reads back only its own cells, so no barrier orders it.
//   * Words off the recurrence's path: the backward overwrites each
//     recomputed cell in shared memory with its posteriors; after the
//     segment, each warp walks its own cells and stages the selected ones
//     in shared memory (a ballot per state), with one atomicAdd on the
//     global count per warp when its buffer fills or the segment ends,
//     then writes them out. The contract is unchanged: lo =
//     floor(min(p,1)*1e7) | k << 24, hi = d | (3b+s) << 22, every word
//     counted, words beyond the capacity dropped (the host re-runs K3-bwd
//     with the exact count); word order is free, the host sorts by (tag,
//     x, y).
// The block, the staging, the exchange and the diagonal step live in
// banded_step.cuh and the per-cell arithmetic in banded_cell.cuh, both
// shared with K2, so every cell equals K2's bit for bit; built with
// --fmad=false.
#include "banded_step.cuh"

using namespace margin;

namespace {

// Shared-memory layout of a K3 block, in bytes; ops/cuda_banded.py:k3_smem
// mirrors it. A staging buffer carries, K3-bwd, the segment's checkpoint
// (6W floats); the block's tail holds, K3-bwd, the recomputed (S, 3, W)
// segment and then the staged words.
__host__ __device__ inline Layout k3_layout(int W, int S, bool rle,
                                            bool bwd) {
  return layout(W, S, rle, bwd ? 6 * W * 4 : 0,
                bwd ? S * 3 * W * 4 + WORDS_PER_BLOCK * 8 : 0);
}

// ---------------------------------------------------------------------------
// the kernels: one block of NW = max(W, 32) / 32 warps per problem, lane
// k = threadIdx.x holding band cell k
// ---------------------------------------------------------------------------

template <bool LUT, bool RLE, int NW>
__global__ void __launch_bounds__(32 * NW)
    k3_fwd_kernel(BandArgs a, const int64_t* seg_off, float* ckpt,
                  float* totals, int W, int S) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout L = k3_layout(W, S, RLE, false);
  const int b = blockIdx.x;
  const int k = threadIdx.x;
  const Ctx c = context(a, b, W);
  const Smem sm = smem_of(smem, L);
  float tr[9];
  load_block_tables<RLE>(a, b, (float*)(smem + L.tabs), (float*)(smem + L.rep),
                         tr);
  float* ck = ckpt + seg_off[b] * 6 * W;
  const int n_seg = c.D / S + 1;
  unsigned char* const buf0 = smem + L.stage0;  // staging buffers i & 1
  Win cur = stage_fwd<RLE>(a, c, L, buf0, 0, min(S, c.D + 1), c.xmy[0]);
  int step = 0;
  Diag p1, p2;
  set_zero(p2);
  for (int seg = 0; seg < n_seg; ++seg) {
    cp_wait_all();
    __syncthreads();
    const Stage st = stage_at(buf0 + (seg & 1) * L.stage, L);
    const int d0 = seg * S, d1 = min(d0 + S, c.D + 1);
    Win nxt = cur;
    if (seg + 1 < n_seg)  // the next segment's inputs, while this one runs
      nxt = stage_fwd<RLE>(a, c, L, buf0 + ((seg + 1) & 1) * L.stage, d1,
                           min(d1 + S, c.D + 1), st.xm[d1 - cur.gl]);
    float* cks = ck + (size_t)seg * 6 * W;
    int g = d0;
    if (seg == 0) {  // diagonal 0: the start weights at k = 0
      init_diag(a, b, k, p1);
      link<NW>(p1, sm.xch, step);
      g = 1;
    }
    // the carry into this segment (segment 0: nothing before it)
    store_row(cks, W, k, seg == 0 ? p2 : p1);
    store_row(cks + 3 * W, W, k, p2);
    if (g < d1) {
      Inputs nx = fwd_inputs<RLE>(sm, st, cur, c, g, k);
      for (; g < d1; ++g) {
        const Inputs in = nx;
        nx = fwd_inputs<RLE>(sm, st, cur, c, min(g + 1, d1 - 1), k);
        Diag nd;
        fwd_step<LUT, NW>(sm, tr, in, p1, p2, nd, step);
        p2 = p1;
        p1 = nd;
      }
    }
    cur = nxt;
  }
  // the total at the final corner, from diagonal D
  if (k == c.kf)
    totals[b] = corner_value<LUT>(a.end_w + b * 3, p1.v[0], p1.v[1], p1.v[2]);
}

template <bool LUT, bool RLE, int NW>
__global__ void __launch_bounds__(32 * NW)
    k3_bwd_kernel(BandArgs a, const int64_t* seg_off, const float* ckpt,
                  const float* totals, float threshold, int* count,
                  int* lo_buf, int* hi_buf, int cap, int W, int S) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout L = k3_layout(W, S, RLE, true);
  const int b = blockIdx.x;
  const int k = threadIdx.x;
  const int warp = k >> 5;
  const Ctx c = context(a, b, W);
  const Smem sm = smem_of(smem, L);
  float tr[9];
  load_block_tables<RLE>(a, b, (float*)(smem + L.tabs), (float*)(smem + L.rep),
                         tr);
  float end_w[3];
#pragma unroll
  for (int s = 0; s < 3; ++s) end_w[s] = a.end_w[b * 3 + s];
  const float total = totals[b];
  const float* ck = ckpt + seg_off[b] * 6 * W;
  float* blk = (float*)(smem + L.tail);
  constexpr int WCAP = WORDS_PER_BLOCK / NW;
  int2* wbuf = (int2*)(smem + L.tail + S * 3 * W * 4) + warp * WCAP;
  int wc = 0;
  const int n_seg = c.D / S + 1;
  unsigned char* const buf0 = smem + L.stage0;  // staging buffers i & 1
  const int last0 = (n_seg - 1) * S;
  Win cur = stage_bwd<RLE>(a, c, L, buf0, last0, c.D + 1, c.xmy[c.D],
                           n_seg > 1 ? ck + (size_t)(n_seg - 1) * 6 * W
                                     : nullptr,
                           6 * W);
  int step = 0;
  Diag n1, n2;  // diagonals D+1 and D+2 are empty
  set_zero(n1);
  set_zero(n2);
  for (int seg = n_seg - 1; seg >= 0; --seg) {
    cp_wait_all();
    __syncthreads();
    const Stage st = stage_at(buf0 + ((n_seg - 1 - seg) & 1) * L.stage, L);
    const int d0 = seg * S, d1 = min(d0 + S, c.D + 1);
    Win nxt = cur;
    if (seg > 0)  // the previous segment's inputs, while this one runs
      nxt = stage_bwd<RLE>(a, c, L, buf0 + ((n_seg - seg) & 1) * L.stage,
                           d0 - S, d0, st.xm[d0 - 1 - cur.gl],
                           seg > 1 ? ck + (size_t)(seg - 1) * 6 * W
                                   : nullptr,
                           6 * W);
    // recompute the segment's forward into blk
    Diag p1, p2;
    int g = d0;
    if (seg == 0) {
      init_diag(a, b, k, p1);
      set_zero(p2);
      link<NW>(p1, sm.xch, step);
      store_row(blk, W, k, p1);
      g = 1;
    } else {
      load_row(st.rows, W, k, p1);
      load_row(st.rows + 3 * W, W, k, p2);
      link<NW>(p1, sm.xch, step);
      link<NW>(p2, sm.xch, step);
    }
    if (g < d1) {
      Inputs nx = fwd_inputs<RLE>(sm, st, cur, c, g, k);
      for (; g < d1; ++g) {
        const Inputs in = nx;
        nx = fwd_inputs<RLE>(sm, st, cur, c, min(g + 1, d1 - 1), k);
        Diag nd;
        fwd_step<LUT, NW>(sm, tr, in, p1, p2, nd, step);
        store_row(blk + (size_t)(g - d0) * 3 * W, W, k, nd);
        p2 = p1;
        p1 = nd;
      }
    }
    // backward and posteriors through the segment: each lane overwrites
    // its forward cell in blk with its posteriors
    Inputs nx = bwd_inputs<RLE>(sm, st, cur, c, d1 - 1, k);
    for (g = d1 - 1; g >= d0; --g) {
      const Inputs in = nx;
      nx = bwd_inputs<RLE>(sm, st, cur, c, max(g - 1, d0), k);
      Diag nd;
      bwd_step<LUT, NW>(sm, tr, in, g == c.D, end_w, k == c.kf, n1, n2, nd,
                        step);
      float* row = blk + (size_t)(g - d0) * 3 * W;
      Diag f;
      load_row(row, W, k, f);
#pragma unroll
      for (int s = 0; s < 3; ++s)
        f.v[s] = posterior(in.vm, f.v[s], nd.v[s], total);
      store_row(row, W, k, f);
      n2 = n1;
      n1 = nd;
    }
    // the segment's words, off the recurrence's path: each warp walks its
    // own cells' posteriors, a ballot per state
    for (g = d0; g < d1; ++g) {
      Diag q;
      load_row(blk + (size_t)(g - d0) * 3 * W, W, k, q);
      const int xm = st.xm[g - cur.gl];
      stage_words(q.v, x_base_of(g, xm) + 1 + k > 0,
                  y_base_of(g, xm) + 1 - k > 0, k, W, threshold, g, b, wbuf,
                  wc);
      if (wc > WCAP - 3 * 32) flush_words(wbuf, wc, count, lo_buf, hi_buf, cap);
    }
    flush_words(wbuf, wc, count, lo_buf, hi_buf, cap);
    cur = nxt;
  }
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

template <bool LUT, bool RLE, int NW>
int launch_fwd(const BandArgs& a, void** q, int B, int W, int S, int smem,
               cudaStream_t st) {
  auto kern = k3_fwd_kernel<LUT, RLE, NW>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  kern<<<B, 32 * NW, smem, st>>>(a, (const int64_t*)q[0], (float*)q[1],
                                 (float*)q[2], W, S);
  return (int)cudaGetLastError();
}

template <bool LUT, bool RLE, int NW>
int launch_bwd(const BandArgs& a, void** q, float threshold, int cap, int B,
               int W, int S, int smem, cudaStream_t st) {
  auto kern = k3_bwd_kernel<LUT, RLE, NW>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  kern<<<B, 32 * NW, smem, st>>>(a, (const int64_t*)q[0], (const float*)q[1],
                                 (const float*)q[2], threshold, (int*)q[3],
                                 (int*)q[4], (int*)q[5], cap, W, S);
  return (int)cudaGetLastError();
}

template <bool LUT, bool RLE>
int forward_block(const BandArgs& a, void** q, int B, int W, int S, int smem,
                  cudaStream_t st) {
  BLOCK_OF_WIDTH(launch_fwd, a, q, B, W, S, smem, st)
}

template <bool LUT, bool RLE>
int backward_block(const BandArgs& a, void** q, float threshold, int cap,
                   int B, int W, int S, int smem, cudaStream_t st) {
  BLOCK_OF_WIDTH(launch_bwd, a, q, threshold, cap, B, W, S, smem, st)
}

}  // namespace

// Shared-memory bytes of a K3 block (bwd = 0: K3-fwd, 1: K3-bwd).
extern "C" int k3_smem_bytes(int W, int S, int rle, int bwd) {
  return k3_layout(W, S, rle != 0, bwd != 0).total;
}

// ptrs: the 18 BandArgs pointers in field order (rep_* may be null), then
// seg_off, ckpt, totals; smem: the block's shared-memory bytes, at least
// k3_smem_bytes(W, S, rle, 0).
extern "C" int k3_forward(void** ptrs, int B, int W, int S, int use_lut,
                          int smem, void* stream) {
  if (B == 0) return 0;
  const BandArgs a = band_args(ptrs);
  const bool rle = a.rep_x != nullptr;
  if (S < 2 || smem < k3_layout(W, S, rle, false).total)
    return (int)cudaErrorInvalidValue;
  void** q = ptrs + BAND_ARGS_N;
  cudaStream_t st = (cudaStream_t)stream;
  if (use_lut)
    return rle ? forward_block<true, true>(a, q, B, W, S, smem, st)
               : forward_block<true, false>(a, q, B, W, S, smem, st);
  return rle ? forward_block<false, true>(a, q, B, W, S, smem, st)
             : forward_block<false, false>(a, q, B, W, S, smem, st);
}

// ptrs: the 18 BandArgs pointers, then seg_off, ckpt, totals, count, lo,
// hi; smem at least k3_smem_bytes(W, S, rle, 1).
extern "C" int k3_backward(void** ptrs, int B, int W, int S, int use_lut,
                           int smem, float threshold, int cap, void* stream) {
  if (B == 0) return 0;
  const BandArgs a = band_args(ptrs);
  const bool rle = a.rep_x != nullptr;
  if (S < 2 || smem < k3_layout(W, S, rle, true).total)
    return (int)cudaErrorInvalidValue;
  void** q = ptrs + BAND_ARGS_N;
  cudaStream_t st = (cudaStream_t)stream;
  if (use_lut)
    return rle ? backward_block<true, true>(a, q, threshold, cap, B, W, S,
                                            smem, st)
               : backward_block<true, false>(a, q, threshold, cap, B, W, S,
                                             smem, st);
  return rle ? backward_block<false, true>(a, q, threshold, cap, B, W, S,
                                           smem, st)
             : backward_block<false, false>(a, q, threshold, cap, B, W, S,
                                            smem, st);
}
