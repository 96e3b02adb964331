// Kernels K2-fwd and K2-bwd: banded 3-state pair-HMM forward, then
// backward + posterior, over a pack of problems, with the forward grid in
// device memory (the kernels are banded_k2.cuh's, instantiated here at
// the width buckets 16..128; banded_wide.cu instantiates the forward and
// EXP at bands of 136..512 cells as K5). K2-bwd has three instances of
// one walk: POST writes the (rows, 3, W) posterior grid; WORDS writes no
// grid and emits every posterior cell at or above a threshold as the
// extraction's two int32 words; EXP (K4) sums the Baum-Welch transition
// expectations of every band cell into a (3, 3) matrix a problem.
//
// Replaces: margin_tpu/ops/pallas_banded.py:_fwd_kernel (:174) and
// _bwd_kernel (:253), launched by _fb_pallas (:390, :426), plus the total
// at (lx+ly, k_final) with the end weights (:401-411); WORDS also the
// XLA extraction margin_tpu/ops/banded.py:_device_extract_flat (:704) /
// _device_extract_packed (:747); K4 the expectations pass of
// margin_tpu/ops/banded.py:_banded_fb_core (:267, compute_expectations
// :478-486, an XLA scan).
//
// What bounds them on this card: the latency of each problem's serial
// walk over its anti-diagonals. The work is ~100 float operations a band
// cell; the bytes are the inputs and the (D, 3, W) float grids, the
// forward's written once, read back once by the backward, and the
// posterior's written once: a few GB/s for a pack. A problem's diagonals
// depend on each other and a pack gives the 132 SMs one block each, so the
// kernel time is the deepest problem's diagonal count times the time of
// one diagonal step, and the step is all there is to cut.
//
// Design: the TPU put the problems on the 128 lanes and walked diagonals
// on a sequential grid. Here each problem gets a block and walks its own
// diagonals 0..lx+ly (a pack needs no padding to a common depth) with the
// segmented kernels' step (banded_step.cuh), less their segment
// recompute:
//   * One block of NW = block_warps(W) warps; lane k holds band cell k,
//     a diagonal's cells stay in registers, the neighbours k-1 and k+1
//     come from warp shuffles and, at a warp's edge, from a two-slot
//     exchange behind a named barrier: no block-wide barrier per
//     diagonal, none at all at W <= 32.
//   * The problem is walked in chunks of C diagonals. cp.async stages the
//     next chunk's geometry (xmy, width, klo), the symbol and run-length
//     windows its cells consume (at most C + W entries of each sequence,
//     bounded from one diagonal's base) and, K2-bwd, its rows of the
//     forward grid (C x 3 x W floats, contiguous in the problem-major
//     grid) into the second of two shared-memory buffers while the block
//     walks the current one; the emissions and the (4, 51, 51) repeat
//     table are copied once. A step reads only registers and shared
//     memory, and computes its next diagonal's input part before the
//     current recurrence; one __syncthreads() a chunk makes the copies
//     visible. C is a property of the launch: the largest chunk whose
//     block fits the 227 KB a block may use (ops/cuda_banded.py:k2_smem
//     mirrors the layout, the same for both sweeps).
//   * Off the chain, K2-fwd writes each diagonal's (3, W) cells into the
//     chunk's rows in shared memory, and one thread copies a finished
//     chunk to the grid with one bulk asynchronous copy (cp.async.bulk)
//     while the block walks the next: on the H100 a direct global store
//     a diagonal cost the forward step up to a third at W = 128 (PERF.md).
//     K2-bwd POST stores each diagonal's posteriors exp(min(f + b -
//     total, 0)) (0 outside the band) to the grid as coalesced stores: its
//     row buffers hold the staged forward rows.
//   * K2-bwd WORDS selects, from each diagonal's posteriors in registers,
//     the cells ops/banded.py:extract_packed selects (>= threshold; x > 0
//     for gapX, y > 0 for gapY, both for a match; a cell outside the band
//     has posterior 0) and stages their words per warp in shared memory
//     with a ballot per state, with one atomicAdd on the count a flush
//     (banded_step.cuh: stage_words, flush_words, as K3-bwd). The words
//     need W <= 128 (k, 7 bits), B <= 128 (3b+s, 9 bits) and d < 2^22;
//     the wrapper checks the pack before the launch. A grid of the phase
//     run's largest pack (126,020 rows at W = 128) is 194 MB written and
//     read back by torch ops without it; the words are a few MB.
// The per-cell arithmetic is banded_cell.cuh's, shared with K3, so every
// cell equals K3's and the plain twins' bit for bit; built with
// --fmad=false.
#include "banded_k2.cuh"

namespace {

template <bool LUT, bool RLE>
int forward_block(const BandArgs& a, void** q, int B, int W, int C, int smem,
                  cudaStream_t st) {
  BLOCK_OF_WIDTH(launch_fwd, a, q, B, W, C, smem, st)
}

template <bool LUT, bool RLE, class K>
int backward_block(const BandArgs& a, void** q, const WordsOut& wo, int B,
                   int W, int C, int smem, cudaStream_t st) {
  BLOCK_OF_WIDTH(K::template launch, a, q, wo, B, W, C, smem, st)
}

template <int OUT>
int backward_entry(void** ptrs, int B, int W, int C, int use_lut, int smem,
                   const WordsOut& wo, void* stream) {
  if (B == 0) return 0;
  const BandArgs a = band_args(ptrs);
  const bool rle = a.rep_x != nullptr;
  if (C < 1 || smem < k2_layout(W, C, rle, OUT == OUT_WORDS).total)
    return (int)cudaErrorInvalidValue;
  void** q = ptrs + BAND_ARGS_N;
  cudaStream_t st = (cudaStream_t)stream;
  using K = Bwd<OUT>;
  if (use_lut)
    return rle ? backward_block<true, true, K>(a, q, wo, B, W, C, smem, st)
               : backward_block<true, false, K>(a, q, wo, B, W, C, smem, st);
  return rle ? backward_block<false, true, K>(a, q, wo, B, W, C, smem, st)
             : backward_block<false, false, K>(a, q, wo, B, W, C, smem, st);
}

}  // namespace

// Shared-memory bytes of a K2 block (K2-fwd's, K2-bwd POST's and K4's are
// alike).
extern "C" int k2_smem_bytes(int W, int C, int rle) {
  return k2_layout(W, C, rle != 0).total;
}

// Shared-memory bytes of a K2-bwd WORDS block.
extern "C" int k2_words_smem_bytes(int W, int C, int rle) {
  return k2_layout(W, C, rle != 0, true).total;
}

// ptrs: the 18 BandArgs pointers in field order (rep_* may be null), then
// fwd, totals; smem: the block's shared-memory bytes, at least
// k2_smem_bytes(W, C, rle).
extern "C" int k2_forward(void** ptrs, int B, int W, int C, int use_lut,
                          int smem, void* stream) {
  if (B == 0) return 0;
  const BandArgs a = band_args(ptrs);
  const bool rle = a.rep_x != nullptr;
  if (C < 1 || smem < k2_layout(W, C, rle).total)
    return (int)cudaErrorInvalidValue;
  void** q = ptrs + BAND_ARGS_N;
  cudaStream_t st = (cudaStream_t)stream;
  if (use_lut)
    return rle ? forward_block<true, true>(a, q, B, W, C, smem, st)
               : forward_block<true, false>(a, q, B, W, C, smem, st);
  return rle ? forward_block<false, true>(a, q, B, W, C, smem, st)
             : forward_block<false, false>(a, q, B, W, C, smem, st);
}

// ptrs: the 18 BandArgs pointers, then fwd, totals, post; smem at least
// k2_smem_bytes(W, C, rle).
extern "C" int k2_backward(void** ptrs, int B, int W, int C, int use_lut,
                           int smem, void* stream) {
  return backward_entry<OUT_POST>(ptrs, B, W, C, use_lut, smem, WordsOut{},
                              stream);
}

// K2-bwd WORDS: ptrs: the 18 BandArgs pointers, then fwd, totals, count
// (1 int, zeroed), lo, hi (cap ints each); smem at least
// k2_words_smem_bytes(W, C, rle). count ends as the number of selected
// cells; the words beyond cap are dropped.
extern "C" int k2_backward_words(void** ptrs, int B, int W, int C,
                                 int use_lut, int smem, float threshold,
                                 int cap, void* stream) {
  void** q = ptrs + BAND_ARGS_N;
  const WordsOut wo{threshold, (int*)q[2], (int*)q[3], (int*)q[4], cap};
  return backward_entry<OUT_WORDS>(ptrs, B, W, C, use_lut, smem, wo, stream);
}

// K4, the transition expectations: ptrs: the 18 BandArgs pointers, then
// fwd, totals, exp (B, 3, 3); smem at least k2_smem_bytes(W, C, rle).
extern "C" int k2_expectations(void** ptrs, int B, int W, int C,
                               int use_lut, int smem, void* stream) {
  return backward_entry<OUT_EXP>(ptrs, B, W, C, use_lut, smem, WordsOut{},
                             stream);
}
