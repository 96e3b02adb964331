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
// The per-cell arithmetic is banded_cell.cuh's input and recurrence parts,
// shared with K2, so every cell equals K2's bit for bit; built with
// --fmad=false.
#include "banded_cell.cuh"

using namespace margin;

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int MAX_NW = 4;              // warps of a block
constexpr int WORDS_PER_BLOCK = 1024;  // extraction words staged per block
constexpr int REP_BYTES = 4 * REP_N * REP_N * 4;

__host__ __device__ inline int round_up(int v, int m) {
  return (v + m - 1) / m * m;
}

// Shared-memory layout of a block, in bytes; ops/cuda_banded.py:k3_smem
// mirrors it. Two staging buffers, each: geometry (3 x G ints), the x and
// y symbol windows (XB bytes each), the x and y run-length windows (RW
// ints each, RLE only), the checkpoint (6W floats, K3-bwd only).
struct Layout {
  int G, XB, RW;
  int geo, xs, ys, rx, ry, ck, stage;  // within a staging buffer
  int rep, tabs, stage0, blk, words, xch, total;
};

__host__ __device__ inline Layout layout(int W, int S, bool rle, bool bwd) {
  Layout L;
  L.G = S + 4;
  L.XB = round_up(S + W + 8, 16);
  L.RW = round_up(S + W + 4, 4);
  int o = 0;
  L.geo = o;
  o += round_up(3 * 4 * L.G, 16);
  L.xs = o;
  o += L.XB;
  L.ys = o;
  o += L.XB;
  L.rx = o;
  if (rle) o += 4 * L.RW;
  L.ry = o;
  if (rle) o += 4 * L.RW;
  L.ck = o;
  if (bwd) o += 6 * W * 4;
  L.stage = o;
  o = 0;
  L.rep = o;
  if (rle) o += REP_BYTES;
  L.tabs = o;
  o += 36 * 4;
  L.stage0 = o;
  o += 2 * L.stage;
  L.blk = o;
  if (bwd) o += S * 3 * W * 4;
  L.words = o;
  if (bwd) o += WORDS_PER_BLOCK * 8;
  L.xch = o;
  o += 2 * MAX_NW * 2 * 3 * 4;
  L.total = o;
  return L;
}

// ---------------------------------------------------------------------------
// asynchronous copies into shared memory
// ---------------------------------------------------------------------------

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// ---------------------------------------------------------------------------
// a block's problem, tables and staged segments
// ---------------------------------------------------------------------------

struct Ctx {
  int b, lx, ly, D, W, kf;
  int64_t x_off, y_off;
  const int* xmy;
  const int* wid;
  const int* klo;
};

__device__ __forceinline__ Ctx context(const BandArgs& a, int b, int W) {
  Ctx c;
  c.b = b;
  c.lx = a.lxs[b];
  c.ly = a.lys[b];
  c.D = c.lx + c.ly;
  c.W = W;
  c.kf = a.k_final[b];
  c.x_off = a.x_off[b];
  c.y_off = a.y_off[b];
  const int64_t g0 = a.geo_off[b];
  c.xmy = a.xmy + g0;
  c.wid = a.width + g0;
  c.klo = a.klo + g0;
  return c;
}

// One staging buffer's arrays.
struct Stage {
  const int* xm;
  const int* wd;
  const int* kl;
  const uint8_t* xs;
  const uint8_t* ys;
  const int* rx;
  const int* ry;
  const float* ck;
};

__device__ __forceinline__ Stage stage_at(unsigned char* base,
                                          const Layout& L) {
  Stage s;
  s.xm = (const int*)(base + L.geo);
  s.wd = s.xm + L.G;
  s.kl = s.wd + L.G;
  s.xs = base + L.xs;
  s.ys = base + L.ys;
  s.rx = (const int*)(base + L.rx);
  s.ry = (const int*)(base + L.ry);
  s.ck = (const float*)(base + L.ck);
  return s;
}

// Where a staged segment's data sit: geometry slot i is diagonal gl + i;
// x index ix's symbol is xs[ix + xsb], its run length rx[ix + xrb]; the
// same for y.
struct Win {
  int gl, xsb, ysb, xrb, yrb;
};

// Copy one window [lo, hi) of a problem's flat byte symbols (from its
// offset off) and (RLE) run lengths; the byte copy starts at the 4-byte
// boundary at or below, and may read up to 3 bytes past the end of the
// sequence (ops/cuda_banded.py pads the flat arrays). Returns (symbol
// offset, run-length offset) of index 0.
template <bool RLE>
__device__ __forceinline__ int2 stage_window(const uint8_t* sym,
                                             const int* run, int64_t off,
                                             int lo, int hi, int len,
                                             uint8_t* sdst, int* rdst) {
  lo = max(lo, 0);
  hi = min(hi, len);
  if (hi <= lo) return make_int2(0, 0);
  const int t = threadIdx.x, nt = blockDim.x;
  const int64_t f0 = (off + lo) & ~(int64_t)3;
  const int nw = (int)((off + hi - f0 + 3) >> 2);
  for (int i = t; i < nw; i += nt) cp_async4(sdst + 4 * i, sym + f0 + 4 * i);
  if (RLE)
    for (int i = t; i < hi - lo; i += nt)
      cp_async4(rdst + i, run + off + lo + i);
  return make_int2((int)(off - f0), -lo);
}

// Stage segment [d0, d1) into buffer `base`: geometry rows [d0-2, d1+2)
// of the problem, the x and y index windows [xlo, xhi), [ylo, yhi), and
// (ck != null) its checkpoint; one commit group.
template <bool RLE>
__device__ __forceinline__ Win stage_segment(const BandArgs& a, const Ctx& c,
                                             const Layout& L,
                                             unsigned char* base, int d0,
                                             int d1, int xlo, int xhi,
                                             int ylo, int yhi,
                                             const float* ck) {
  const int t = threadIdx.x, nt = blockDim.x;
  Win w;
  w.gl = d0 - 2;
  int* gx = (int*)(base + L.geo);
  const int g_hi = min(d1 + 2, c.D + 1);
  for (int g = max(d0 - 2, 0) + t; g < g_hi; g += nt) {
    const int i = g - w.gl;
    cp_async4(gx + i, c.xmy + g);
    cp_async4(gx + L.G + i, c.wid + g);
    cp_async4(gx + 2 * L.G + i, c.klo + g);
  }
  const int2 xo = stage_window<RLE>(a.xs, a.rep_x, c.x_off, xlo, xhi, c.lx,
                                    base + L.xs, (int*)(base + L.rx));
  const int2 yo = stage_window<RLE>(a.ys, a.rep_y, c.y_off, ylo, yhi, c.ly,
                                    base + L.ys, (int*)(base + L.ry));
  w.xsb = xo.x;
  w.xrb = xo.y;
  w.ysb = yo.x;
  w.yrb = yo.y;
  if (ck != nullptr)
    for (int i = t; i < 6 * c.W / 4; i += nt)
      cp_async16(base + L.ck + 16 * i, ck + 4 * i);
  cp_commit();
  return w;
}

// The windows of a forward segment [d0, d1) from its first diagonal's
// base xm (x_base and y_base rise by 0 or 1 a diagonal): the forward at g
// consumes x in [xb(g), xb(g)+W) and y in (yb(g)-W, yb(g)].
template <bool RLE>
__device__ __forceinline__ Win stage_fwd(const BandArgs& a, const Ctx& c,
                                         const Layout& L, unsigned char* base,
                                         int d0, int d1, int xm) {
  const int n = d1 - d0;
  const int xb = x_base_of(d0, xm), yb = y_base_of(d0, xm);
  return stage_segment<RLE>(a, c, L, base, d0, d1, xb, xb + n + c.W,
                            yb - c.W + 1, yb + n, nullptr);
}

// The windows of a backward segment [d0, d1) from its last diagonal's
// base xm: the forward consumes as above, the backward at g x in
// (xb(g), xb(g)+W] and y in (yb(g)-W+1, yb(g)+1].
template <bool RLE>
__device__ __forceinline__ Win stage_bwd(const BandArgs& a, const Ctx& c,
                                         const Layout& L, unsigned char* base,
                                         int d0, int d1, int xm,
                                         const float* ck) {
  const int n = d1 - d0, h = d1 - 1;
  const int xb = x_base_of(h, xm), yb = y_base_of(h, xm);
  return stage_segment<RLE>(a, c, L, base, d0, d1, xb - n + 1, xb + c.W + 1,
                            yb - n - c.W + 2, yb + 2, ck);
}

// The problem's emissions into shared memory and (RLE) its repeat table
// by cp.async (in the first commit group); its transitions into registers.
template <bool RLE>
__device__ __forceinline__ void load_block_tables(const BandArgs& a, int b,
                                                  float* tabs, float* rep,
                                                  float tr[9]) {
  const int t = threadIdx.x, nt = blockDim.x;
  for (int i = t; i < 35; i += nt) tabs[i] = a.tabs[b * 35 + i];
  if (RLE) {
    const float* src = a.rep_tab + (size_t)b * 4 * REP_N * REP_N;
    for (int i = t; i < REP_BYTES / 16; i += nt)
      cp_async16(rep + 4 * i, src + 4 * i);
  }
#pragma unroll
  for (int i = 0; i < 9; ++i) tr[i] = a.trans[b * 9 + i];
}

// ---------------------------------------------------------------------------
// diagonals in registers
// ---------------------------------------------------------------------------

// A lane's cell k of one diagonal (v[state]) and the cells k-1 (l) and
// k+1 (r).
struct Diag {
  float v[3], l[3], r[3];
};

__device__ __forceinline__ void set_zero(Diag& d) {
#pragma unroll
  for (int s = 0; s < 3; ++s) d.v[s] = d.l[s] = d.r[s] = LOG_ZERO_F;
}

// The value of state s at k + off, off in {-1, 0, 1}.
__device__ __forceinline__ float nb(const Diag& d, int s, int off) {
  return off < 0 ? d.l[s] : (off > 0 ? d.r[s] : d.v[s]);
}

template <int NW>
__device__ __forceinline__ void warps_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(32 * NW) : "memory");
}

// Fill d.l / d.r from the neighbouring lanes and, at a warp's edge, from
// the neighbouring warps (LOG_ZERO beyond the band storage). xch: two
// slots of (NW, 2 edges, 3 states), alternating by step, so one barrier
// a diagonal orders both the writes and the reads.
template <int NW>
__device__ __forceinline__ void link(Diag& d, float* xch, int& step) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int s = 0; s < 3; ++s) {
    d.l[s] = __shfl_up_sync(FULL, d.v[s], 1);
    d.r[s] = __shfl_down_sync(FULL, d.v[s], 1);
  }
  if (NW > 1) {
    const int w = threadIdx.x >> 5;
    float* x = xch + (step & 1) * (NW * 6);
    if (lane == 0)
      for (int s = 0; s < 3; ++s) x[w * 6 + s] = d.v[s];
    if (lane == 31)
      for (int s = 0; s < 3; ++s) x[w * 6 + 3 + s] = d.v[s];
    warps_sync<NW>();
    if (lane == 0)
      for (int s = 0; s < 3; ++s)
        d.l[s] = w > 0 ? x[(w - 1) * 6 + 3 + s] : LOG_ZERO_F;
    if (lane == 31)
      for (int s = 0; s < 3; ++s)
        d.r[s] = w < NW - 1 ? x[(w + 1) * 6 + s] : LOG_ZERO_F;
    ++step;
  } else {
    if (lane == 0)
      for (int s = 0; s < 3; ++s) d.l[s] = LOG_ZERO_F;
    if (lane == 31)
      for (int s = 0; s < 3; ++s) d.r[s] = LOG_ZERO_F;
  }
}

// a diagonal row (3, W) in shared or device memory <-> a lane's cell
// (LOG_ZERO beyond W)
__device__ __forceinline__ void load_row(const float* row, int W, int k,
                                         Diag& d) {
#pragma unroll
  for (int s = 0; s < 3; ++s) d.v[s] = k < W ? row[s * W + k] : LOG_ZERO_F;
}
__device__ __forceinline__ void store_row(float* row, int W, int k,
                                          const Diag& d) {
  if (k < W)
#pragma unroll
    for (int s = 0; s < 3; ++s) row[s * W + k] = d.v[s];
}

// ---------------------------------------------------------------------------
// one diagonal step: the input part (from the staged segment) and the
// recurrence
// ---------------------------------------------------------------------------

struct Smem {
  const float* tabs;
  const float* rep;
  float* xch;
};

template <bool RLE>
__device__ __forceinline__ Emis staged_emissions(const Smem& sm,
                                                 const Stage& st,
                                                 const Win& w, const Ctx& c,
                                                 int ix, int iy, bool kin) {
  Cell cs;
  const bool inx = kin && ix >= 0 && ix < c.lx;
  const bool iny = kin && iy >= 0 && iy < c.ly;
  cs.sx = inx ? st.xs[ix + w.xsb] : 4;
  cs.sy = iny ? st.ys[iy + w.ysb] : 4;
  cs.rx = (RLE && inx) ? st.rx[ix + w.xrb] : 0;
  cs.ry = (RLE && iny) ? st.ry[iy + w.yrb] : 0;
  return emissions<RLE>(sm.tabs, sm.rep, cs);
}

// The input part of a lane's cell on diagonal g: band mask, emissions,
// shifts (forward: s1, s2; backward: t1, t2).
struct Inputs {
  Emis e;
  bool vm;
  int sa, sb;
};

template <bool RLE>
__device__ __forceinline__ Inputs fwd_inputs(const Smem& sm, const Stage& st,
                                             const Win& w, const Ctx& c,
                                             int g, int k) {
  Inputs in;
  const int i = g - w.gl;
  const int xm = st.xm[i];
  const int xm2 = g >= 2 ? st.xm[i - 2] : 0;
  in.sa = fwd_s1(xm, st.xm[i - 1]);
  in.sb = fwd_s2(g, xm, xm2);
  const int xb = x_base_of(g, xm), yb = y_base_of(g, xm);
  in.vm = band_cell(g, xm, st.kl[i], st.wd[i], k, c.lx, c.ly);
  in.e = staged_emissions<RLE>(sm, st, w, c, xb + k, yb - k, k < c.W);
  return in;
}

template <bool RLE>
__device__ __forceinline__ Inputs bwd_inputs(const Smem& sm, const Stage& st,
                                             const Win& w, const Ctx& c,
                                             int g, int k) {
  Inputs in;
  const int i = g - w.gl;
  const int xm = st.xm[i];
  const bool has2 = g + 2 <= c.D;
  const int xn2 = has2 ? st.xm[i + 2] : 0;
  in.sa = bwd_t1(xm, st.xm[i + 1]);
  in.sb = bwd_t2(has2, xm, xn2);
  const int xb = x_base_of(g, xm), yb = y_base_of(g, xm);
  in.vm = band_cell(g, xm, st.kl[i], st.wd[i], k, c.lx, c.ly);
  in.e = staged_emissions<RLE>(sm, st, w, c, xb + k + 1, yb + 1 - k,
                               k < c.W);
  return in;
}

// Forward diagonal g >= 1 from p1 (g-1) and p2 (g-2).
template <bool LUT, int NW>
__device__ __forceinline__ void fwd_step(const Smem& sm, const float* tr,
                                         const Inputs& in, const Diag& p1,
                                         const Diag& p2, Diag& out,
                                         int& step) {
  float l[3], d[3], u[3], o[3];
#pragma unroll
  for (int s = 0; s < 3; ++s) {
    l[s] = nb(p1, s, in.sa);
    u[s] = nb(p1, s, in.sa + 1);
    d[s] = nb(p2, s, in.sb);
  }
  forward_recurrence<LUT>(tr, in.e, l, d, u, o);
#pragma unroll
  for (int s = 0; s < 3; ++s) out.v[s] = in.vm ? o[s] : LOG_ZERO_F;
  link<NW>(out, sm.xch, step);
}

// Backward diagonal g from n1 (g+1) and n2 (g+2); the final diagonal
// carries the end weights at k_final.
template <bool LUT, int NW>
__device__ __forceinline__ void bwd_step(const Smem& sm, const float* tr,
                                         const Inputs& in, bool final_diag,
                                         const float* end_w, bool at_kf,
                                         const Diag& n1, const Diag& n2,
                                         Diag& out, int& step) {
  float o[3];
  backward_recurrence<LUT>(tr, in.e, nb(n1, 1, in.sa), nb(n2, 0, in.sb),
                           nb(n1, 2, in.sa - 1), o);
#pragma unroll
  for (int s = 0; s < 3; ++s)
    out.v[s] = final_diag ? (at_kf ? end_w[s] : LOG_ZERO_F)
                          : (in.vm ? o[s] : LOG_ZERO_F);
  link<NW>(out, sm.xch, step);
}

// Write a warp's staged words out: one atomicAdd reserves their places.
// wc is uniform across the warp.
__device__ __forceinline__ void flush_words(const int2* wbuf, int& wc,
                                            int* count, int* lo_buf,
                                            int* hi_buf, int cap) {
  const int lane = threadIdx.x & 31;
  __syncwarp();
  if (wc > 0) {
    int base = 0;
    if (lane == 0) base = atomicAdd(count, wc);
    base = __shfl_sync(FULL, base, 0);
    for (int i = lane; i < wc; i += 32) {
      const int idx = base + i;
      if (idx < cap) {
        const int2 v = wbuf[i];
        lo_buf[idx] = v.x;
        hi_buf[idx] = v.y;
      }
    }
    wc = 0;
  }
  __syncwarp();
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
  const Layout L = layout(W, S, RLE, false);
  const int b = blockIdx.x;
  const int k = threadIdx.x;
  const Ctx c = context(a, b, W);
  Smem sm;
  sm.tabs = (const float*)(smem + L.tabs);
  sm.rep = (const float*)(smem + L.rep);
  sm.xch = (float*)(smem + L.xch);
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
#pragma unroll
      for (int s = 0; s < 3; ++s)
        p1.v[s] = k == 0 ? a.init[b * 3 + s] : LOG_ZERO_F;
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
  const Layout L = layout(W, S, RLE, true);
  const int b = blockIdx.x;
  const int k = threadIdx.x;
  const int lane = k & 31, warp = k >> 5;
  const Ctx c = context(a, b, W);
  Smem sm;
  sm.tabs = (const float*)(smem + L.tabs);
  sm.rep = (const float*)(smem + L.rep);
  sm.xch = (float*)(smem + L.xch);
  float tr[9];
  load_block_tables<RLE>(a, b, (float*)(smem + L.tabs), (float*)(smem + L.rep),
                         tr);
  float end_w[3];
#pragma unroll
  for (int s = 0; s < 3; ++s) end_w[s] = a.end_w[b * 3 + s];
  const float total = totals[b];
  const float* ck = ckpt + seg_off[b] * 6 * W;
  float* blk = (float*)(smem + L.blk);
  constexpr int WCAP = WORDS_PER_BLOCK / NW;
  int2* wbuf = (int2*)(smem + L.words) + warp * WCAP;
  int wc = 0;
  const unsigned below = (1u << lane) - 1u;
  const int n_seg = c.D / S + 1;
  unsigned char* const buf0 = smem + L.stage0;  // staging buffers i & 1
  const int last0 = (n_seg - 1) * S;
  Win cur = stage_bwd<RLE>(a, c, L, buf0, last0, c.D + 1, c.xmy[c.D],
                           n_seg > 1 ? ck + (size_t)(n_seg - 1) * 6 * W
                                     : nullptr);
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
                                   : nullptr);
    // recompute the segment's forward into blk
    Diag p1, p2;
    int g = d0;
    if (seg == 0) {
#pragma unroll
      for (int s = 0; s < 3; ++s)
        p1.v[s] = k == 0 ? a.init[b * 3 + s] : LOG_ZERO_F;
      set_zero(p2);
      link<NW>(p1, sm.xch, step);
      store_row(blk, W, k, p1);
      g = 1;
    } else {
      load_row(st.ck, W, k, p1);
      load_row(st.ck + 3 * W, W, k, p2);
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
      const bool x_ok = x_base_of(g, xm) + 1 + k > 0;
      const bool y_ok = y_base_of(g, xm) + 1 - k > 0;
#pragma unroll
      for (int s = 0; s < 3; ++s) {
        const bool need = s == 0 ? x_ok && y_ok : s == 1 ? x_ok : y_ok;
        const float p = q.v[s];
        const bool sel = p >= threshold && need && k < W;
        const unsigned m = __ballot_sync(FULL, sel);
        if (sel)
          wbuf[wc + __popc(m & below)] = make_int2(
              (int)floorf(fminf(p, 1.0f) * 10000000.0f) | (k << 24),
              g | ((3 * b + s) << 22));
        wc += __popc(m);
      }
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

// The block of a width: NW = max(W, 32) / 32 warps.
#define K3_BLOCK(LAUNCH, ...)                                 \
  if (W == 16 || W == 32) return LAUNCH<LUT, RLE, 1>(__VA_ARGS__); \
  if (W == 64) return LAUNCH<LUT, RLE, 2>(__VA_ARGS__);            \
  if (W == 128) return LAUNCH<LUT, RLE, 4>(__VA_ARGS__);           \
  return (int)cudaErrorInvalidValue;

template <bool LUT, bool RLE>
int forward_block(const BandArgs& a, void** q, int B, int W, int S, int smem,
                  cudaStream_t st) {
  K3_BLOCK(launch_fwd, a, q, B, W, S, smem, st)
}

template <bool LUT, bool RLE>
int backward_block(const BandArgs& a, void** q, float threshold, int cap,
                   int B, int W, int S, int smem, cudaStream_t st) {
  K3_BLOCK(launch_bwd, a, q, threshold, cap, B, W, S, smem, st)
}

}  // namespace

// Shared-memory bytes of a K3 block (bwd = 0: K3-fwd, 1: K3-bwd).
extern "C" int k3_smem_bytes(int W, int S, int rle, int bwd) {
  return layout(W, S, rle != 0, bwd != 0).total;
}

// ptrs: the 18 BandArgs pointers in field order (rep_* may be null), then
// seg_off, ckpt, totals; smem: the block's shared-memory bytes, at least
// k3_smem_bytes(W, S, rle, 0).
extern "C" int k3_forward(void** ptrs, int B, int W, int S, int use_lut,
                          int smem, void* stream) {
  if (B == 0) return 0;
  const BandArgs a = band_args(ptrs);
  const bool rle = a.rep_x != nullptr;
  if (S < 2 || smem < layout(W, S, rle, false).total)
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
  if (S < 2 || smem < layout(W, S, rle, true).total)
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
