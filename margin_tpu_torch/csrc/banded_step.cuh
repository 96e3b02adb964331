// The diagonal step of the banded pair-HMM forward-backward on Hopper,
// shared by the monolithic kernels K2 (banded_k2.cuh: K2 in banded_fb.cu
// and, for bands of 136-512 cells, K5's step design in banded_wide.cu)
// and the segmented kernels K3 (banded_seg.cu): one block of NW =
// block_warps(W) warps per problem, lane k = threadIdx.x holding band
// cell k (lanes k >= W idle), a diagonal's cells in registers,
// neighbours from warp shuffles and (NW > 1) a two-slot exchange between
// warps behind a named barrier; a problem's inputs are
// staged in shared memory by cp.async one chunk of S diagonals ahead
// (geometry, symbol and run-length windows, and a kernel's own float rows),
// its emissions and repeat table once per block. A step reads only
// registers and shared memory and computes its next diagonal's input part
// before the current recurrence. The per-cell arithmetic is
// banded_cell.cuh's, so K2 and K3 agree bit for bit.
#pragma once

#include "banded_cell.cuh"

namespace margin {

constexpr unsigned FULL = 0xffffffffu;
// the warps whose exchange slots a block holds at least, so that K2's and
// K3's layouts at W <= 128 do not depend on their own warp count
constexpr int XCH_MIN_NW = 4;
constexpr int REP_BYTES = 4 * REP_N * REP_N * 4;

__host__ __device__ inline int round_up(int v, int m) {
  return (v + m - 1) / m * m;
}

// warps of a block at width W: one a 32 band cells (1, 1, 2, 4 at W = 16,
// 32, 64, 128), rounded up to an even count above 128 cells (6..16 for
// K5's widths of 136..512: half the kernel instances of one a count,
// whose banded_wide.cu built in 31-44 s against 24 s on an H100 host,
// PERF.md; a warp beyond W idles)
__host__ __device__ inline int block_warps(int W) {
  return W <= 32 ? 1 : W <= 128 ? (W + 31) / 32 : (W + 63) / 64 * 2;
}

// Shared-memory layout of a block that walks a problem in staged chunks of
// S diagonals, in bytes (ops/cuda_banded.py:k2_smem and k3_smem mirror
// it). Two staging buffers, each: geometry (3 x G ints), the x and y
// symbol windows (XB bytes each), the x and y run-length windows (RW ints
// each, RLE only) and `rows` bytes of float rows (K3-bwd: a checkpoint;
// K2: the chunk's forward rows). Then the block's own: the repeat
// table (RLE), the emissions, the two buffers, `tail` bytes of the
// kernel's own (K3-bwd: the recomputed segment and the staged words) and
// the warps' exchange slots (two of (NW, 2 edges, 3 states) floats, NW at
// least XCH_MIN_NW; K2-bwd EXP's block reduction reuses them, 9 floats a
// warp).
struct Layout {
  int G, XB, RW;
  int geo, xs, ys, rx, ry, rows, stage;  // within a staging buffer
  int rep, tabs, stage0, tail, xch, total;
};

__host__ __device__ inline Layout layout(int W, int S, bool rle, int rows,
                                         int tail) {
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
  L.rows = o;
  o += rows;
  L.stage = o;
  o = 0;
  L.rep = o;
  if (rle) o += REP_BYTES;
  L.tabs = o;
  o += 36 * 4;
  L.stage0 = o;
  o += 2 * L.stage;
  L.tail = o;
  o += tail;
  L.xch = o;
  const int nw = block_warps(W);
  o += 2 * (nw > XCH_MIN_NW ? nw : XCH_MIN_NW) * 2 * 3 * 4;
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

// bulk copies from shared to device memory (the async proxy reads shared
// memory: writers fence before the barrier that precedes the copy)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void bulk_store(void* dst, const void* src,
                                           int bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(src);
  asm volatile(
      "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n"
      "cp.async.bulk.commit_group;\n" ::"l"(dst),
      "r"(s), "r"(bytes)
      : "memory");
}
// wait until every bulk copy of this thread has read its shared memory
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// ---------------------------------------------------------------------------
// a block's problem, tables and staged chunks
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
  const float* rows;
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
  s.rows = (const float*)(base + L.rows);
  return s;
}

// Where a staged chunk's data sit: geometry slot i is diagonal gl + i;
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

// Stage chunk [d0, d1) into buffer `base`: geometry rows [d0-2, d1+2) of
// the problem, the x and y index windows [xlo, xhi), [ylo, yhi), and
// (rows != null) n_rows floats from rows (16-byte aligned, n_rows a
// multiple of 4); one commit group.
template <bool RLE>
__device__ __forceinline__ Win stage_segment(const BandArgs& a, const Ctx& c,
                                             const Layout& L,
                                             unsigned char* base, int d0,
                                             int d1, int xlo, int xhi,
                                             int ylo, int yhi,
                                             const float* rows, int n_rows) {
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
  if (rows != nullptr)
    for (int i = t; i < n_rows / 4; i += nt)
      cp_async16(base + L.rows + 16 * i, rows + 4 * i);
  cp_commit();
  return w;
}

// The windows of a forward chunk [d0, d1) from its first diagonal's base
// xm (x_base and y_base rise by 0 or 1 a diagonal): the forward at g
// consumes x in [xb(g), xb(g)+W) and y in (yb(g)-W, yb(g)].
template <bool RLE>
__device__ __forceinline__ Win stage_fwd(const BandArgs& a, const Ctx& c,
                                         const Layout& L, unsigned char* base,
                                         int d0, int d1, int xm) {
  const int n = d1 - d0;
  const int xb = x_base_of(d0, xm), yb = y_base_of(d0, xm);
  return stage_segment<RLE>(a, c, L, base, d0, d1, xb, xb + n + c.W,
                            yb - c.W + 1, yb + n, nullptr, 0);
}

// The windows of a backward chunk [d0, d1) from its last diagonal's base
// xm: the forward consumes as above, the backward at g x in (xb(g),
// xb(g)+W] and y in (yb(g)-W+1, yb(g)+1]; with n_rows floats from rows.
template <bool RLE>
__device__ __forceinline__ Win stage_bwd(const BandArgs& a, const Ctx& c,
                                         const Layout& L, unsigned char* base,
                                         int d0, int d1, int xm,
                                         const float* rows, int n_rows) {
  const int n = d1 - d0, h = d1 - 1;
  const int xb = x_base_of(h, xm), yb = y_base_of(h, xm);
  return stage_segment<RLE>(a, c, L, base, d0, d1, xb - n + 1, xb + c.W + 1,
                            yb - n - c.W + 2, yb + 2, rows, n_rows);
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

// diagonal 0: the start weights at k = 0 (stateMachine.c:521-530)
__device__ __forceinline__ void init_diag(const BandArgs& a, int b, int k,
                                          Diag& d) {
#pragma unroll
  for (int s = 0; s < 3; ++s) d.v[s] = k == 0 ? a.init[b * 3 + s] : LOG_ZERO_F;
}

// ---------------------------------------------------------------------------
// one diagonal step: the input part (from the staged chunk) and the
// recurrence
// ---------------------------------------------------------------------------

struct Smem {
  const float* tabs;
  const float* rep;
  float* xch;
};

__device__ __forceinline__ Smem smem_of(unsigned char* smem,
                                        const Layout& L) {
  Smem sm;
  sm.tabs = (const float*)(smem + L.tabs);
  sm.rep = (const float*)(smem + L.rep);
  sm.xch = (float*)(smem + L.xch);
  return sm;
}

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
// shifts (forward: s1, s2; backward: t1, t2), and whether the lane's warp
// has a cell to compute on g (live).
struct Inputs {
  Emis e;
  bool vm, live;
  int sa, sb;
};

// Whether a warp computes its cells of a diagonal: a block of more than
// XCH_MIN_NW warps (K5's step design, bands of 136..512 cells) skips the
// recurrence of a warp none of whose cells lies in the band (on the
// kmer-anchored EM bands of chip_smoke's em phase, over 70% of the
// warp-diagonals: a band's own width moves far below W along the walk),
// whose cells are LOG_ZERO either way.
// The input part, computed a diagonal ahead, stays unconditional, so its
// loads are in flight before the branch. K2's and K3's blocks compute
// every warp, as before.
template <int NW>
__device__ __forceinline__ bool warp_live(bool need) {
  return NW > XCH_MIN_NW ? __any_sync(FULL, need) : true;
}

template <bool RLE, int NW = 1>
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
  in.live = warp_live<NW>(in.vm);
  in.e = staged_emissions<RLE>(sm, st, w, c, xb + k, yb - k, k < c.W);
  return in;
}

// (the final diagonal D carries the end weights: every warp is live there)
template <bool RLE, int NW = 1>
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
  in.live = warp_live<NW>(in.vm || g == c.D);
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
  for (int s = 0; s < 3; ++s) o[s] = LOG_ZERO_F;
  if (in.live) {
#pragma unroll
    for (int s = 0; s < 3; ++s) {
      l[s] = nb(p1, s, in.sa);
      u[s] = nb(p1, s, in.sa + 1);
      d[s] = nb(p2, s, in.sb);
    }
    forward_recurrence<LUT>(tr, in.e, l, d, u, o);
  }
#pragma unroll
  for (int s = 0; s < 3; ++s) out.v[s] = in.vm ? o[s] : LOG_ZERO_F;
  link<NW>(out, sm.xch, step);
}

// Backward diagonal g from n1 (g+1) and n2 (g+2); the final diagonal
// carries the end weights at k_final. to: the cell's "to" terms
// (backward_recurrence), handed out for the transition expectations.
template <bool LUT, int NW>
__device__ __forceinline__ void bwd_step(const Smem& sm, const float* tr,
                                         const Inputs& in, bool final_diag,
                                         const float* end_w, bool at_kf,
                                         const Diag& n1, const Diag& n2,
                                         Diag& out, int& step, float to[3]) {
  float o[3];
#pragma unroll
  for (int s = 0; s < 3; ++s) o[s] = to[s] = LOG_ZERO_F;
  if (in.live)
    backward_recurrence<LUT>(tr, in.e, nb(n1, 1, in.sa), nb(n2, 0, in.sb),
                             nb(n1, 2, in.sa - 1), o, to);
#pragma unroll
  for (int s = 0; s < 3; ++s)
    out.v[s] = final_diag ? (at_kf ? end_w[s] : LOG_ZERO_F)
                          : (in.vm ? o[s] : LOG_ZERO_F);
  link<NW>(out, sm.xch, step);
}

template <bool LUT, int NW>
__device__ __forceinline__ void bwd_step(const Smem& sm, const float* tr,
                                         const Inputs& in, bool final_diag,
                                         const float* end_w, bool at_kf,
                                         const Diag& n1, const Diag& n2,
                                         Diag& out, int& step) {
  float to[3];
  bwd_step<LUT, NW>(sm, tr, in, final_diag, end_w, at_kf, n1, n2, out, step,
                    to);
}

// ---------------------------------------------------------------------------
// extraction words (K3-bwd, K2-bwd's WORDS instance): every posterior cell
// at or above the threshold as two int32 words, lo = floor(min(p,1)*1e7) |
// k << 24, hi = d | (3b+s) << 22 (ops/banded.py:extract_packed), staged
// per warp in shared memory and written out with one atomicAdd a flush
// ---------------------------------------------------------------------------

constexpr int WORDS_PER_BLOCK = 1024;  // extraction words staged per block

// Stage a lane's selected cells of diagonal g of problem b: state s is
// selected when p[s] >= threshold, k < W and x (gapX), y (gapY) or both
// (match) lie past 0; a ballot per state places them in the warp's buffer
// wbuf after its wc staged words (wc stays uniform across the warp).
__device__ __forceinline__ void stage_words(const float p[3], bool x_ok,
                                            bool y_ok, int k, int W,
                                            float threshold, int g, int b,
                                            int2* wbuf, int& wc) {
  const unsigned below = (1u << (threadIdx.x & 31)) - 1u;
#pragma unroll
  for (int s = 0; s < 3; ++s) {
    const bool need = s == 0 ? x_ok && y_ok : s == 1 ? x_ok : y_ok;
    const bool sel = p[s] >= threshold && need && k < W;
    const unsigned m = __ballot_sync(FULL, sel);
    if (sel)
      wbuf[wc + __popc(m & below)] =
          make_int2((int)floorf(fminf(p[s], 1.0f) * 10000000.0f) | (k << 24),
                    g | ((3 * b + s) << 22));
    wc += __popc(m);
  }
}

// Write a warp's staged words out: one atomicAdd reserves their places.
// wc is uniform across the warp. Every word is counted; words beyond cap
// are dropped (the host launches again with the exact count).
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

}  // namespace margin

// The block of a width bucket: NW = block_warps(W) warps; LAUNCH<LUT,
// RLE, NW> returns the launch's error code.
#define BLOCK_OF_WIDTH(LAUNCH, ...)                                \
  if (W == 16 || W == 32) return LAUNCH<LUT, RLE, 1>(__VA_ARGS__); \
  if (W == 64) return LAUNCH<LUT, RLE, 2>(__VA_ARGS__);            \
  if (W == 128) return LAUNCH<LUT, RLE, 4>(__VA_ARGS__);           \
  return (int)cudaErrorInvalidValue;

// The block of a band of 136..512 cells, a multiple of 8 (K5's step
// design): NW = block_warps(W) = 6, 8, .., 16 warps, lanes k >= W idle.
#define BLOCK_OF_WIDE_WIDTH(LAUNCH, ...)                                \
  if (W <= 128 || W > 512 || W % 8) return (int)cudaErrorInvalidValue; \
  switch (block_warps(W)) {                                             \
    case 6: return LAUNCH<LUT, RLE, 6>(__VA_ARGS__);                    \
    case 8: return LAUNCH<LUT, RLE, 8>(__VA_ARGS__);                    \
    case 10: return LAUNCH<LUT, RLE, 10>(__VA_ARGS__);                  \
    case 12: return LAUNCH<LUT, RLE, 12>(__VA_ARGS__);                  \
    case 14: return LAUNCH<LUT, RLE, 14>(__VA_ARGS__);                  \
    default: return LAUNCH<LUT, RLE, 16>(__VA_ARGS__);                  \
  }
