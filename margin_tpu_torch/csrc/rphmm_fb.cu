// Kernel K6: the read-partition HMM's (stRPHmm) forward-backward in int32
// max-plus arithmetic, for one HMM: every cell's emission, the forward
// chain over the columns and the backward chain back.
//
// Replaces: margin_tpu/phase/rphmm_device.py:_fb_jit (:80, an XLA jit of
// an emission matmul a column and two lax.scans over the columns, :144,
// :150), the device path of stRPHmm_forwardBackward (hmm.c:931-942) with
// the bit-parallel emissions of emissions.c:77-138.
//
// Every value is an integer: profile probabilities are uint8, substitution
// and prior penalties uint16, and with maxNotSumTransitions the recursion
// is only + and max. So the kernel is bit-identical to the host float64
// path and to _fb_jit whatever the order of its sums and maxima; the
// caller (phase/rphmm_device.py:use_device_fb) keeps HMMs whose sums could
// leave int32 on the host.
//
// What bounds it on this card: latency, not bytes or arithmetic. The
// chains are serial over the columns (a column reads the merge row the one
// before it built), so each column costs a round trip through the block's
// memory and one barrier, twice. The emissions are independent across
// columns and cells; an HMM of the merge tree has 10-20 columns, so they
// fill the card only when a column's cells are split over several blocks.
//
// Design:
//   * k6_emissions: a block a (column, tile of T cells), a thread a cell
//     (padded cells included, as the twin computes them). Each block first
//     builds its column's bit planes in shared memory from the profile
//     bytes: for allele a, eight uint64 planes (bit r of plane b = bit b of
//     the byte of read r, by ballots, a warp an allele) and the allele's
//     total over the reads, 68 bytes an allele. A cell's two sums are then
//     exact integers, s1 = sum_b popc(bits & plane[a][b]) << b over the
//     reads in its partition and s2 = total[a] - s1 over the rest: eight
//     popcounts a cell and allele in place of a walk over the D reads. A
//     partition is 64 bits (params.MAX_READ_PARTITIONING_DEPTH), so D > 64
//     is refused. The planes are built a chunk of whole sites at a time
//     (cap_a alleles, cap_s sites), which is one chunk for any column that
//     fits in shared memory, and sites are taken in allele order (the
//     pack's site_off ascends). With the ancestor, a site's min-plus over
//     its substitutions needs both sums of every allele at once: up to the
//     register bucket NR (4 or 16 alleles, the loops unrolled and
//     predicated on the site's allele count) they stay in registers and the
//     chunk's substitutions and priors are staged in shared memory; a site
//     of more alleles keeps them in 2 x As ints a thread, in shared memory
//     where they fit (the block's thread count cut to 64 or 32 for that),
//     else in the block's own slice of a device-memory buffer the wrapper
//     allocates, with its substitutions read through L1.
//     No tensor cores: a site has 2-3 alleles and a column 5-26, so an mma
//     n-tile of 8 would be mostly padding, and arithmetic is not what bounds
//     K6. Should the emissions turn out bound by arithmetic, the option is
//     mma.sync ... .s32.u8.u8.s32 on the bytes, a cell's read bits as the
//     0/1 operand.
//   * k6_chain: two blocks of up to 1024 threads, one a sweep: the forward
//     and the backward sweeps read em and the index maps only, so they walk
//     the columns side by side on two SMs. A thread holds CPT of a column's
//     cells (cells tid, tid + T, ..). The merge rows are the carry. Where
//     three rows of M ints fit in shared memory (M up to 19,370) they live
//     there and rotate: at step k the block reads row k - 1 at idx_prev
//     (forward) or idx_next (backward), builds row k with shared atomicMax
//     (order-free on integers, so exact), writes row k - 1 out to m_fwd /
//     m_bwd with coalesced stores and resets row k - 2, which step k + 1
//     builds; so a column needs one barrier. The next column's indices,
//     emissions and cell count are loaded into registers before the
//     barrier, leaving a shared load, an add and a shared atomic on a
//     column's critical path. What a step then waits on is its SM's memory
//     pipe: 12 bytes of inputs a cell in, the cell's value and the row out,
//     about seven memory instructions a cell (a ring of cp.async slots in
//     shared memory, tried in place of the registers, added three and was
//     slower). Where three rows do not fit, the rows are m_fwd / m_bwd
//     themselves (device-memory atomicMax, reads at L2 with __ldcg): the
//     wrapper picks this instance from M before the launch. A column of more
//     than 4096 cells runs an instance that loads its inputs where it uses
//     them.
//     The rows written are _fb_jit's: the last column scatters into row
//     ncol - 1, and a padded cell's NEG, which _fb_jit scatters into slot
//     0, is skipped, as a max with NEG leaves a row reset to NEG as it is.
// Layout (phase/rphmm_device.py:pack): parts (ncol, C) int64, n_cells,
// depth, n_sites (ncol,) int32, pt (ncol, A, D) uint8, site_off, site_a
// (ncol, S) int32, sub (ncol, S, As, As) int32 (BIG where no allele),
// prior (ncol, S, As) int32, idx_prev, idx_next (ncol, C) int32; outputs
// em, fwd, bwd (ncol, C) and m_fwd, m_bwd (ncol, M), int32.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int BIG = 1 << 28;
constexpr int NEG = -(1 << 30);
constexpr int PLANES = 8;   // bits of a profile byte
constexpr int MAX_DEPTH = 64;

// where a site wider than the register bucket keeps its allele sums
constexpr int SUMS_REGISTERS = 0;
constexpr int SUMS_SHARED = 1;
constexpr int SUMS_DEVICE = 2;
// where the chain keeps its merge rows
constexpr int CARRY_SHARED = 0;
constexpr int CARRY_DEVICE = 1;

struct Dims {
  int ncol, C, D, A, S, As, M;
};

// The shared memory of an emissions block: cap_a alleles' planes and
// totals, then (stage_sub) cap_s sites' substitutions and priors, then
// (SUMS_SHARED) 2 x As ints a thread. ops/rphmm_fb.py:k6_launch mirrors it.
__host__ __device__ inline int emission_bytes(int cap_a, int cap_s, int As,
                                              int threads, int stage_sub,
                                              int sums) {
  return cap_a * (PLANES * 8 + 4) +
         (stage_sub ? cap_s * (As * As + As) * 4 : 0) +
         (sums == SUMS_SHARED ? 2 * As * threads * 4 : 0);
}

// The chain's, a block: three merge rows (CARRY_SHARED).
__host__ __device__ inline int chain_bytes(int M, int carry) {
  return carry == CARRY_SHARED ? 3 * M * 4 : 0;
}

// s1 of a cell over one allele's planes
__device__ __forceinline__ int allele_sum(unsigned long long bits,
                                          const unsigned long long* pl) {
  int s = 0;
#pragma unroll
  for (int b = 0; b < PLANES; ++b) s += __popcll(bits & pl[b]) << b;
  return s;
}

// min over a of (min_k h1[k] + sub[a,k]) + (min_k h2[k] + sub[a,k]) +
// prior[a], the sums in registers (na <= NR)
template <int NR>
__device__ __forceinline__ int site_registers(
    unsigned long long bits, const unsigned long long* planes,
    const int* tot, int off, int na, const int* sb, const int* pr, int As) {
  int h1[NR], h2[NR];
#pragma unroll
  for (int k = 0; k < NR; ++k) {
    if (k < na) {
      const int s1 = allele_sum(bits, planes + (off + k) * PLANES);
      h1[k] = s1;
      h2[k] = tot[off + k] - s1;
    }
  }
  int site = 3 * BIG;
#pragma unroll
  for (int a = 0; a < NR; ++a) {
    if (a < na) {
      int anc1 = BIG, anc2 = BIG;
#pragma unroll
      for (int k = 0; k < NR; ++k) {
        if (k < na) {
          const int s = sb[a * As + k];
          anc1 = min(anc1, h1[k] + s);
          anc2 = min(anc2, h2[k] + s);
        }
      }
      site = min(site, anc1 + anc2 + pr[a]);
    }
  }
  return site;
}

// the same with the sums in a scratch of 2 x As ints a thread (h1 at
// [k * T + tid], h2 As * T further), for a site wider than the bucket
__device__ __forceinline__ int site_scratch(
    unsigned long long bits, const unsigned long long* planes,
    const int* tot, int off, int na, const int* sb, const int* pr, int As,
    int* h1s, int* h2s, int T, int tid) {
  for (int k = 0; k < na; ++k) {
    const int s1 = allele_sum(bits, planes + (off + k) * PLANES);
    h1s[k * T + tid] = s1;
    h2s[k * T + tid] = tot[off + k] - s1;
  }
  int site = 3 * BIG;
  for (int a = 0; a < na; ++a) {
    int anc1 = BIG, anc2 = BIG;
    for (int k = 0; k < na; ++k) {
      const int s = sb[a * As + k];
      anc1 = min(anc1, h1s[k * T + tid] + s);
      anc2 = min(anc2, h2s[k * T + tid] + s);
    }
    site = min(site, anc1 + anc2 + pr[a]);
  }
  return site;
}

// ANC: with the ancestor; NR: the register bucket; SUMS: where a site of
// more than NR alleles keeps its sums (SUMS_REGISTERS: no such site)
template <bool ANC, int NR, int SUMS>
__global__ void __launch_bounds__(128) k6_emissions(
    const long long* __restrict__ parts, const int* __restrict__ depth,
    const int* __restrict__ n_sites, const uint8_t* __restrict__ pt,
    const int* __restrict__ site_off, const int* __restrict__ site_a,
    const int* __restrict__ sub, const int* __restrict__ prior,
    int* __restrict__ em, int* __restrict__ sums, Dims dm, int cap_a,
    int cap_s, int stage_sub) {
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned long long* planes = (unsigned long long*)smem;
  int* tot = (int*)(planes + (size_t)cap_a * PLANES);
  int* ssub = tot + cap_a;
  int* sprior = ssub + (stage_sub ? cap_s * dm.As * dm.As : 0);
  int* scratch = sprior + (stage_sub ? cap_s * dm.As : 0);
  const int ci = blockIdx.x;
  const int T = blockDim.x;
  const int tid = threadIdx.x;
  const int c = blockIdx.y * T + tid;
  const bool live = c < dm.C;
  const size_t cell = (size_t)ci * dm.C + c;
  if (SUMS == SUMS_DEVICE)
    scratch = sums + ((size_t)ci * gridDim.y + blockIdx.y) * 2 * dm.As * T;
  const int ns = n_sites[ci];
  if (depth[ci] == 0 || ns == 0) {   // the whole block's column
    if (live) em[cell] = 0;
    return;
  }
  const unsigned long long bits =
      live ? (unsigned long long)parts[cell] : 0ull;
  const uint8_t* pcol = pt + (size_t)ci * dm.A * dm.D;
  const int* soff = site_off + (size_t)ci * dm.S;
  const int* sa = site_a + (size_t)ci * dm.S;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = T >> 5;
  int total = 0;
  for (int s0 = 0; s0 < ns;) {
    // the chunk [s0, s1): whole sites, at most cap_a alleles and cap_s
    // sites (the wrapper keeps every site within cap_a)
    const int lo = soff[s0];
    int s1 = s0 + 1;
    while (s1 < ns && s1 - s0 < cap_s && soff[s1] + sa[s1] - lo <= cap_a)
      ++s1;
    const int na_chunk = soff[s1 - 1] + sa[s1 - 1] - lo;
    __syncthreads();   // the previous chunk is read out
    // the planes: a warp an allele, lane l holds reads l and l + 32
    for (int a = warp; a < na_chunk; a += nwarps) {
      const uint8_t* p = pcol + (size_t)(lo + a) * dm.D;
      const int v0 = lane < dm.D ? p[lane] : 0;
      const int v1 = lane + 32 < dm.D ? p[lane + 32] : 0;
      unsigned long long mine = 0ull;
#pragma unroll
      for (int b = 0; b < PLANES; ++b) {
        const unsigned w0 = __ballot_sync(0xffffffffu, (v0 >> b) & 1);
        const unsigned w1 = __ballot_sync(0xffffffffu, (v1 >> b) & 1);
        if (lane == b) mine = ((unsigned long long)w1 << 32) | w0;
      }
      if (lane < PLANES) planes[(size_t)a * PLANES + lane] = mine;
      const int t = (int)__reduce_add_sync(0xffffffffu, (unsigned)(v0 + v1));
      if (lane == 0) tot[a] = t;
    }
    if (ANC && stage_sub) {
      const int per = dm.As * dm.As;
      const int* src = sub + ((size_t)ci * dm.S + s0) * per;
      for (int i = tid; i < (s1 - s0) * per; i += T) ssub[i] = src[i];
      const int* psrc = prior + ((size_t)ci * dm.S + s0) * dm.As;
      for (int i = tid; i < (s1 - s0) * dm.As; i += T) sprior[i] = psrc[i];
    }
    __syncthreads();
    if (live) {
      for (int sj = s0; sj < s1; ++sj) {
        const int off = soff[sj] - lo;
        const int na = sa[sj];
        int site;
        if (ANC) {
          const int* sb;
          const int* pr;
          if (stage_sub) {
            sb = ssub + (sj - s0) * dm.As * dm.As;
            pr = sprior + (sj - s0) * dm.As;
          } else {
            sb = sub + ((size_t)ci * dm.S + sj) * dm.As * dm.As;
            pr = prior + ((size_t)ci * dm.S + sj) * dm.As;
          }
          if (SUMS == SUMS_REGISTERS || na <= NR)
            site = site_registers<NR>(bits, planes, tot, off, na, sb, pr,
                                      dm.As);
          else
            site = site_scratch(bits, planes, tot, off, na, sb, pr, dm.As,
                                scratch, scratch + dm.As * T, T, tid);
        } else {
          int m1 = BIG, m2 = BIG;
          for (int k = 0; k < na; ++k) {
            const int s1v = allele_sum(bits, planes + (off + k) * PLANES);
            m1 = min(m1, s1v);
            m2 = min(m2, tot[off + k] - s1v);
          }
          site = m1 + m2;
        }
        total += site;
      }
    }
    s0 = s1;
  }
  if (live) em[cell] = -total;
}

// One sweep of the chain, forward (FWD) or backward. At step k (column ci,
// ascending forward, descending backward) a live cell reads the previous
// step's row at g (idx_prev forward, idx_next backward; 0 at the first
// step), writes fwd = that + em or bwd = that, and scatters fwd or em + bwd
// into this step's row at x (idx_next forward, idx_prev backward).
// CPT > 0: a thread's CPT cells' inputs in registers, the next column's
// loaded before the barrier; CPT == 0: loaded where used, any C.
template <int CPT, int CARRY, bool FWD>
__device__ void chain_sweep(const int* __restrict__ n_cells,
                            const int* __restrict__ idx_g,
                            const int* __restrict__ idx_x,
                            const int* __restrict__ em,
                            int* __restrict__ out, int* m_out, int* rows,
                            const Dims& dm) {
  constexpr int R = CPT > 0 ? CPT : 1;
  const int T = blockDim.x;
  const int tid = threadIdx.x;
  const int ncol = dm.ncol;
  const int C = dm.C;
  const int M = dm.M;
  int g[R], x[R], e[R];
  int n = 0;
  auto column = [&](int k) { return FWD ? k : ncol - 1 - k; };
  auto load = [&](int k) {
    const int ci = column(k);
    n = n_cells[ci];
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const int c = tid + j * T;
      if (c < C) {
        const size_t i = (size_t)ci * C + c;
        g[j] = idx_g[i];
        x[j] = idx_x[i];
        e[j] = em[i];
      }
    }
  };
  if (CPT > 0) load(0);
  for (int k = 0; k < ncol; ++k) {
    const int ci = column(k);
    const size_t row = (size_t)ci * C;
    const int* prev;
    int* cur;
    if (CARRY == CARRY_SHARED) {
      prev = rows + ((k + 2) % 3) * M;
      cur = rows + (k % 3) * M;
    } else {
      prev = m_out + (size_t)column(k > 0 ? k - 1 : 0) * M;
      cur = m_out + (size_t)ci * M;
    }
    if (CPT > 0) {
#pragma unroll
      for (int j = 0; j < R; ++j) {
        const int c = tid + j * T;
        if (c < C) {
          int v = NEG;
          if (c < n) {
            const int p = k == 0                    ? 0
                          : CARRY == CARRY_SHARED ? prev[g[j]]
                                                  : __ldcg(prev + g[j]);
            v = FWD ? p + e[j] : p;
            atomicMax(cur + x[j], FWD ? v : e[j] + v);
          }
          out[row + c] = v;
        }
      }
    } else {
      const int nc = n_cells[ci];
      for (int c = tid; c < C; c += T) {
        int v = NEG;
        if (c < nc) {
          const int gi = idx_g[row + c];
          const int p = k == 0                    ? 0
                        : CARRY == CARRY_SHARED ? prev[gi]
                                                : __ldcg(prev + gi);
          const int ec = em[row + c];
          v = FWD ? p + ec : p;
          atomicMax(cur + idx_x[row + c], FWD ? v : ec + v);
        }
        out[row + c] = v;
      }
    }
    if (CARRY == CARRY_SHARED) {
      // row k - 1 out (only read at this step), row k - 2 reset (read at
      // step k - 1, built at step k + 1)
      int* spent = rows + ((k + 1) % 3) * M;
      if (k > 0) {
        int* dst = m_out + (size_t)column(k - 1) * M;
        for (int i = tid; i < M; i += T) {
          dst[i] = prev[i];
          spent[i] = NEG;
        }
      } else {
        for (int i = tid; i < M; i += T) spent[i] = NEG;
      }
    }
    if (CPT > 0 && k + 1 < ncol) load(k + 1);
    __syncthreads();
  }
  if (CARRY == CARRY_SHARED) {
    const int* last = rows + ((ncol - 1) % 3) * M;
    int* dst = m_out + (size_t)column(ncol - 1) * M;
    for (int i = tid; i < M; i += T) dst[i] = last[i];
  }
}

// Two blocks: block 0 the forward sweep, block 1 the backward one (the two
// sweeps read em and the index maps only, so they run side by side on two
// SMs), each with its own rows.
template <int CPT, int CARRY>
__global__ void __launch_bounds__(1024) k6_chain(
    const int* __restrict__ n_cells, const int* __restrict__ idx_prev,
    const int* __restrict__ idx_next, const int* __restrict__ em,
    int* __restrict__ fwd, int* __restrict__ bwd, int* m_fwd, int* m_bwd,
    Dims dm) {
  extern __shared__ __align__(16) unsigned char smem[];
  int* rows = (int*)smem;
  const bool forward = blockIdx.x == 0;
  int* m_out = forward ? m_fwd : m_bwd;
  const int T = blockDim.x;
  const int tid = threadIdx.x;
  if (CARRY == CARRY_SHARED) {
    for (int i = tid; i < 3 * dm.M; i += T) rows[i] = NEG;
  } else {
    const size_t nm = (size_t)dm.ncol * dm.M;
    for (size_t i = tid; i < nm; i += T) m_out[i] = NEG;
  }
  __syncthreads();
  if (forward)
    chain_sweep<CPT, CARRY, true>(n_cells, idx_prev, idx_next, em, fwd,
                                  m_fwd, rows, dm);
  else
    chain_sweep<CPT, CARRY, false>(n_cells, idx_next, idx_prev, em, bwd,
                                   m_bwd, rows, dm);
}

template <bool ANC, int NR, int SUMS>
cudaError_t launch_emissions(dim3 grid, int threads, int bytes,
                             cudaStream_t st, const long long* parts,
                             const int* depth, const int* n_sites,
                             const uint8_t* pt, const int* site_off,
                             const int* site_a, const int* sub,
                             const int* prior, int* em, int* sums,
                             const Dims& dm, int cap_a, int cap_s,
                             int stage_sub) {
  auto kern = k6_emissions<ANC, NR, SUMS>;
  if (bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return e;
  }
  kern<<<grid, threads, bytes, st>>>(parts, depth, n_sites, pt, site_off,
                                      site_a, sub, prior, em, sums, dm,
                                      cap_a, cap_s, stage_sub);
  return cudaGetLastError();
}

template <int CPT, int CARRY>
cudaError_t launch_chain(int threads, int bytes, cudaStream_t st,
                         const int* n_cells, const int* idx_prev,
                         const int* idx_next, const int* em, int* fwd,
                         int* bwd, int* m_fwd, int* m_bwd, const Dims& dm) {
  auto kern = k6_chain<CPT, CARRY>;
  if (bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return e;
  }
  kern<<<2, threads, bytes, st>>>(n_cells, idx_prev, idx_next, em, fwd, bwd,
                                   m_fwd, m_bwd, dm);
  return cudaGetLastError();
}

}  // namespace

// The layouts' shared bytes, for the wrapper's mirror to be checked
// against (ops/rphmm_fb.py:k6_launch).
extern "C" int k6_emission_bytes(int cap_a, int cap_s, int As, int threads,
                                 int stage_sub, int sums) {
  return emission_bytes(cap_a, cap_s, As, threads, stage_sub, sums);
}

extern "C" int k6_chain_bytes(int M, int carry) {
  return chain_bytes(M, carry);
}

// em_threads, cap_a, cap_s, stage_sub, sums_place, nr, em_bytes: the
// emissions' layout (ops/rphmm_fb.py:k6_launch), sums (ncol x tiles x 2 x
// As x em_threads ints) where sums_place is SUMS_DEVICE, else may be null;
// chain_cpt, chain_threads, carry, chain_bytes: the chain's. Returns
// cudaGetLastError() after both launches (refused: cudaErrorInvalidValue).
extern "C" int k6_rphmm_fb(const void* parts, const void* n_cells,
                           const void* depth, const void* n_sites,
                           const void* pt, const void* site_off,
                           const void* site_a, const void* sub,
                           const void* prior, const void* idx_prev,
                           const void* idx_next, void* em, void* fwd,
                           void* bwd, void* m_fwd, void* m_bwd, void* sums,
                           int ncol, int C, int D, int A, int S, int As,
                           int M, int ancestor, int em_threads, int cap_a,
                           int cap_s, int stage_sub, int sums_place, int nr,
                           int em_bytes, int chain_cpt, int chain_threads,
                           int carry, int chain_bytes_, void* stream) {
  const Dims dm{ncol, C, D, A, S, As, M};
  const bool anc = ancestor != 0;
  const bool wide = anc && As > nr;   // a site beyond the register bucket
  if (ncol <= 0 || C <= 0 || M <= 0 || D <= 0 || D > MAX_DEPTH || A <= 0 ||
      S <= 0 || As <= 0 || em_threads <= 0 || em_threads > 128 ||
      em_threads % 32 != 0 || cap_a < As || cap_s < 1 ||
      (nr != 4 && nr != 16) || (wide != (sums_place != SUMS_REGISTERS)) ||
      (stage_sub && (!anc || wide)) ||
      (sums_place == SUMS_DEVICE && sums == nullptr) ||
      em_bytes < emission_bytes(cap_a, cap_s, As, em_threads, stage_sub,
                                sums_place) ||
      chain_threads <= 0 || chain_threads > 1024 || chain_threads % 32 != 0 ||
      (chain_cpt != 0 && chain_cpt != 1 && chain_cpt != 2 &&
       chain_cpt != 4) ||
      (chain_cpt > 0 && (long long)chain_cpt * chain_threads < C) ||
      (carry != CARRY_SHARED && carry != CARRY_DEVICE) ||
      chain_bytes_ < chain_bytes(M, carry))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const dim3 grid(ncol, (C + em_threads - 1) / em_threads);
  const long long* pa = (const long long*)parts;
  const int* dp = (const int*)depth;
  const int* nsi = (const int*)n_sites;
  const uint8_t* ptb = (const uint8_t*)pt;
  const int* so = (const int*)site_off;
  const int* sa = (const int*)site_a;
  const int* sb = (const int*)sub;
  const int* pr = (const int*)prior;
  int* e = (int*)em;
  int* su = (int*)sums;
  cudaError_t err;
  if (!anc)
    err = launch_emissions<false, 4, SUMS_REGISTERS>(
        grid, em_threads, em_bytes, st, pa, dp, nsi, ptb, so, sa, sb, pr, e,
        su, dm, cap_a, cap_s, stage_sub);
  else if (!wide && nr == 4)
    err = launch_emissions<true, 4, SUMS_REGISTERS>(
        grid, em_threads, em_bytes, st, pa, dp, nsi, ptb, so, sa, sb, pr, e,
        su, dm, cap_a, cap_s, stage_sub);
  else if (!wide)
    err = launch_emissions<true, 16, SUMS_REGISTERS>(
        grid, em_threads, em_bytes, st, pa, dp, nsi, ptb, so, sa, sb, pr, e,
        su, dm, cap_a, cap_s, stage_sub);
  else if (sums_place == SUMS_SHARED)
    err = launch_emissions<true, 16, SUMS_SHARED>(
        grid, em_threads, em_bytes, st, pa, dp, nsi, ptb, so, sa, sb, pr, e,
        su, dm, cap_a, cap_s, stage_sub);
  else
    err = launch_emissions<true, 16, SUMS_DEVICE>(
        grid, em_threads, em_bytes, st, pa, dp, nsi, ptb, so, sa, sb, pr, e,
        su, dm, cap_a, cap_s, stage_sub);
  if (err != cudaSuccess) return (int)err;
  const int* nc = (const int*)n_cells;
  const int* ip = (const int*)idx_prev;
  const int* in = (const int*)idx_next;
  int* f = (int*)fwd;
  int* b = (int*)bwd;
  int* mf = (int*)m_fwd;
  int* mb = (int*)m_bwd;
#define K6_CHAIN(CPT)                                                       \
  (carry == CARRY_SHARED                                                   \
       ? launch_chain<CPT, CARRY_SHARED>(chain_threads, chain_bytes_, st,  \
                                         nc, ip, in, e, f, b, mf, mb, dm)  \
       : launch_chain<CPT, CARRY_DEVICE>(chain_threads, chain_bytes_, st,  \
                                         nc, ip, in, e, f, b, mf, mb, dm))
  switch (chain_cpt) {
    case 1: err = K6_CHAIN(1); break;
    case 2: err = K6_CHAIN(2); break;
    case 4: err = K6_CHAIN(4); break;
    default: err = K6_CHAIN(0); break;
  }
#undef K6_CHAIN
  return (int)err;
}
