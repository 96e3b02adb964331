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
// What bounds it on this card: the forward and backward chains. A column
// depends on the one before through its merge column, so the chain is two
// serial walks of one barrier a column; each step is a few loads and one
// atomicMax a cell. The emissions are independent across columns and
// carry the arithmetic: a cell's two sums over the column's reads for
// every allele (2 x C x D x A adds) and, with the ancestor, an (As x As)
// min-plus a site.
//
// Design (the simple version; ROADMAP lists the speed work):
//   * k6_emissions: one block a column, a thread a cell (strided over the
//     column's cells, padded cells included, as the twin computes them).
//     The column's profile probabilities (A alleles x D reads, uint8) are
//     staged in shared memory when they fit beside the scratch (up to
//     ~3600 alleles at 64 reads), else read from device memory through
//     L1; a cell's read bits come straight from its uint64 partition.
//     With the ancestor, a thread keeps a site's two allele sums in a
//     scratch of 2 x As ints a thread for the min-plus over the
//     substitution matrix: in shared memory up to 227 alleles a site, else
//     in the block's own slice of a device-memory buffer the wrapper
//     allocates (laid out a thread a column, so a warp's accesses
//     coalesce). int32 sums are exact in any order, so either place gives
//     the twin's values bit for bit.
//   * k6_chain: one block walks the columns forward, then backward, a
//     thread a cell. The merge vectors are the carry: column ci scatters
//     its forward values into merge row ci with atomicMax (order-free on
//     integers, so exact) and column ci + 1 reads row ci after one
//     __syncthreads() a column (reads at L2, __ldcg, past the atomics).
//     Any merge size fits, as the rows are device memory.
// Layout (phase/rphmm_device.py:pack): parts (ncol, C) int64, n_cells,
// depth, n_sites (ncol,) int32, pt (ncol, A, D) uint8, site_off, site_A
// (ncol, S) int32, sub (ncol, S, As, As) int32 (BIG where no allele),
// prior (ncol, S, As) int32, idx_prev, idx_next (ncol, C) int32; outputs
// em, fwd, bwd (ncol, C) and m_fwd, m_bwd (ncol, M), int32.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int BIG = 1 << 28;
constexpr int NEG = -(1 << 30);

struct Dims {
  int ncol, C, D, A, S, As, M;
};

// The shared memory of an emissions block: the staged profile bytes (when
// staged), then the ancestor scratch (when it is kept there,
// sums_shared); ops/rphmm_fb.py:emission_smem chooses the layout.
inline int emission_smem(int A, int D, int As, int threads, bool ancestor,
                         bool staged, bool sums_shared) {
  return (staged ? A * D : 0) +
         (ancestor && sums_shared ? 2 * As * threads * 4 : 0);
}

__global__ void k6_emissions(const long long* __restrict__ parts,
                             const int* __restrict__ depth,
                             const int* __restrict__ n_sites,
                             const uint8_t* __restrict__ pt,
                             const int* __restrict__ site_off,
                             const int* __restrict__ site_a,
                             const int* __restrict__ sub,
                             const int* __restrict__ prior,
                             int* __restrict__ em, int* sums, Dims dm,
                             int ancestor, int staged, int sums_shared) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int ci = blockIdx.x;
  const int T = blockDim.x;
  const int tid = threadIdx.x;
  const uint8_t* pcol = pt + (size_t)ci * dm.A * dm.D;
  int* scratch = sums_shared ? (int*)smem
                             : sums + (size_t)ci * 2 * dm.As * T;
  if (staged) {
    // the column's A x D profile bytes, D a multiple of 4 (the pack pads
    // it), so the scratch after them stays int-aligned
    const int n4 = dm.A * dm.D / 4;
    const int* src = (const int*)pcol;
    int* dst = (int*)smem;
    for (int i = tid; i < n4; i += T) dst[i] = src[i];
    pcol = smem;
    if (sums_shared) scratch = (int*)(smem + dm.A * dm.D);
  }
  __syncthreads();
  const int d = depth[ci];
  const int ns = n_sites[ci];
  const bool zero = d == 0 || ns == 0;
  int* h1s = scratch;
  int* h2s = scratch + dm.As * T;
  for (int c = tid; c < dm.C; c += T) {
    int e = 0;
    if (!zero) {
      const unsigned long long bits =
          (unsigned long long)parts[(size_t)ci * dm.C + c];
      int total = 0;
      for (int sj = 0; sj < ns; ++sj) {
        const int so = ci * dm.S + sj;
        const int off = site_off[so];
        const int na = site_a[so];
        int m1 = BIG, m2 = BIG;
        for (int k = 0; k < na; ++k) {
          // the two halves of the partition's sums for allele off + k:
          // s1 over the reads in the partition, s2 over the rest
          const uint8_t* p = pcol + (off + k) * dm.D;
          int s1 = 0, all = 0;
          for (int r = 0; r < dm.D; ++r) {
            const int v = p[r];
            all += v;
            s1 += ((bits >> r) & 1ull) ? v : 0;
          }
          const int s2 = all - s1;
          if (ancestor) {
            h1s[k * T + tid] = s1;
            h2s[k * T + tid] = s2;
          } else {
            m1 = min(m1, s1);
            m2 = min(m2, s2);
          }
        }
        int site;
        if (ancestor) {
          // min over a of (min_k h1[k] + sub[a,k]) + (min_k h2[k] +
          // sub[a,k]) + prior[a]
          const int* sb = sub + (size_t)so * dm.As * dm.As;
          const int* pr = prior + (size_t)so * dm.As;
          site = 3 * BIG;
          for (int a = 0; a < na; ++a) {
            int anc1 = BIG, anc2 = BIG;
            for (int k = 0; k < na; ++k) {
              const int s = sb[a * dm.As + k];
              anc1 = min(anc1, h1s[k * T + tid] + s);
              anc2 = min(anc2, h2s[k * T + tid] + s);
            }
            site = min(site, anc1 + anc2 + pr[a]);
          }
        } else {
          site = m1 + m2;
        }
        total += site;
      }
      e = -total;
    }
    em[(size_t)ci * dm.C + c] = e;
  }
}

__global__ void k6_chain(const int* __restrict__ n_cells,
                         const int* __restrict__ idx_prev,
                         const int* __restrict__ idx_next,
                         const int* __restrict__ em, int* __restrict__ fwd,
                         int* __restrict__ bwd, int* m_fwd, int* m_bwd,
                         Dims dm) {
  const int T = blockDim.x;
  const int tid = threadIdx.x;
  const size_t nm = (size_t)dm.ncol * dm.M;
  for (size_t i = tid; i < nm; i += T) {
    m_fwd[i] = NEG;
    m_bwd[i] = NEG;
  }
  __syncthreads();
  // forward: fwd = (first ? 0 : merge row ci - 1 at idx_prev) + em on the
  // column's cells, NEG on its padding; merge row ci = max of fwd by
  // idx_next (the last column scatters into row ncol - 1, which no merge
  // reads, as _fb_jit does)
  for (int ci = 0; ci < dm.ncol; ++ci) {
    const int n = n_cells[ci];
    const size_t row = (size_t)ci * dm.C;
    for (int c = tid; c < dm.C; c += T) {
      int f = NEG;
      if (c < n) {
        const int prev =
            ci == 0 ? 0
                    : __ldcg(m_fwd + (size_t)(ci - 1) * dm.M +
                             idx_prev[row + c]);
        f = prev + em[row + c];
      }
      fwd[row + c] = f;
      atomicMax(m_fwd + (size_t)ci * dm.M + idx_next[row + c], f);
    }
    __syncthreads();
  }
  // backward: bwd = (last ? 0 : merge row ci + 1 at idx_next) on the
  // column's cells; merge row ci = max of em + bwd by idx_prev
  for (int ci = dm.ncol - 1; ci >= 0; --ci) {
    const int n = n_cells[ci];
    const size_t row = (size_t)ci * dm.C;
    for (int c = tid; c < dm.C; c += T) {
      int b = NEG, prop = NEG;
      if (c < n) {
        b = ci == dm.ncol - 1
                ? 0
                : __ldcg(m_bwd + (size_t)(ci + 1) * dm.M + idx_next[row + c]);
        prop = em[row + c] + b;
      }
      bwd[row + c] = b;
      atomicMax(m_bwd + (size_t)ci * dm.M + idx_prev[row + c], prop);
    }
    __syncthreads();
  }
}

}  // namespace

// threads: of an emissions block; smem: the block's shared memory, as the
// wrapper computed it; staged: whether the profile bytes are in it;
// sums_shared: whether the ancestor's allele sums are, else sums holds
// them (ncol x 2 x As x threads ints; may be null without the ancestor);
// chain_threads: of the chain's block. Returns
// cudaGetLastError() after both launches (refused: cudaErrorInvalidValue).
extern "C" int k6_rphmm_fb(const void* parts, const void* n_cells,
                           const void* depth, const void* n_sites,
                           const void* pt, const void* site_off,
                           const void* site_a, const void* sub,
                           const void* prior, const void* idx_prev,
                           const void* idx_next, void* em, void* fwd,
                           void* bwd, void* m_fwd, void* m_bwd, void* sums,
                           int ncol, int C, int D, int A, int S, int As,
                           int M, int ancestor, int threads, int smem,
                           int staged, int sums_shared, int chain_threads,
                           void* stream) {
  const Dims dm{ncol, C, D, A, S, As, M};
  if (ncol <= 0 || C <= 0 || M <= 0 || D % 4 != 0 || threads <= 0 ||
      threads > 1024 || chain_threads <= 0 || chain_threads > 1024 ||
      smem < emission_smem(A, D, As, threads, ancestor != 0, staged != 0,
                           sums_shared != 0) ||
      (ancestor && !sums_shared && sums == nullptr))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        k6_emissions, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  k6_emissions<<<ncol, threads, smem, st>>>(
      (const long long*)parts, (const int*)depth, (const int*)n_sites,
      (const uint8_t*)pt, (const int*)site_off, (const int*)site_a,
      (const int*)sub, (const int*)prior, (int*)em, (int*)sums, dm, ancestor,
      staged, sums_shared);
  k6_chain<<<1, chain_threads, 0, st>>>(
      (const int*)n_cells, (const int*)idx_prev, (const int*)idx_next,
      (const int*)em, (int*)fwd, (int*)bwd, (int*)m_fwd, (int*)m_bwd, dm);
  return (int)cudaGetLastError();
}
