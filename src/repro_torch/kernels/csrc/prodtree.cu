// prod_rows: each row's product of N factors modulo the row's modulus,
// (R, N, l16) -> (R, l16), in one launch.
//
// Replaces the reference's kernels/ops.py::prod_rows (_prod_rows8: a
// jitted log-depth tree of radix-256 Barrett products, one modulus per
// row; not a Pallas kernel) and the one-modulus product tree of
// core/paillier_vec.py::mul_tree, each of whose levels was one launch of
// the TPU kernel kernels/limb_mulmod.py::mulmod_pallas.
//
// Bound on this card: 32-bit integer multiply-adds.  A row of N factors at
// k words takes N + G Montgomery products here (k^2 word products and
// k^2 + k for the reduction each), against N k l16 * 2 bytes of factors:
// at the matvec's n^2 (k = 128) and N = 192 about 13M IMADs a row against
// 197 KB, compute-bound by a factor of about 13.
//
// Design: G groups of TPI threads per row (limbs.cuh layout: lane j of a
// group holds words j*NW .. j*NW + NW-1), a block holding one or more
// whole rows.  Group g folds factors g, g + G, g + 2G, ... in registers,
// each factor streamed from device memory once; then log2 G levels halve
// the groups through shared memory (a row of C = TPI*NW words a group,
// word w of lane j at w*TPI + j, so a group's accesses hit TPI banks);
// then group 0 stores.  One launch replaces the log2 N launches of a tree
// of mulmods and their full operand traffic through device memory at
// every level.
//
// Montgomery body (every modulus odd): each accumulator starts at R mod m
// (R = 2^{32k}) and takes the raw factors by mont_mul.  Every product
// adds one R^{-1}, so after the fold and the tree group 0 holds
// prod * R^{1-N} whatever the association and G; one last product by
// R^N mod m (a per-modulus constant from the host) leaves prod exactly.
// The accumulator stays below m, so a * b < 2^{32k} m holds for factors
// up to 2^{32k} - 1, reduced or not.  Barrett body (REPRO_REDUCE_IMPL=
// barrett, or an even modulus): the same fold and tree over barrett_mul
// from 1, no correction.  Both results are canonical.
//
// Every shuffle takes the whole warp, so the groups of a warp run the same
// number of steps: a group past its last factor multiplies a zero row and
// keeps its accumulator by mask, and at each tree level a warp runs when
// any of its groups does, the others discarding their products.  Rows
// past R (the last block's) run on row 0 and store nothing.
#include "limbs.cuh"

using namespace limbs;

// x: row r's factor j at x + r*sr + j*sn (l16 radix-2^16 limbs each); out:
// (R, l16) contiguous.  Table row t = midx[r] (0 when midx is null) of
// m16 (T rows of 2k limbs), aux16 (R mod m, T rows of 2k limbs, with mp:
// -m^{-1} mod 2^32 as T int32 and corr16: R^N mod m, T rows of 2k limbs;
// Barrett: mu, T rows of 2(k+1) limbs).  G groups a row, a power of two;
// blockDim.x a multiple of TPI*G; dynamic shared memory blockDim.x * NW
// words when G > 1.
template <int TPI, int NW, bool MONT>
__global__ void prod_rows_kernel(const int32_t* __restrict__ x, long long sr,
                                 long long sn, int32_t* __restrict__ out,
                                 int R, int N, int l16, int G,
                                 const int32_t* __restrict__ m16,
                                 const int32_t* __restrict__ aux16,
                                 const int32_t* __restrict__ corr16,
                                 const int32_t* __restrict__ mp,
                                 const int32_t* __restrict__ midx, int k) {
  extern __shared__ u32 slots[];
  constexpr int C = TPI * NW;
  const int row_threads = TPI * G;
  const int local = threadIdx.x / row_threads;  // the block's row
  const int r = blockIdx.x * (blockDim.x / row_threads) + local;
  const bool live = r < R;
  const int row = live ? r : 0;
  const int g = (threadIdx.x % row_threads) / TPI;
  // the lowest group of this thread's warp (a warp spans whole rows when
  // a row has fewer than 32 threads: then 0)
  const int warp_g = ((threadIdx.x & ~31) % row_threads) / TPI;
  const int lane = group_lane<TPI>();
  const size_t t = midx ? (size_t)midx[row] : 0;

  GroupField<TPI, NW, MONT> f;
  u32 acc[NW], y[NW];
  f.k = k;
  group_load<TPI, NW>(m16 + t * 2 * k, 2 * k, k, true, f.m);
  if constexpr (MONT) {
    f.s = (u32)mp[t];
    group_load<TPI, NW>(aux16 + t * 2 * k, 2 * k, k, true, acc);  // R mod m
  } else {
    group_load_mu<TPI, NW>(aux16 + t * 2 * (k + 1), k, f.aux, f.s);
    group_one<TPI, NW>(acc);
  }

  // the fold: as many steps as the warp's lowest group has factors
  const int32_t* xr = x + (long long)row * sr;
  const int steps = (N - warp_g + G - 1) / G;
  for (int i = 0; i < steps; ++i) {
    const int j = g + i * G;
    const bool has = j < N;
    group_load<TPI, NW>(xr + (long long)(has ? j : 0) * sn, l16, k, has, y);
    f.mul(acc, y, y);
    const u32 keep = 0u - (u32)has;
#pragma unroll
    for (int w = 0; w < NW; ++w) acc[w] = (y[w] & keep) | (acc[w] & ~keep);
  }

  // the tree: at level s group g < s takes group g + s's accumulator
  if (G > 1) {
    u32* base = slots + (size_t)local * G * C;
    u32* mine = base + g * C;
#pragma unroll
    for (int w = 0; w < NW; ++w) mine[w * TPI + lane] = acc[w];
    __syncthreads();
    for (int s = G >> 1; s >= 1; s >>= 1) {
      if (warp_g < s) {
        const u32* other = base + (g + s < G ? g + s : g) * C;
#pragma unroll
        for (int w = 0; w < NW; ++w) y[w] = other[w * TPI + lane];
        f.mul(acc, y, acc);
        if (g < s && s > 1) {
#pragma unroll
          for (int w = 0; w < NW; ++w) mine[w * TPI + lane] = acc[w];
        }
      }
      __syncthreads();
    }
  }

  if (warp_g == 0) {  // the warp holding group 0 of its rows
    if constexpr (MONT) {
      group_load<TPI, NW>(corr16 + t * 2 * k, 2 * k, k, true, y);
      f.mul(acc, y, acc);
    }
    if (live && g == 0) group_store<TPI, NW>(acc, l16, out + (size_t)r * l16);
  }
}

// (threads per row group, words per thread) of every instantiation: the
// default group size at every width up to 128 words, and the others the
// sweep times at k = 128.  Mirrors
// repro_torch.kernels.geometry.SHAPES["prod_rows[...]"].
#define PROD_SHAPES(X) \
  X(32, 1) X(32, 2) X(32, 4) X(16, 1) X(16, 2) X(16, 4) X(16, 8) X(8, 16)

static bool valid_launch(int R, int N, int l16, long long sr, long long sn,
                         int k, int tpi, int nw, int groups, int threads,
                         int blocks, int smem) {
  if (!(k >= 1 && k <= MAXW && l16 >= 1 && l16 <= 2 * k && N >= 1 &&
        sr >= 0 && sn >= 0 && groups >= 1 && (groups & (groups - 1)) == 0 &&
        tpi * nw >= k && threads >= 32 && threads <= 1024 &&
        threads % 32 == 0 && threads % (tpi * groups) == 0))
    return false;
  const int rows = threads / (tpi * groups);
  return (long long)blocks * rows >= R &&
         (groups == 1 || smem >= threads * nw * 4);
}

template <int TPI, int NW, bool MONT>
static int launch(const int32_t* x, long long sr, long long sn, int32_t* out,
                  int R, int N, int l16, int groups, const int32_t* m16,
                  const int32_t* aux16, const int32_t* corr16,
                  const int32_t* mp, const int32_t* midx, int k, int threads,
                  int blocks, int smem, cudaStream_t s) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        prod_rows_kernel<TPI, NW, MONT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  prod_rows_kernel<TPI, NW, MONT><<<blocks, threads, smem, s>>>(
      x, sr, sn, out, R, N, l16, groups, m16, aux16, corr16, mp, midx, k);
  return (int)cudaGetLastError();
}

// x: (R, N, l16) int32 radix-2^16 factors with row stride sr and factor
// stride sn (limbs); out: (R, l16) contiguous.  m16, aux16, corr16, mp:
// the modulus table (prod_rows_kernel); midx: R int32, each in [0, T), or
// null for one modulus.  mont picks the Montgomery body (aux16 = R mod m,
// corr16 and mp read) or Barrett (aux16 = mu).  tpi, nw, groups, threads,
// blocks and smem are the launch geometry (geometry.tree_geometry).
// Returns the CUDA error of the launch (0 on success).  The caller checks
// midx.
extern "C" int prod_rows_launch(const int32_t* x, long long sr, long long sn,
                                int32_t* out, int R, int N, int l16,
                                const int32_t* m16, const int32_t* aux16,
                                const int32_t* corr16, const int32_t* mp,
                                const int32_t* midx, int k, int mont, int tpi,
                                int nw, int groups, int threads, int blocks,
                                int smem, void* stream) {
  if (!valid_launch(R, N, l16, sr, sn, k, tpi, nw, groups, threads, blocks,
                    smem))
    return (int)cudaErrorInvalidValue;
  if (R <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
#define LAUNCH(T, W)                                                        \
  if (tpi == T && nw == W)                                                 \
    return mont ? launch<T, W, true>(x, sr, sn, out, R, N, l16, groups,    \
                                     m16, aux16, corr16, mp, midx, k,      \
                                     threads, blocks, smem, s)             \
                : launch<T, W, false>(x, sr, sn, out, R, N, l16, groups,   \
                                      m16, aux16, corr16, mp, midx, k,     \
                                      threads, blocks, smem, s);
  PROD_SHAPES(LAUNCH)
#undef LAUNCH
  return (int)cudaErrorInvalidValue;
}
