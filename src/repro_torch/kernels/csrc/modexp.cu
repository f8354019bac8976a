// modexp: base^exp mod m over a batch, one exponent per element,
// constant-time ladder.
//
// Replaces the TPU kernel repro/kernels/modexp.py::modexp_pallas and its
// four bodies, which here are two templates over the window:
//   _modexp_mont_win4_kernel -> modexp_mont_kernel<TPI, NW, true>  (default)
//   _modexp_mont_kernel      -> modexp_mont_kernel<TPI, NW, false>
//   _modexp_win4_kernel      -> modexp_barrett_kernel<true>
//   _modexp_kernel           -> modexp_barrett_kernel<false>
//
// Bound on this card: 32-bit integer multiply-adds.  A Montgomery product
// at k words needs k^2 + k word products for the reduction and k^2 for
// the product (k(k+1)/2 when it is a squaring), two IMAD results each; the
// win4 ladder over an exponent of E bits does E squarings and E/4 + 16
// other products (one table product per window, 14 for the table, domain
// enter and leave).  At the main path's p^2/q^2 width (k = 64) and 64-bit
// exponents that is about 1.3M IMADs per element against about 1 KB of
// traffic: compute-bound by a factor of about 250.  No body takes the
// squaring saving: every product is a full k^2 schoolbook.
//
// Design of the Montgomery bodies: a group of TPI threads per element
// (limbs.cuh mont_mul), the words of the base, the result, the modulus and
// the running sum in registers, NW = ceil(k / TPI) rounded up to a power
// of two per lane.  The small group (TPI = 8 at every width) keeps the
// 36,864 elements of an edge's matvec filling the card.  The win4 power
// table lives in dynamic shared memory, entry t word w of thread i at
// (t NW + w) blockDim + i, so a warp's loads hit 32 banks and each thread
// reads back only what it wrote (no barrier).  No branch and no address
// depends on exponent bits: the loop bounds come from the exponent width,
// the binary ladder always computes res * b and keeps it by a mask, win4
// reads all 16 table entries and selects by a masked sum, and mont_mul's
// carries resolve in a fixed instruction count.  Groups past the batch
// edge run on a zero row and store nothing, so every shuffle sees the
// full warp.
//
// The Barrett bodies keep the one-thread design: one thread per element,
// rows and the table in per-thread local memory, modulus and mu
// broadcast from shared memory.
#include "limbs.cuh"

using namespace limbs;

template <int TPI, int NW, bool WIN4>
__global__ void modexp_mont_kernel(const int32_t* __restrict__ base,
                                   const int32_t* __restrict__ exp,
                                   int32_t* __restrict__ out, int B, int l16,
                                   int le16, const int32_t* __restrict__ m16,
                                   const int32_t* __restrict__ r1_16,
                                   const int32_t* __restrict__ r2_16, u32 mp,
                                   int k) {
  extern __shared__ u32 tab[];  // WIN4: 16 entries x NW words x blockDim
  const int e = (int)((blockIdx.x * blockDim.x + threadIdx.x) / TPI);
  const bool live = e < B;
  const int row = live ? e : 0;
  u32 m[NW], b[NW], res[NW], x[NW];
  group_load<TPI, NW>(m16, 2 * k, k, true, m);
  group_load<TPI, NW>(r2_16, 2 * k, k, true, x);
  group_load<TPI, NW>(base + (size_t)row * l16, l16, k, live, b);
  mont_mul<TPI, NW>(b, x, m, mp, k, b);             // base into the domain
  group_load<TPI, NW>(r1_16, 2 * k, k, true, res);  // 1 in the domain
  const int32_t* ex = exp + (size_t)row * le16;
  const int n_bits = 16 * le16;

  if (WIN4) {
    u32* mine = tab + threadIdx.x;
    const int bd = blockDim.x;
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      mine[w * bd] = res[w];
      mine[(NW + w) * bd] = b[w];
      x[w] = b[w];
    }
    for (int t = 2; t < 16; ++t) {
      mont_mul<TPI, NW>(x, b, m, mp, k, x);
#pragma unroll
      for (int w = 0; w < NW; ++w) mine[(t * NW + w) * bd] = x[w];
    }
    for (int j = n_bits / 4 - 1; j >= 0; --j) {
      const u32 win = ((u32)ex[(4 * j) >> 4] >> ((4 * j) & 15)) & 0xFu;
      for (int s = 0; s < 4; ++s) mont_mul<TPI, NW>(res, res, m, mp, k, res);
      // oblivious select: every entry read, one kept by mask
#pragma unroll
      for (int w = 0; w < NW; ++w) x[w] = 0;
      for (int t = 0; t < 16; ++t) {
        const u32 mask = 0u - (u32)(win == (u32)t);
#pragma unroll
        for (int w = 0; w < NW; ++w) x[w] |= mine[(t * NW + w) * bd] & mask;
      }
      mont_mul<TPI, NW>(res, x, m, mp, k, res);
    }
  } else {
    for (int j = 0; j < n_bits; ++j) {
      const u32 mask = 0u - (((u32)ex[j >> 4] >> (j & 15)) & 1u);
      mont_mul<TPI, NW>(res, b, m, mp, k, x);
#pragma unroll
      for (int w = 0; w < NW; ++w) res[w] = (x[w] & mask) | (res[w] & ~mask);
      mont_mul<TPI, NW>(b, b, m, mp, k, b);
    }
  }
  group_one<TPI, NW>(x);  // leave the domain: REDC(res) = res * 1
  mont_mul<TPI, NW>(res, x, m, mp, k, res);
  if (live) group_store<TPI, NW>(res, l16, out + (size_t)e * l16);
}

template <bool WIN4>
__global__ void modexp_barrett_kernel(const int32_t* __restrict__ base,
                                      const int32_t* __restrict__ exp,
                                      int32_t* __restrict__ out, int B,
                                      int l16, int le16,
                                      const int32_t* __restrict__ m16,
                                      const int32_t* __restrict__ mu16,
                                      int k) {
  __shared__ u32 sm[MAXW];
  __shared__ u32 smu[MAXW + 1];
  load_shared(m16, 2 * k, sm, k);
  load_shared(mu16, 2 * (k + 1), smu, k + 1);
  __syncthreads();
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= B) return;

  BarrettField f;
  f.m = sm;
  f.mu = smu;
  f.k = k;
  u32 b[MAXW], res[MAXW], tmp[MAXW];
  load_row(base + (size_t)e * l16, l16, tmp, k);
  f.reduce(tmp, b);
  for (int i = 0; i < k; ++i) res[i] = (i == 0);
  const int32_t* ex = exp + (size_t)e * le16;
  const int n_bits = 16 * le16;

  if (WIN4) {
    u32 tab[16 * MAXW];
    for (int i = 0; i < k; ++i) {
      tab[i] = res[i];
      tab[k + i] = b[i];
    }
    for (int t = 2; t < 16; ++t) f.mulmod(tab + (t - 1) * k, b, tab + t * k);
    for (int w = n_bits / 4 - 1; w >= 0; --w) {
      const u32 win = ((u32)ex[(4 * w) >> 4] >> ((4 * w) & 15)) & 0xFu;
      for (int s = 0; s < 4; ++s) f.mulmod(res, res, res);
      // oblivious select: every entry read, one kept by mask
      for (int i = 0; i < k; ++i) {
        u32 v = 0;
        for (int t = 0; t < 16; ++t) v |= tab[t * k + i] & (0u - (u32)(win == (u32)t));
        tmp[i] = v;
      }
      f.mulmod(res, tmp, res);
    }
  } else {
    for (int j = 0; j < n_bits; ++j) {
      const u32 mask = 0u - (((u32)ex[j >> 4] >> (j & 15)) & 1u);
      f.mulmod(res, b, tmp);
      for (int i = 0; i < k; ++i) res[i] = (tmp[i] & mask) | (res[i] & ~mask);
      f.mulmod(b, b, b);
    }
  }
  store_row(res, l16, out + (size_t)e * l16);
}

// (threads per element, words per thread) of every Montgomery
// instantiation: TPI = 8 at every width up to 128 words, and the other
// group sizes timed against it at k = 64.  Mirrors
// repro_torch.kernels.geometry.SHAPES["modexp"].
#define MODEXP_MONT_SHAPES(X) \
  X(8, 1) X(8, 2) X(8, 4) X(8, 8) X(8, 16) X(4, 16) X(16, 4)

template <int TPI, int NW, bool WIN4>
static int launch_mont(const int32_t* base, const int32_t* exp, int32_t* out,
                       int B, int l16, int le16, const int32_t* m16,
                       const int32_t* r1_16, const int32_t* r2_16, u32 mp,
                       int k, int threads, int blocks, int smem,
                       cudaStream_t s) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        modexp_mont_kernel<TPI, NW, WIN4>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  modexp_mont_kernel<TPI, NW, WIN4><<<blocks, threads, smem, s>>>(
      base, exp, out, B, l16, le16, m16, r1_16, r2_16, mp, k);
  return (int)cudaGetLastError();
}

// base, out: (B, l16) int32 radix-2^16 rows; exp: (B, le16) rows; m16 and
// r2_16: 2k limbs; aux16: mu as 2(k+1) limbs (Barrett) or r1 as 2k limbs
// (Montgomery, R = 2^{32k}); mp = -m^{-1} mod 2^32.  tpi, nw, threads,
// blocks and smem are the launch geometry (geometry.launch_geometry):
// Montgomery bodies take the (tpi, nw) instantiation, Barrett bodies one
// thread per element (tpi = 1).  Returns the CUDA error of the launch (0
// on success).
extern "C" int modexp_launch(const int32_t* base, const int32_t* exp,
                             int32_t* out, int B, int l16, int le16,
                             const int32_t* m16, const int32_t* aux16,
                             const int32_t* r2_16, unsigned int mp, int k,
                             int mont, int win4, int tpi, int nw, int threads,
                             int blocks, int smem, void* stream) {
  if (k < 1 || k > MAXW || l16 > 2 * k || le16 < 1 || threads < 32 ||
      threads > 1024 || threads % 32 != 0 || tpi < 1 ||
      (long long)blocks * threads < (long long)B * tpi)
    return (int)cudaErrorInvalidValue;
  if (B <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (mont) {
    if (tpi * nw < k) return (int)cudaErrorInvalidValue;
#define LAUNCH(T, N)                                                        \
  if (tpi == T && nw == N)                                                 \
    return win4 ? launch_mont<T, N, true>(base, exp, out, B, l16, le16, m16, \
                                          aux16, r2_16, mp, k, threads,     \
                                          blocks, smem, s)                  \
                : launch_mont<T, N, false>(base, exp, out, B, l16, le16,   \
                                           m16, aux16, r2_16, mp, k,        \
                                           threads, blocks, smem, s);
    MODEXP_MONT_SHAPES(LAUNCH)
#undef LAUNCH
    return (int)cudaErrorInvalidValue;
  }
  if (tpi != 1) return (int)cudaErrorInvalidValue;
  if (win4)
    modexp_barrett_kernel<true><<<blocks, threads, 0, s>>>(
        base, exp, out, B, l16, le16, m16, aux16, k);
  else
    modexp_barrett_kernel<false><<<blocks, threads, 0, s>>>(
        base, exp, out, B, l16, le16, m16, aux16, k);
  return (int)cudaGetLastError();
}
