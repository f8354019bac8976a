// modexp: base^exp mod m over a batch, one exponent per element,
// constant-time ladder.
//
// Replaces the TPU kernel repro/kernels/modexp.py::modexp_pallas and its
// four bodies, one template over the window and the product:
//   _modexp_mont_win4_kernel -> modexp_kernel<TPI, NW, true, true>  (default)
//   _modexp_mont_kernel      -> modexp_kernel<TPI, NW, false, true>
//   _modexp_win4_kernel      -> modexp_kernel<TPI, NW, true, false>
//   _modexp_kernel           -> modexp_kernel<TPI, NW, false, false>
//
// Bound on this card: 32-bit integer multiply-adds.  A Montgomery product
// at k words needs k^2 + k word products for the reduction and k^2 for
// the product (k(k+1)/2 when it is a squaring), a Barrett reduction at
// least (k+1)^2 - k(k-1)/2 + k(k+1)/2 + k (mulmod.cu); two IMAD results
// each.  The win4 ladder over an exponent of E bits does E squarings and
// E/4 + 14 other products (one table product per window, 14 for the
// table), Montgomery two more (domain enter and leave), Barrett one more
// (the base's reduction).  At the main path's p^2/q^2 width (k = 64) and
// 64-bit exponents that is about 1.3M IMADs per element against about
// 1 KB of traffic: compute-bound by a factor of about 250.  No body takes
// the squaring saving: every product is a full k^2 schoolbook.
//
// Design: a group of TPI threads per element (limbs.cuh GroupField over
// mont_mul or barrett_mul), the words of the base, the result, the
// modulus (and mu) and the running sums in registers, NW = ceil(k / TPI)
// rounded up to a power of two per lane.  Small groups (TPI = 8, and 16
// for the Barrett win4 body, whose table's shared memory limits TPI 8's
// blocks per SM; at every width, the sizes that chip_smoke.py's sweep at
// k = 64 found fastest) keep the 36,864 elements of an edge's matvec
// filling the card.  The Barrett
// bodies reduce the base first (base * 1) and keep no domain: their
// products take any operands below 2^{32k}, odd or even m.
// The win4 power table lives in dynamic shared memory, entry t word w of
// thread i at (t NW + w) blockDim + i, so a warp's loads hit 32 banks and
// each thread reads back only what it wrote (no barrier).  No branch and
// no address depends on exponent bits: the loop bounds come from the
// exponent width, the binary ladder always computes res * b and keeps it
// by a mask, win4 reads all 16 table entries and selects by a masked sum,
// and both products resolve their carries and corrections in a fixed
// instruction count with masks only.  Groups past the batch edge run on a
// zero row and store nothing, so every shuffle sees the full warp.
#include "limbs.cuh"

using namespace limbs;

// One group's element e: out row e = base row e ^ exp row e mod m, the
// field given by m16, aux16, r2_16 and mp (GroupField::enter); tab is the
// block's dynamic shared memory (the win4 table).
template <int TPI, int NW, bool WIN4, bool MONT>
__device__ __forceinline__ void modexp_element(
    const int32_t* __restrict__ base, const int32_t* __restrict__ exp,
    int32_t* __restrict__ out, int e, bool live, int l16, int le16,
    const int32_t* __restrict__ m16, const int32_t* __restrict__ aux16,
    const int32_t* __restrict__ r2_16, u32 mp, int k, u32* tab) {
  const int row = live ? e : 0;
  GroupField<TPI, NW, MONT> f;
  u32 b[NW], res[NW], x[NW];
  group_load<TPI, NW>(base + (size_t)row * l16, l16, k, live, b);
  f.enter(m16, aux16, r2_16, mp, k, b, res, x);
  const int32_t* ex = exp + (size_t)row * le16;
  const int n_bits = 16 * le16;

  if (WIN4) {
    f.power_table(tab, res, b, x);
    const u32* mine = tab + threadIdx.x;
    const int bd = blockDim.x;
    for (int j = n_bits / 4 - 1; j >= 0; --j) {
      const u32 win = ((u32)ex[(4 * j) >> 4] >> ((4 * j) & 15)) & 0xFu;
      for (int s = 0; s < 4; ++s) f.mul(res, res, res);
      // oblivious select: every entry read, one kept by mask
#pragma unroll
      for (int w = 0; w < NW; ++w) x[w] = 0;
      for (int t = 0; t < 16; ++t) {
        const u32 mask = 0u - (u32)(win == (u32)t);
#pragma unroll
        for (int w = 0; w < NW; ++w) x[w] |= mine[(t * NW + w) * bd] & mask;
      }
      f.mul(res, x, res);
    }
  } else {
    for (int j = 0; j < n_bits; ++j) {
      const u32 mask = 0u - (((u32)ex[j >> 4] >> (j & 15)) & 1u);
      f.mul(res, b, x);
#pragma unroll
      for (int w = 0; w < NW; ++w) res[w] = (x[w] & mask) | (res[w] & ~mask);
      f.mul(b, b, b);
    }
  }
  f.leave(res, x);
  if (live) group_store<TPI, NW>(res, l16, out + (size_t)e * l16);
}

template <int TPI, int NW, bool WIN4, bool MONT>
__global__ void modexp_kernel(const int32_t* __restrict__ base,
                              const int32_t* __restrict__ exp,
                              int32_t* __restrict__ out, int B, int l16,
                              int le16, const int32_t* __restrict__ m16,
                              const int32_t* __restrict__ aux16,
                              const int32_t* __restrict__ r2_16, u32 mp,
                              int k) {
  extern __shared__ u32 tab[];  // WIN4: 16 entries x NW words x blockDim
  const int e = (int)((blockIdx.x * blockDim.x + threadIdx.x) / TPI);
  modexp_element<TPI, NW, WIN4, MONT>(base, exp, out, e, e < B, l16, le16,
                                      m16, aux16, r2_16, mp, k, tab);
}

// Per-row moduli (the serving path's launches, one tenant key per row):
// element e reduces mod row t = midx[e] of a table of T moduli.  Replaces
// the reference's kernels/ops.py::modexp_rows (jitted common.modexp2d_win4
// and modexp2d with per-row m and mu operands; not a Pallas kernel).
//   Montgomery (default, every table modulus odd): m16, aux16 (R mod m)
//   and r2_16 (R^2 mod m) are T rows of 2k limbs, mp (T int32) holds each
//   row's -m^{-1} mod 2^32, loaded per element;
//   Barrett (REPRO_REDUCE_IMPL=barrett, or a table with an even modulus):
//   m16 T rows of 2k limbs, aux16 (mu) T rows of 2(k+1) limbs.
// Bound: modexp_kernel's, per element; the serving path's moduli are the
// tenants' n^2 (k = 128), where a 64-bit-exponent win4 element needs
// about 6.3M IMADs (Montgomery; 5.2M with the squaring saving, which no
// body takes) against about 1 KB of traffic: compute-bound by a factor of
// about 1,000.
// Design: the ladders are modexp_kernel's, constant-time alike (the
// table row an element reads depends on its tenant, never on exponent
// bits); a table row read by every element of its tenant stays in L2.
// At n^2 the 16-entry win4 table takes 8 KB of shared memory per
// integer whatever the group size, so at most 24-26 integers are
// resident per SM.  The Montgomery bodies' group size (geometry.TPI: 16
// threads, 8 words a lane, 71 registers) is the fastest of TPI 8, 16 and
// 32 in chip_smoke.py's sweep at S1's three shapes, where shared memory
// still caps its residency at 24 integers (registers would allow 56).
template <int TPI, int NW, bool WIN4, bool MONT>
__global__ void modexp_rows_kernel(const int32_t* __restrict__ base,
                                   const int32_t* __restrict__ exp,
                                   int32_t* __restrict__ out, int B,
                                   int l16, int le16,
                                   const int32_t* __restrict__ m16,
                                   const int32_t* __restrict__ aux16,
                                   const int32_t* __restrict__ r2_16,
                                   const int32_t* __restrict__ mp,
                                   const int32_t* __restrict__ midx, int k) {
  extern __shared__ u32 tab[];  // WIN4: 16 entries x NW words x blockDim
  const int e = (int)((blockIdx.x * blockDim.x + threadIdx.x) / TPI);
  const bool live = e < B;
  const size_t t = (size_t)midx[live ? e : 0];
  const int32_t* m_row = m16 + t * 2 * k;
  if constexpr (MONT)
    modexp_element<TPI, NW, WIN4, true>(
        base, exp, out, e, live, l16, le16, m_row, aux16 + t * 2 * k,
        r2_16 + t * 2 * k, (u32)mp[t], k, tab);
  else
    modexp_element<TPI, NW, WIN4, false>(
        base, exp, out, e, live, l16, le16, m_row, aux16 + t * 2 * (k + 1),
        m_row, 0u, k, tab);
}

// (threads per element, words per thread) of every instantiation: each
// body's group size at every width up to 128 words, and the other group
// sizes timed against it at k = 64; the Barrett win4 body and the per-row
// bodies have lists of their own.  Mirror
// repro_torch.kernels.geometry.SHAPES.
#define MODEXP_SHAPES(X) \
  X(8, 1) X(8, 2) X(8, 4) X(8, 8) X(8, 16) X(4, 16) X(16, 4)
#define MODEXP_BARRETT_WIN4_SHAPES(X) \
  X(16, 1) X(16, 2) X(16, 4) X(16, 8) X(8, 8) X(4, 16)
// the per-row bodies: their group size at every width, and for the
// Montgomery bodies the other group sizes timed against it at k = 128
#define MODEXP_ROWS_WIN4_SHAPES(X) X(16, 1) X(16, 2) X(16, 4) X(16, 8)
#define MODEXP_ROWS_BINARY_SHAPES(X) \
  X(8, 1) X(8, 2) X(8, 4) X(8, 8) X(8, 16)
#define MODEXP_ROWS_MONT_SHAPES(X) \
  X(16, 1) X(16, 2) X(16, 4) X(16, 8) X(8, 16) X(32, 4)

// The widths and launch geometry both launchers take.
static bool valid_launch(int B, int l16, int le16, int k, int tpi, int nw,
                         int threads, int blocks) {
  return k >= 1 && k <= MAXW && l16 <= 2 * k && le16 >= 1 && threads >= 32 &&
         threads <= 1024 && threads % 32 == 0 && tpi * nw >= k &&
         (long long)blocks * threads >= (long long)B * tpi;
}

template <int TPI, int NW, bool WIN4, bool MONT>
static int launch(const int32_t* base, const int32_t* exp, int32_t* out,
                  int B, int l16, int le16, const int32_t* m16,
                  const int32_t* aux16, const int32_t* r2_16, u32 mp, int k,
                  int threads, int blocks, int smem, cudaStream_t s) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        modexp_kernel<TPI, NW, WIN4, MONT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  modexp_kernel<TPI, NW, WIN4, MONT><<<blocks, threads, smem, s>>>(
      base, exp, out, B, l16, le16, m16, aux16, r2_16, mp, k);
  return (int)cudaGetLastError();
}

// base, out: (B, l16) int32 radix-2^16 rows; exp: (B, le16) rows; m16 and
// r2_16: 2k limbs; aux16: mu as 2(k+1) limbs (Barrett) or r1 as 2k limbs
// (Montgomery, R = 2^{32k}); mp = -m^{-1} mod 2^32 (r2_16 and mp are read
// by Montgomery only).  tpi, nw, threads, blocks and smem are the launch
// geometry (geometry.launch_geometry).  Returns the CUDA error of the
// launch (0 on success).
extern "C" int modexp_launch(const int32_t* base, const int32_t* exp,
                             int32_t* out, int B, int l16, int le16,
                             const int32_t* m16, const int32_t* aux16,
                             const int32_t* r2_16, unsigned int mp, int k,
                             int mont, int win4, int tpi, int nw, int threads,
                             int blocks, int smem, void* stream) {
  if (!valid_launch(B, l16, le16, k, tpi, nw, threads, blocks))
    return (int)cudaErrorInvalidValue;
  if (B <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
#define BODY(T, N, W, M)                                                  \
  launch<T, N, W, M>(base, exp, out, B, l16, le16, m16, aux16, r2_16, mp, \
                     k, threads, blocks, smem, s)
#define LAUNCH(T, N)                                                       \
  if (tpi == T && nw == N)                                                \
    return !mont ? BODY(T, N, false, false)                               \
                 : (win4 ? BODY(T, N, true, true) : BODY(T, N, false, true));
#define LAUNCH_BARRETT_WIN4(T, N) \
  if (tpi == T && nw == N) return BODY(T, N, true, false);
  if (mont || !win4) {
    MODEXP_SHAPES(LAUNCH)
  } else {
    MODEXP_BARRETT_WIN4_SHAPES(LAUNCH_BARRETT_WIN4)
  }
#undef LAUNCH
#undef LAUNCH_BARRETT_WIN4
#undef BODY
  return (int)cudaErrorInvalidValue;
}

template <int TPI, int NW, bool WIN4, bool MONT>
static int launch_rows(const int32_t* base, const int32_t* exp, int32_t* out,
                       int B, int l16, int le16, const int32_t* m16,
                       const int32_t* aux16, const int32_t* r2_16,
                       const int32_t* mp, const int32_t* midx, int k,
                       int threads, int blocks, int smem, cudaStream_t s) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        modexp_rows_kernel<TPI, NW, WIN4, MONT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  modexp_rows_kernel<TPI, NW, WIN4, MONT><<<blocks, threads, smem, s>>>(
      base, exp, out, B, l16, le16, m16, aux16, r2_16, mp, midx, k);
  return (int)cudaGetLastError();
}

// modexp_launch with per-row moduli: m16, aux16 and r2_16 are tables of T
// rows (aux16: R mod m of 2k limbs, Montgomery, or mu of 2(k+1) limbs,
// Barrett; r2_16 and mp, T int32 of -m^{-1} mod 2^32, are read by
// Montgomery only), midx (B int32, each in [0, T)) names each row's
// modulus.  The caller checks midx.
extern "C" int modexp_rows_launch(const int32_t* base, const int32_t* exp,
                                  int32_t* out, int B, int l16, int le16,
                                  const int32_t* m16, const int32_t* aux16,
                                  const int32_t* r2_16, const int32_t* mp,
                                  const int32_t* midx, int k, int mont,
                                  int win4, int tpi, int nw, int threads,
                                  int blocks, int smem, void* stream) {
  if (!valid_launch(B, l16, le16, k, tpi, nw, threads, blocks))
    return (int)cudaErrorInvalidValue;
  if (B <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
#define ROWS(T, N, W, M)                                                  \
  if (tpi == T && nw == N)                                               \
    return launch_rows<T, N, W, M>(base, exp, out, B, l16, le16, m16,    \
                                   aux16, r2_16, mp, midx, k, threads,   \
                                   blocks, smem, s);
#define ROWS_WIN4(T, N) ROWS(T, N, true, false)
#define ROWS_BINARY(T, N) ROWS(T, N, false, false)
#define ROWS_MONT_WIN4(T, N) ROWS(T, N, true, true)
#define ROWS_MONT_BINARY(T, N) ROWS(T, N, false, true)
  if (mont && win4) {
    MODEXP_ROWS_MONT_SHAPES(ROWS_MONT_WIN4)
  } else if (mont) {
    MODEXP_ROWS_MONT_SHAPES(ROWS_MONT_BINARY)
  } else if (win4) {
    MODEXP_ROWS_WIN4_SHAPES(ROWS_WIN4)
  } else {
    MODEXP_ROWS_BINARY_SHAPES(ROWS_BINARY)
  }
#undef ROWS_MONT_BINARY
#undef ROWS_MONT_WIN4
#undef ROWS_BINARY
#undef ROWS_WIN4
#undef ROWS
  return (int)cudaErrorInvalidValue;
}
