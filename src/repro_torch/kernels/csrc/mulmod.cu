// mulmod: (a * b) mod m over a batch of big integers, one modulus.
//
// Replaces the TPU kernel repro/kernels/limb_mulmod.py::mulmod_pallas
// (body _mulmod_kernel -> common.mulmod2d: radix-256 convolution, carry,
// Barrett with two more convolutions).
//
// Bound on this card: 32-bit integer multiply-adds.  Per element a k-word
// product is k^2 word products; Barrett needs at least the upper k + 1
// words of q1 * mu ((k+1)^2 - k(k-1)/2 word products) and the low k + 1
// words of q3 * m (about k(k+1)/2 + k), two IMAD results per word
// product.  At the main path's n^2 width (k = 128) that is about 66k IMADs
// per element against 1.5 KB of operand traffic: far on the compute side
// of the card's roofline.  Most of the main path's launches are small
// (B = 192 for the ciphertext sum, the blinding, the CRT recombination and
// the reductions into the half spaces), and there what bounds a launch in
// practice is the latency of one element's chain of dependent products.
//
// Design: a group of TPI threads per element (limbs.cuh barrett_mul),
// each lane holding NW = ceil(k / TPI) words, rounded up to a power of
// two, of a, b, m, mu and the running sums in registers: the element's
// latency is about 3k + 2 scan steps of NW multiply-adds each instead of
// one thread's ~3k^2 dependent word products through local memory.  The
// scans do all of q1 * mu and all of q3 * m, about 1.5 times the least
// work.  32-bit words (the reference's radix 256 was forced by the TPU's
// missing 64-bit integer path).  Barrett is exact for any a * b <
// 2^{64k}, odd or even m, so full-width operands that exceed m
// (paillier_vec._reduce_into feeds such chunks) reduce correctly; operands
// are never cut to the modulus width.  a and b are read with row strides,
// so a column slice needs no copy and a constant b is one row read by
// every group (stride 0).  Groups past the batch edge run on a zero row
// and store nothing, so every shuffle sees the full warp.
#include "limbs.cuh"

using namespace limbs;

// One group's element e: out row e = (a row e * b row e) mod m, with m
// and mu = floor(2^{64k}/m) given as 2k and 2(k+1) radix-2^16 limbs.
template <int TPI, int NW>
__device__ __forceinline__ void mulmod_element(
    const int32_t* __restrict__ a, long long sa,
    const int32_t* __restrict__ b, long long sb, int32_t* __restrict__ out,
    int e, bool live, int l16, const int32_t* __restrict__ m16,
    const int32_t* __restrict__ mu16, int k) {
  const long long row = live ? e : 0;
  u32 m[NW], mu[NW], x[NW], y[NW], muH;
  group_load<TPI, NW>(m16, 2 * k, k, true, m);
  group_load_mu<TPI, NW>(mu16, k, mu, muH);
  group_load<TPI, NW>(a + row * sa, l16, k, live, x);
  group_load<TPI, NW>(b + row * sb, l16, k, live, y);
  barrett_mul<TPI, NW>(x, y, m, mu, muH, k, x);
  if (live) group_store<TPI, NW>(x, l16, out + (size_t)e * l16);
}

template <int TPI, int NW>
__global__ void mulmod_kernel(const int32_t* __restrict__ a, long long sa,
                              const int32_t* __restrict__ b, long long sb,
                              int32_t* __restrict__ out, int B, int l16,
                              const int32_t* __restrict__ m16,
                              const int32_t* __restrict__ mu16, int k) {
  const int e = (int)((blockIdx.x * blockDim.x + threadIdx.x) / TPI);
  mulmod_element<TPI, NW>(a, sa, b, sb, out, e, e < B, l16, m16, mu16, k);
}

// Per-row moduli (the serving path's launches, one tenant key per row):
// element e reduces mod row t = midx[e] of a table of T moduli.  Replaces
// the reference's kernels/ops.py::mulmod_rows (jitted common.mulmod2d with
// per-row m and mu operands; not a Pallas kernel).  A table row read by
// every element of its tenant stays in L2, where a materialized (B, 2k)
// modulus array would be a second operand stream as wide as a and b.
// Every thread of a group reads the same midx[e]; groups past the batch
// edge read row 0.
//
// Bound: per element a k-word product and its reduction, about 2k^2 word
// products (two REDCs: 2(k^2 + k) more) against 3 * 8k bytes of a, b and
// out: at n^2 (k = 128) about 130k IMADs per 3 KB, compute-bound.  The
// serving path's launches are small (B = 576 ... 4,608), so one element's
// chain of dependent scans sets a launch's time.
//
//   Montgomery (every table modulus odd): two cooperative CIOS products
//   (limbs.cuh mont_mul), 2k scan steps against Barrett's 3k + 2, with
//   row t's mp = -m^{-1} mod 2^32 (T int32) and R^2 mod m (aux16: T rows
//   of 2k limbs), R = 2^{32k}, from the table the per-row ModExp reads.
//   The order is t = REDC(a * (R^2 mod m)) = a R mod m, then REDC(t * b)
//   = a b mod m.  mont_mul needs its product below R m: a < 2^{16 l16} <=
//   R and R^2 mod m < m give a (R^2 mod m) < R m, and t < m with b < R
//   gives t b < R m, for any operands, reduced or not (the rows contract
//   takes any a, b < 2^{16 l16}).  The other order, REDC(a b) first,
//   would break that bound once a b >= R m.  Both results are canonical.
//   Barrett (a table with an even modulus): limbs.cuh barrett_mul with
//   row t's mu = floor(2^{64k} / m) (aux16: T rows of 2(k+1) limbs), the
//   body of mulmod_kernel; mp is not read.
template <int TPI, int NW, bool MONT>
__global__ void mulmod_rows_kernel(const int32_t* __restrict__ a,
                                   long long sa,
                                   const int32_t* __restrict__ b,
                                   long long sb, int32_t* __restrict__ out,
                                   int B, int l16,
                                   const int32_t* __restrict__ m16,
                                   const int32_t* __restrict__ aux16,
                                   const int32_t* __restrict__ mp,
                                   const int32_t* __restrict__ midx, int k) {
  const int e = (int)((blockIdx.x * blockDim.x + threadIdx.x) / TPI);
  const bool live = e < B;
  const size_t t = (size_t)midx[live ? e : 0];
  if constexpr (MONT) {
    const long long row = live ? e : 0;
    u32 m[NW], r2[NW], x[NW], y[NW];
    group_load<TPI, NW>(m16 + t * 2 * k, 2 * k, k, true, m);
    group_load<TPI, NW>(aux16 + t * 2 * k, 2 * k, k, true, r2);
    group_load<TPI, NW>(a + row * sa, l16, k, live, x);
    group_load<TPI, NW>(b + row * sb, l16, k, live, y);
    const u32 mpt = (u32)mp[t];
    mont_mul<TPI, NW>(x, r2, m, mpt, k, x);  // a R mod m
    mont_mul<TPI, NW>(x, y, m, mpt, k, x);   // a b mod m
    if (live) group_store<TPI, NW>(x, l16, out + (size_t)e * l16);
  } else {
    mulmod_element<TPI, NW>(a, sa, b, sb, out, e, live, l16,
                            m16 + t * 2 * k, aux16 + t * 2 * (k + 1), k);
  }
}

// (threads per element, words per thread) of every instantiation: each
// timed group size at every width up to 128 words, for both kernels and
// both per-row bodies.  Mirrors repro_torch.kernels.geometry.SHAPES
// ["mulmod"], ["mulmod_rows[montgomery]"] and ["mulmod_rows[barrett]"].
#define MULMOD_SHAPES(X)                                               \
  X(32, 1) X(32, 2) X(32, 4) X(16, 1) X(16, 2) X(16, 4) X(16, 8) X(8, 1) \
  X(8, 2) X(8, 4) X(8, 8) X(8, 16)

// The widths, strides and launch geometry both launchers take.
static bool valid_launch(int B, int l16, long long sa, long long sb, int k,
                         int tpi, int nw, int threads, int blocks) {
  return k >= 1 && k <= MAXW && l16 <= 2 * k && sa >= 0 && sb >= 0 &&
         threads >= 32 && threads <= 1024 && threads % 32 == 0 &&
         tpi * nw >= k && (long long)blocks * threads >= (long long)B * tpi;
}

// a, b: (B, l16) int32 radix-2^16 rows, row i at a + i * sa and b + i * sb
// (sb = 0: one row b for every a); out: (B, l16) contiguous; m16: 2k
// limbs; mu16: 2(k+1) limbs.  tpi, nw, threads and blocks are the launch
// geometry (geometry.launch_geometry).  Returns the CUDA error of the
// launch (0 on success).
extern "C" int mulmod_launch(const int32_t* a, long long sa, const int32_t* b,
                             long long sb, int32_t* out, int B, int l16,
                             const int32_t* m16, const int32_t* mu16, int k,
                             int tpi, int nw, int threads, int blocks,
                             void* stream) {
  if (!valid_launch(B, l16, sa, sb, k, tpi, nw, threads, blocks))
    return (int)cudaErrorInvalidValue;
  if (B <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
#define LAUNCH(T, N)                                                 \
  if (tpi == T && nw == N) {                                        \
    mulmod_kernel<T, N><<<blocks, threads, 0, s>>>(a, sa, b, sb, out, \
                                                   B, l16, m16, mu16, k); \
    return (int)cudaGetLastError();                                 \
  }
  MULMOD_SHAPES(LAUNCH)
#undef LAUNCH
  return (int)cudaErrorInvalidValue;
}

// mulmod_launch with per-row moduli: m16 (T rows of 2k limbs) is a
// table, midx (B int32, each in [0, T)) names each row's modulus; mont
// picks the body: Montgomery (aux16: R^2 mod m, T rows of 2k limbs; mp: T
// int32 of -m^{-1} mod 2^32; every modulus odd) or Barrett (aux16: mu, T
// rows of 2(k+1) limbs; mp unused).  The caller checks midx.
extern "C" int mulmod_rows_launch(const int32_t* a, long long sa,
                                  const int32_t* b, long long sb,
                                  int32_t* out, int B, int l16,
                                  const int32_t* m16, const int32_t* aux16,
                                  const int32_t* mp, const int32_t* midx,
                                  int k, int mont, int tpi, int nw,
                                  int threads, int blocks, void* stream) {
  if (!valid_launch(B, l16, sa, sb, k, tpi, nw, threads, blocks))
    return (int)cudaErrorInvalidValue;
  if (mont && mp == nullptr) return (int)cudaErrorInvalidValue;
  if (B <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
#define BODY(T, N, M)                                                   \
  mulmod_rows_kernel<T, N, M><<<blocks, threads, 0, s>>>(              \
      a, sa, b, sb, out, B, l16, m16, aux16, mp, midx, k)
#define LAUNCH(T, N)                                                    \
  if (tpi == T && nw == N) {                                           \
    if (mont)                                                          \
      BODY(T, N, true);                                                \
    else                                                               \
      BODY(T, N, false);                                               \
    return (int)cudaGetLastError();                                    \
  }
  MULMOD_SHAPES(LAUNCH)
#undef LAUNCH
#undef BODY
  return (int)cudaErrorInvalidValue;
}
