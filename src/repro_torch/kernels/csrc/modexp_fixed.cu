// modexp_fixed: base^e mod m over a batch, one host-known exponent e
// shared by the whole batch (Paillier's r^n in encryption and c^lambda in
// decryption, in each CRT half space).
//
// Replaces the TPU kernel repro/kernels/modexp.py::modexp_fixed_pallas and
// its two bodies:
//   _modexp_fixed_mont_kernel    -> modexp_fixed_mont_kernel<TPI, NW> (default)
//   _modexp_fixed_barrett_kernel -> modexp_fixed_barrett_kernel
//
// Bound on this card: 32-bit integer multiply-adds.  With n_win 4-bit
// windows the ladder does 4 n_win squarings and n_win + 16 other
// Montgomery products (the table, domain enter and leave).  A product
// needs k^2 + k word products for the reduction and k^2 for the product,
// k(k+1)/2 when it is a squaring; two IMAD results per word product.  On
// the main path e is n or lambda reduced mod phi(p^2), about 2048 bits
// (512 windows), at k = 64 words: about 34M IMADs per element.  The
// batches are small (B = Nk = 192 per call on the main path), so what
// bounds a launch in practice is the latency of one element's ~2,600
// dependent products, not the card's multiply-add rate.  No body takes
// the squaring saving.
//
// Design of the Montgomery body: a warp per element (TPI = 32 at every
// width: NW = 1, 2 or 4 words per lane), in one-warp blocks spread over
// the SMs, with every operand in registers (limbs.cuh mont_mul).  One
// launch takes both CRT halves of a Paillier exponentiation (the rows of
// p^2 and of q^2, each row with its half's modulus and window schedule),
// so the main path's B = 2 x 192 runs as 384 warps in one launch where
// two launches of 192 would each leave most of the card idle.  The 16-entry power table lives in
// dynamic shared memory, entry t word w of thread i at (t NW + w) blockDim
// + i: each thread reads back only its own words, and a warp's loads hit
// 32 banks.  The MSB-first window schedule comes in as a device array at
// run time (the reference compiled one kernel per exponent value); since
// the exponent is key-constant and known to the host, the table is
// indexed by the window value directly.  An empty schedule (e = 0) is
// answered by the wrapper without a launch.  Groups past the batch edge
// run on a zero row and store nothing, so every shuffle sees the full
// warp.
//
// The Barrett body keeps the one-thread design: one thread per element,
// rows and the table in per-thread local memory, modulus and mu broadcast
// from shared memory.
#include "limbs.cuh"

using namespace limbs;

// One modulus per CRT half: rows [0, B0) of the batch run against half
// 0, rows [B0, B) against half 1 (B0 = B for a single modulus).  Both
// halves have the same width k and window count n_win (the shorter
// schedule is padded in front with zero windows, which keep the ladder's
// 1); windows0/1 are each half's schedule.
struct Half {
  const int32_t* m16;    // 2k limbs
  const int32_t* r1_16;  // R mod m, 2k limbs
  const int32_t* r2_16;  // R^2 mod m, 2k limbs
  const int32_t* windows;
  u32 mp;
};

template <int TPI, int NW>
__global__ void modexp_fixed_mont_kernel(const int32_t* __restrict__ base,
                                         int32_t* __restrict__ out, int B,
                                         int B0, int l16, int n_win,
                                         Half h0, Half h1, int k) {
  extern __shared__ u32 tab[];  // 16 entries x NW words x blockDim
  const int e = (int)((blockIdx.x * blockDim.x + threadIdx.x) / TPI);
  const bool live = e < B;
  const Half h = (live && e >= B0) ? h1 : h0;
  u32 m[NW], b[NW], res[NW], x[NW];
  group_load<TPI, NW>(h.m16, 2 * k, k, true, m);
  group_load<TPI, NW>(h.r2_16, 2 * k, k, true, x);
  group_load<TPI, NW>(base + (size_t)(live ? e : 0) * l16, l16, k, live, b);
  mont_mul<TPI, NW>(b, x, m, h.mp, k, b);             // base into the domain
  group_load<TPI, NW>(h.r1_16, 2 * k, k, true, res);  // 1 in the domain

  u32* mine = tab + threadIdx.x;
  const int bd = blockDim.x;
#pragma unroll
  for (int w = 0; w < NW; ++w) {
    mine[w * bd] = res[w];
    mine[(NW + w) * bd] = b[w];
    x[w] = b[w];
  }
  for (int t = 2; t < 16; ++t) {
    mont_mul<TPI, NW>(x, b, m, h.mp, k, x);
#pragma unroll
    for (int w = 0; w < NW; ++w) mine[(t * NW + w) * bd] = x[w];
  }
  for (int j = 0; j < n_win; ++j) {
    const int win = h.windows[j];  // key-constant, host-known
    for (int s = 0; s < 4; ++s) mont_mul<TPI, NW>(res, res, m, h.mp, k, res);
#pragma unroll
    for (int w = 0; w < NW; ++w) x[w] = mine[(win * NW + w) * bd];
    mont_mul<TPI, NW>(res, x, m, h.mp, k, res);
  }
  group_one<TPI, NW>(x);  // leave the domain: REDC(res) = res * 1
  mont_mul<TPI, NW>(res, x, m, h.mp, k, res);
  if (live) group_store<TPI, NW>(res, l16, out + (size_t)e * l16);
}

__global__ void modexp_fixed_barrett_kernel(
    const int32_t* __restrict__ base, int32_t* __restrict__ out, int B,
    int l16, const int32_t* __restrict__ windows, int n_win,
    const int32_t* __restrict__ m16, const int32_t* __restrict__ mu16,
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
  u32 res[MAXW], tmp[MAXW];
  u32 tab[16 * MAXW];
  load_row(base + (size_t)e * l16, l16, tmp, k);
  f.reduce(tmp, tab + k);
  for (int i = 0; i < k; ++i) tab[i] = (i == 0);
  for (int t = 2; t < 16; ++t) f.mulmod(tab + (t - 1) * k, tab + k, tab + t * k);
  for (int i = 0; i < k; ++i) res[i] = tab[i];
  for (int w = 0; w < n_win; ++w) {
    const int win = windows[w];  // key-constant, host-known
    for (int s = 0; s < 4; ++s) f.mulmod(res, res, res);
    f.mulmod(res, tab + win * k, res);
  }
  store_row(res, l16, out + (size_t)e * l16);
}

// (threads per element, words per thread) of every Montgomery
// instantiation: TPI = 32 at every width up to 128 words, and the other
// group sizes timed against it at k = 64.  Mirrors
// repro_torch.kernels.geometry.SHAPES["modexp_fixed"].
#define MODEXP_FIXED_SHAPES(X) X(32, 1) X(32, 2) X(32, 4) X(16, 4) X(8, 8)

template <int TPI, int NW>
static int launch_mont(const int32_t* base, int32_t* out, int B, int B0,
                       int l16, int n_win, const Half& h0, const Half& h1,
                       int k, int threads, int blocks, int smem,
                       cudaStream_t s) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        modexp_fixed_mont_kernel<TPI, NW>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  modexp_fixed_mont_kernel<TPI, NW><<<blocks, threads, smem, s>>>(
      base, out, B, B0, l16, n_win, h0, h1, k);
  return (int)cudaGetLastError();
}

// base, out: (B, l16) int32 radix-2^16 rows, rows [0, B0) against half 0
// and [B0, B) against half 1; each half: its windows (n_win int32 values
// in [0, 16), most significant first), m16, aux16, r2_16 and mp as for
// modexp_launch.  Barrett takes one modulus (B0 = B, half 0).  The launch
// geometry as for modexp_launch.  Returns the CUDA error of the launch (0
// on success).
extern "C" int modexp_fixed_launch(
    const int32_t* base, int32_t* out, int B, int B0, int l16, int n_win,
    const int32_t* windows0, const int32_t* m16_0, const int32_t* aux16_0,
    const int32_t* r2_16_0, unsigned int mp0, const int32_t* windows1,
    const int32_t* m16_1, const int32_t* aux16_1, const int32_t* r2_16_1,
    unsigned int mp1, int k, int mont, int tpi, int nw, int threads,
    int blocks, int smem, void* stream) {
  if (k < 1 || k > MAXW || l16 > 2 * k || n_win < 1 || B0 < 0 || B0 > B ||
      threads < 32 || threads > 1024 || threads % 32 != 0 || tpi < 1 ||
      (long long)blocks * threads < (long long)B * tpi)
    return (int)cudaErrorInvalidValue;
  if (B <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (mont) {
    if (tpi * nw < k) return (int)cudaErrorInvalidValue;
    const Half h0{m16_0, aux16_0, r2_16_0, windows0, mp0};
    const Half h1{m16_1, aux16_1, r2_16_1, windows1, mp1};
#define LAUNCH(T, N)                                                       \
  if (tpi == T && nw == N)                                                \
    return launch_mont<T, N>(base, out, B, B0, l16, n_win, h0, h1, k,     \
                             threads, blocks, smem, s);
    MODEXP_FIXED_SHAPES(LAUNCH)
#undef LAUNCH
    return (int)cudaErrorInvalidValue;
  }
  if (tpi != 1 || B0 != B) return (int)cudaErrorInvalidValue;
  modexp_fixed_barrett_kernel<<<blocks, threads, 0, s>>>(
      base, out, B, l16, windows0, n_win, m16_0, aux16_0, k);
  return (int)cudaGetLastError();
}
