// modexp_fixed: base^e mod m over a batch, one host-known exponent e
// shared by the whole batch (Paillier's r^n in encryption and c^lambda in
// decryption, in each CRT half space).
//
// Replaces the TPU kernel repro/kernels/modexp.py::modexp_fixed_pallas and
// its two bodies, one template over the product:
//   _modexp_fixed_mont_kernel    -> modexp_fixed_kernel<TPI, NW, true> (default)
//   _modexp_fixed_barrett_kernel -> modexp_fixed_kernel<TPI, NW, false>
//
// Bound on this card: 32-bit integer multiply-adds.  With n_win 4-bit
// windows the ladder does 4 n_win squarings and n_win + 14 other products
// (the table), Montgomery two more (domain enter and leave), Barrett one
// more (the base's reduction).  A Montgomery product needs k^2 + k word
// products for the reduction and k^2 for the product, k(k+1)/2 when it is
// a squaring; a Barrett reduction at least (k+1)^2 - k(k-1)/2 + k(k+1)/2 + k
// (mulmod.cu); two IMAD results per word product.  On the main path e is
// n or lambda reduced mod phi(p^2), about 2048 bits (512 windows), at k =
// 64 words: about 34M IMADs per element.  The batches are small (B = Nk =
// 192 per half on the main path), so what bounds a launch in practice is
// the latency of one element's ~2,600 dependent products, not the card's
// multiply-add rate.  No body takes the squaring saving.
//
// Design: a warp per element (TPI = 32 at every width: NW = 1, 2 or 4
// words per lane), in one-warp blocks spread over the SMs, with every
// operand in registers (limbs.cuh mont_mul or barrett_mul).  The Barrett
// body reduces the base first (base * 1) and needs no domain: its
// products take any operands below 2^{32k}, odd or even m.  One launch
// may take both CRT halves of a Paillier exponentiation (the rows of p^2
// and of q^2, each row with its half's modulus and window schedule), so
// the main path's B = 2 x 192 runs as 384 warps in one launch where two
// launches of 192 would each leave most of the card idle.  The 16-entry
// power table lives in dynamic shared memory, entry t word w of thread i
// at (t NW + w) blockDim + i: each thread reads back only its own words,
// and a warp's loads hit 32 banks.  The MSB-first window schedule comes in
// as a device array at run time (the reference compiled one kernel per
// exponent value); since the exponent is key-constant and known to the
// host, the table is indexed by the window value directly.  An empty
// schedule (e = 0) is answered by the wrapper without a launch.  Groups
// past the batch edge run on a zero row and store nothing, so every
// shuffle sees the full warp.
#include "limbs.cuh"

using namespace limbs;

// One modulus per CRT half: rows [0, B0) of the batch run against half
// 0, rows [B0, B) against half 1 (B0 = B for a single modulus).  Both
// halves have the same width k and window count n_win (the shorter
// schedule is padded in front with zero windows, which keep the ladder's
// 1); windows0/1 are each half's schedule.
struct Half {
  const int32_t* m16;      // 2k limbs
  const int32_t* aux16;    // R mod m (2k limbs) or mu (2(k+1) limbs)
  const int32_t* r2_16;    // R^2 mod m, 2k limbs (Montgomery)
  const int32_t* windows;
  u32 mp;                  // -m^{-1} mod 2^32 (Montgomery)
};

template <int TPI, int NW, bool MONT>
__global__ void modexp_fixed_kernel(const int32_t* __restrict__ base,
                                    int32_t* __restrict__ out, int B, int B0,
                                    int l16, int n_win, Half h0, Half h1,
                                    int k) {
  extern __shared__ u32 tab[];  // 16 entries x NW words x blockDim
  const int e = (int)((blockIdx.x * blockDim.x + threadIdx.x) / TPI);
  const bool live = e < B;
  const Half h = (live && e >= B0) ? h1 : h0;
  GroupField<TPI, NW, MONT> f;
  u32 b[NW], res[NW], x[NW];
  group_load<TPI, NW>(base + (size_t)(live ? e : 0) * l16, l16, k, live, b);
  f.enter(h.m16, h.aux16, h.r2_16, h.mp, k, b, res, x);
  f.power_table(tab, res, b, x);
  const u32* mine = tab + threadIdx.x;
  const int bd = blockDim.x;
  for (int j = 0; j < n_win; ++j) {
    const int win = h.windows[j];  // key-constant, host-known
    for (int s = 0; s < 4; ++s) f.mul(res, res, res);
#pragma unroll
    for (int w = 0; w < NW; ++w) x[w] = mine[(win * NW + w) * bd];
    f.mul(res, x, res);
  }
  f.leave(res, x);
  if (live) group_store<TPI, NW>(res, l16, out + (size_t)e * l16);
}

// (threads per element, words per thread) of every instantiation of both
// bodies: TPI = 32 at every width up to 128 words, and the other group
// sizes timed against it at k = 64.  Mirrors
// repro_torch.kernels.geometry.SHAPES["modexp_fixed"].
#define MODEXP_FIXED_SHAPES(X) X(32, 1) X(32, 2) X(32, 4) X(16, 4) X(8, 8)

template <int TPI, int NW, bool MONT>
static int launch(const int32_t* base, int32_t* out, int B, int B0, int l16,
                  int n_win, const Half& h0, const Half& h1, int k,
                  int threads, int blocks, int smem, cudaStream_t s) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        modexp_fixed_kernel<TPI, NW, MONT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  modexp_fixed_kernel<TPI, NW, MONT><<<blocks, threads, smem, s>>>(
      base, out, B, B0, l16, n_win, h0, h1, k);
  return (int)cudaGetLastError();
}

// base, out: (B, l16) int32 radix-2^16 rows, rows [0, B0) against half 0
// and [B0, B) against half 1; each half: its windows (n_win int32 values
// in [0, 16), most significant first), m16, aux16 (Montgomery: R mod m,
// 2k limbs; Barrett: mu = floor(2^{64k} / m), 2(k+1) limbs), r2_16 (R^2
// mod m, Montgomery only) and mp (-m^{-1} mod 2^32, Montgomery only).
// tpi, nw, threads, blocks and smem are the launch geometry
// (geometry.launch_geometry).  Returns the CUDA error of the launch (0 on
// success).
extern "C" int modexp_fixed_launch(
    const int32_t* base, int32_t* out, int B, int B0, int l16, int n_win,
    const int32_t* windows0, const int32_t* m16_0, const int32_t* aux16_0,
    const int32_t* r2_16_0, unsigned int mp0, const int32_t* windows1,
    const int32_t* m16_1, const int32_t* aux16_1, const int32_t* r2_16_1,
    unsigned int mp1, int k, int mont, int tpi, int nw, int threads,
    int blocks, int smem, void* stream) {
  if (k < 1 || k > MAXW || l16 > 2 * k || n_win < 1 || B0 < 0 || B0 > B ||
      threads < 32 || threads > 1024 || threads % 32 != 0 || tpi * nw < k ||
      (long long)blocks * threads < (long long)B * tpi)
    return (int)cudaErrorInvalidValue;
  if (B <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  const Half h0{m16_0, aux16_0, r2_16_0, windows0, mp0};
  const Half h1{m16_1, aux16_1, r2_16_1, windows1, mp1};
#define LAUNCH(T, N)                                                      \
  if (tpi == T && nw == N)                                               \
    return mont ? launch<T, N, true>(base, out, B, B0, l16, n_win, h0, h1, \
                                     k, threads, blocks, smem, s)         \
                : launch<T, N, false>(base, out, B, B0, l16, n_win, h0,  \
                                      h1, k, threads, blocks, smem, s);
  MODEXP_FIXED_SHAPES(LAUNCH)
#undef LAUNCH
  return (int)cudaErrorInvalidValue;
}
