// modexp_fixed: base^e mod m over a batch, one host-known exponent e
// shared by the whole batch (Paillier's r^n in encryption and c^lambda in
// decryption, in each CRT half space).
//
// Replaces the TPU kernel repro/kernels/modexp.py::modexp_fixed_pallas and
// its two bodies, the instantiations of one template over the reduction:
//   _modexp_fixed_mont_kernel    -> modexp_fixed_kernel<true>   (default)
//   _modexp_fixed_barrett_kernel -> modexp_fixed_kernel<false>
//
// Bound on this card: 32-bit integer multiply-adds.  With n_win 4-bit
// windows the ladder does 4 n_win squarings and n_win + 16 other
// Montgomery products (the table, domain enter and leave).  A product
// needs k^2 + k word products for the reduction and k^2 for the product,
// k(k+1)/2 when it is a squaring; two IMAD results per word product.  On
// the main path e is n or lambda reduced mod phi(p^2), about 2048 bits
// (512 windows), at k = 64 words: about 34M IMADs per element, so even
// the small batches of one encryption (B = Nk) are compute work, but with
// one thread per element such a batch fills only a few warps of the card.
// This kernel does not take the squaring saving.
//
// Design: one thread per element, 32-bit words, modulus and Montgomery
// constants (or mu) broadcast from shared memory, the 16-entry power table
// in per-thread local memory.  The MSB-first window schedule comes in as a
// device array at run time (the reference compiled one kernel per
// exponent value); since the exponent is key-constant and known to the
// host, the table is indexed by the window value directly.  An empty
// schedule (e = 0) is answered by the wrapper without a launch.  The
// ragged batch edge is masked in the kernel.
#include "limbs.cuh"

using namespace limbs;

template <bool MONT>
__global__ void modexp_fixed_kernel(const int32_t* __restrict__ base,
                                    int32_t* __restrict__ out, int B,
                                    int l16,
                                    const int32_t* __restrict__ windows,
                                    int n_win,
                                    const int32_t* __restrict__ m16,
                                    const int32_t* __restrict__ aux16,
                                    const int32_t* __restrict__ r2_16, u32 mp,
                                    int k) {
  __shared__ u32 sm[MAXW];
  __shared__ u32 saux[MAXW + 1];  // mu (Barrett) or r1 (Montgomery)
  __shared__ u32 sr2[MAXW];
  load_shared(m16, 2 * k, sm, k);
  if (MONT) {
    load_shared(aux16, 2 * k, saux, k);
    load_shared(r2_16, 2 * k, sr2, k);
  } else {
    load_shared(aux16, 2 * (k + 1), saux, k + 1);
  }
  __syncthreads();
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= B) return;

  Field<MONT> f;
  f.m = sm;
  f.aux = saux;
  f.mp = mp;
  f.k = k;
  u32 res[MAXW], tmp[MAXW];
  u32 tab[16 * MAXW];
  load_row(base + (size_t)e * l16, l16, tmp, k);
  if (MONT) {
    f.mulmod(tmp, sr2, tab + k);
    for (int i = 0; i < k; ++i) tab[i] = saux[i];
  } else {
    for (int i = k; i < 2 * k; ++i) f.x[i] = 0;
    for (int i = 0; i < k; ++i) f.x[i] = tmp[i];
    barrett(f.x, sm, saux, k, f.q, f.r2, f.rr);
    for (int i = 0; i < k; ++i) {
      tab[k + i] = f.rr[i];
      tab[i] = (i == 0);
    }
  }
  for (int t = 2; t < 16; ++t) f.mulmod(tab + (t - 1) * k, tab + k, tab + t * k);
  for (int i = 0; i < k; ++i) res[i] = tab[i];
  for (int w = 0; w < n_win; ++w) {
    const int win = windows[w];  // key-constant, host-known
    for (int s = 0; s < 4; ++s) f.mulmod(res, res, res);
    f.mulmod(res, tab + win * k, res);
  }
  if (MONT) {  // leave the Montgomery domain: REDC(res) = res * 1
    for (int i = 0; i < k; ++i) tmp[i] = (i == 0);
    f.mulmod(res, tmp, res);
  }
  store_row(res, l16, out + (size_t)e * l16);
}

// base, out: (B, l16) int32 radix-2^16 rows; windows: n_win int32 values
// in [0, 16), most significant first; m16, aux16, r2_16, mp as for
// modexp_launch.  Returns the CUDA error of the launch (0 on success).
extern "C" int modexp_fixed_launch(const int32_t* base, int32_t* out, int B,
                                   int l16, const int32_t* windows, int n_win,
                                   const int32_t* m16, const int32_t* aux16,
                                   const int32_t* r2_16, unsigned int mp,
                                   int k, int mont, void* stream) {
  if (k < 1 || k > MAXW || l16 > 2 * k || n_win < 1)
    return (int)cudaErrorInvalidValue;
  if (B <= 0) return 0;
  const int blocks = n_blocks(B);
  cudaStream_t s = (cudaStream_t)stream;
  if (mont)
    modexp_fixed_kernel<true><<<blocks, BLOCK, 0, s>>>(
        base, out, B, l16, windows, n_win, m16, aux16, r2_16, mp, k);
  else
    modexp_fixed_kernel<false><<<blocks, BLOCK, 0, s>>>(
        base, out, B, l16, windows, n_win, m16, aux16, r2_16, mp, k);
  return (int)cudaGetLastError();
}
