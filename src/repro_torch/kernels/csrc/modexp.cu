// modexp: base^exp mod m over a batch, one exponent per element,
// constant-time ladder.
//
// Replaces the TPU kernel repro/kernels/modexp.py::modexp_pallas and its
// four bodies, which here are the four instantiations of one template
// over (reduction) x (window):
//   _modexp_mont_win4_kernel -> modexp_kernel<true,  true>   (default)
//   _modexp_mont_kernel      -> modexp_kernel<true,  false>
//   _modexp_win4_kernel      -> modexp_kernel<false, true>
//   _modexp_kernel           -> modexp_kernel<false, false>
//
// Bound on this card: 32-bit integer multiply-adds.  A Montgomery product
// at k words needs k^2 + k word products for the reduction and k^2 for
// the product (k(k+1)/2 when it is a squaring), two IMAD results each; the
// win4 ladder over an exponent of E bits does E squarings and E/4 + 16
// other products (one table product per window, 14 for the table, domain
// enter and leave).  At the main path's p^2/q^2 width (k = 64) and 64-bit
// exponents that is about 1.3M IMADs per element against about 1 KB of
// traffic: compute-bound by a factor of about 250.  This kernel does
// not take the squaring saving: every product is a full k^2 schoolbook.
//
// Design: one thread per element; 32-bit words with 64-bit products in
// place of the reference's radix 256; modulus, mu (Barrett) or r1/r2
// (Montgomery) broadcast from shared memory; the 16-entry power table in
// per-thread local memory.  No branch and no address depends on exponent
// bits: the loop bounds come from the exponent width, the binary ladder
// always computes res * b and keeps it by a mask, and win4 reads all 16
// table entries and selects by a masked sum.  The ragged batch edge is
// masked in the kernel.
#include "limbs.cuh"

using namespace limbs;

template <bool MONT, bool WIN4>
__global__ void modexp_kernel(const int32_t* __restrict__ base,
                              const int32_t* __restrict__ exp,
                              int32_t* __restrict__ out, int B, int l16,
                              int le16, const int32_t* __restrict__ m16,
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
  u32 b[MAXW], res[MAXW], tmp[MAXW];
  // base into the field's domain; res = 1 in that domain
  load_row(base + (size_t)e * l16, l16, tmp, k);
  if (MONT) {
    f.mulmod(tmp, sr2, b);
    for (int i = 0; i < k; ++i) res[i] = saux[i];
  } else {
    for (int i = k; i < 2 * k; ++i) f.x[i] = 0;
    for (int i = 0; i < k; ++i) f.x[i] = tmp[i];
    barrett(f.x, sm, saux, k, f.q, f.r2, f.rr);
    for (int i = 0; i < k; ++i) {
      b[i] = f.rr[i];
      res[i] = (i == 0);
    }
  }
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
  if (MONT) {  // leave the Montgomery domain: REDC(res) = res * 1
    for (int i = 0; i < k; ++i) tmp[i] = (i == 0);
    f.mulmod(res, tmp, res);
  }
  store_row(res, l16, out + (size_t)e * l16);
}

// base, out: (B, l16) int32 radix-2^16 rows; exp: (B, le16) rows; m16 and
// r2_16: 2k limbs; aux16: mu as 2(k+1) limbs (Barrett) or r1 as 2k limbs
// (Montgomery, R = 2^{32k}); mp = -m^{-1} mod 2^32.  Returns the CUDA
// error of the launch (0 on success).
extern "C" int modexp_launch(const int32_t* base, const int32_t* exp,
                             int32_t* out, int B, int l16, int le16,
                             const int32_t* m16, const int32_t* aux16,
                             const int32_t* r2_16, unsigned int mp, int k,
                             int mont, int win4, void* stream) {
  if (k < 1 || k > MAXW || l16 > 2 * k || le16 < 1)
    return (int)cudaErrorInvalidValue;
  if (B <= 0) return 0;
  const int blocks = n_blocks(B);
  cudaStream_t s = (cudaStream_t)stream;
  if (mont && win4)
    modexp_kernel<true, true><<<blocks, BLOCK, 0, s>>>(
        base, exp, out, B, l16, le16, m16, aux16, r2_16, mp, k);
  else if (mont)
    modexp_kernel<true, false><<<blocks, BLOCK, 0, s>>>(
        base, exp, out, B, l16, le16, m16, aux16, r2_16, mp, k);
  else if (win4)
    modexp_kernel<false, true><<<blocks, BLOCK, 0, s>>>(
        base, exp, out, B, l16, le16, m16, aux16, r2_16, mp, k);
  else
    modexp_kernel<false, false><<<blocks, BLOCK, 0, s>>>(
        base, exp, out, B, l16, le16, m16, aux16, r2_16, mp, k);
  return (int)cudaGetLastError();
}
