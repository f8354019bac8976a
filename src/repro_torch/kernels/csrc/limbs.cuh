// Multi-precision integer helpers shared by the limb kernels.
//
// One CUDA thread owns one big integer.  Inside a kernel a big integer is
// a little-endian row of 32-bit words; products are 32x32->64 bits
// (mul.wide.u32 / mad.hi), so a k-word schoolbook product costs k^2 word
// products.  At the public boundary every row is the reference's
// radix-2^16 layout (int32 limbs < 2^16), packed into words on load and
// unpacked on store; the Python wrappers never reinterpret integer types.
//
// The per-thread rows live in local arrays sized for the widest modulus
// (MAXW words); loops run to the actual width k.  Local memory is laid
// out so that the same word of every thread of a warp is contiguous, so
// the uniform loops below make coalesced accesses.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace limbs {

typedef uint32_t u32;
typedef uint64_t u64;

// Widest modulus the kernels take: 128 words = 4096 bits (n^2 of a
// 2048-bit Paillier key).
constexpr int MAXW = 128;

// Threads per block of every launch, at every batch size.  One warp per
// block spreads a small batch (B = Nk = 192 in an encryption's
// modexp_fixed) over as many SMs as it has warps.
constexpr int BLOCK = 32;

inline int n_blocks(int B) { return (B + BLOCK - 1) / BLOCK; }

// Word i of a radix-2^16 int32 row of l16 limbs (missing limbs are 0).
__device__ __forceinline__ u32 word16(const int32_t* __restrict__ src,
                                      int l16, int i) {
  u32 lo = (2 * i < l16) ? (u32)src[2 * i] : 0u;
  u32 hi = (2 * i + 1 < l16) ? (u32)src[2 * i + 1] : 0u;
  return (lo & 0xFFFFu) | (hi << 16);
}

__device__ __forceinline__ void load_row(const int32_t* __restrict__ src,
                                         int l16, u32* dst, int nw) {
  for (int i = 0; i < nw; ++i) dst[i] = word16(src, l16, i);
}

__device__ __forceinline__ void store_row(const u32* src, int l16,
                                          int32_t* __restrict__ dst) {
  for (int i = 0; i < l16; ++i)
    dst[i] = (int32_t)((src[i >> 1] >> (16 * (i & 1))) & 0xFFFFu);
}

// Block-wide copy of a radix-2^16 row into nw shared words.
__device__ __forceinline__ void load_shared(const int32_t* __restrict__ src,
                                            int l16, u32* dst, int nw) {
  for (int i = threadIdx.x; i < nw; i += blockDim.x) dst[i] = word16(src, l16, i);
}

// t[0, la + lb) = a * b.
__device__ __forceinline__ void mul(const u32* a, int la, const u32* b,
                                    int lb, u32* t) {
  for (int i = 0; i < la + lb; ++i) t[i] = 0;
  for (int i = 0; i < la; ++i) {
    u64 c = 0;
    const u64 ai = a[i];
    for (int j = 0; j < lb; ++j) {
      u64 s = ai * b[j] + t[i + j] + c;
      t[i + j] = (u32)s;
      c = s >> 32;
    }
    t[i + lb] = (u32)c;
  }
}

// r (k+1 words) -= m (k words) when r >= m.  Branch-free: the first pass
// finds the borrow of r - m, the second subtracts m masked by it.
__device__ __forceinline__ void cond_sub(u32* r, const u32* m, int k) {
  u32 borrow = 0;
  for (int i = 0; i < k; ++i) {
    u64 d = (u64)r[i] - m[i] - borrow;
    borrow = (u32)(d >> 63);
  }
  borrow = (u32)(((u64)r[k] - borrow) >> 63);
  const u32 mask = borrow - 1u;  // all ones when r >= m
  borrow = 0;
  for (int i = 0; i < k; ++i) {
    u64 d = (u64)r[i] - (m[i] & mask) - borrow;
    r[i] = (u32)d;
    borrow = (u32)(d >> 63);
  }
  r[k] -= borrow;
}

// Barrett reduction (HAC 14.42), b = 2^32: r (k+1 words, canonical, top
// word 0) = x mod m for any x < b^{2k} given as 2k words; m has k words
// with m[k-1] != 0 and mu = floor(b^{2k} / m) has k+1 words.
// Scratch: q (2k+2 words), r2 (k+1 words).
__device__ __forceinline__ void barrett(const u32* x, const u32* m,
                                        const u32* mu, int k, u32* q, u32* r2,
                                        u32* r) {
  // q2 = floor(x / b^{k-1}) * mu; q3 = floor(q2 / b^{k+1})
  mul(x + (k - 1), k + 1, mu, k + 1, q);
  const u32* q3 = q + (k + 1);
  // r2 = q3 * m mod b^{k+1}
  for (int i = 0; i <= k; ++i) r2[i] = 0;
  for (int i = 0; i <= k; ++i) {
    u64 c = 0;
    const u64 qi = q3[i];
    for (int j = 0; j < k && i + j <= k; ++j) {
      u64 s = qi * m[j] + r2[i + j] + c;
      r2[i + j] = (u32)s;
      c = s >> 32;
    }
    if (i == 0) r2[k] = (u32)c;
  }
  // r = (x mod b^{k+1}) - r2 mod b^{k+1}, then r < 3m
  u32 borrow = 0;
  for (int i = 0; i <= k; ++i) {
    u64 d = (u64)x[i] - r2[i] - borrow;
    r[i] = (u32)d;
    borrow = (u32)(d >> 63);
  }
  cond_sub(r, m, k);
  cond_sub(r, m, k);
}

// Montgomery product (CIOS, Koc et al. 1996): r = a * b * 2^{-32k} mod m,
// canonical.  Needs m odd, mp = -m^{-1} mod 2^32, a, b < 2^{32k} and
// a * b < 2^{32k} m.  Scratch t: k+2 words.  r may alias a or b.
__device__ __forceinline__ void montmul(const u32* a, const u32* b,
                                        const u32* m, u32 mp, int k, u32* t,
                                        u32* r) {
  for (int i = 0; i < k + 2; ++i) t[i] = 0;
  for (int i = 0; i < k; ++i) {
    u64 c = 0;
    const u64 bi = b[i];
    for (int j = 0; j < k; ++j) {
      u64 s = a[j] * bi + t[j] + c;
      t[j] = (u32)s;
      c = s >> 32;
    }
    u64 s = (u64)t[k] + c;
    t[k] = (u32)s;
    t[k + 1] = (u32)(s >> 32);
    const u64 u = (u32)(t[0] * mp);
    s = u * m[0] + t[0];
    c = s >> 32;
    for (int j = 1; j < k; ++j) {
      s = u * m[j] + t[j] + c;
      t[j - 1] = (u32)s;
      c = s >> 32;
    }
    s = (u64)t[k] + c;
    t[k - 1] = (u32)s;
    t[k] = t[k + 1] + (u32)(s >> 32);
  }
  cond_sub(t, m, k);  // t < 2m -> canonical
  for (int i = 0; i < k; ++i) r[i] = t[i];
}

// A modular multiply over one modulus, by Barrett or by Montgomery; the
// ladders are written once over it.  ``m`` and ``aux`` point to shared
// memory: aux is mu (k+1 words) for Barrett, unused for Montgomery.
template <bool MONT>
struct Field {
  const u32* m;
  const u32* aux;
  u32 mp;
  int k;
  // per-thread scratch
  u32 x[2 * MAXW + 2];
  u32 q[2 * MAXW + 2];
  u32 r2[MAXW + 1];
  u32 rr[MAXW + 1];

  // out = a * b in the field's domain (out may alias a or b)
  __device__ __forceinline__ void mulmod(const u32* a, const u32* b,
                                         u32* out) {
    if (MONT) {
      montmul(a, b, m, mp, k, x, out);
    } else {
      mul(a, k, b, k, x);
      barrett(x, m, aux, k, q, r2, rr);
      for (int i = 0; i < k; ++i) out[i] = rr[i];
    }
  }
};

}  // namespace limbs
