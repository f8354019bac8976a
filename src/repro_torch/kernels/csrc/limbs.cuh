// Multi-precision integer helpers shared by the limb kernels.
//
// Every kernel runs a group of TPI threads per big integer (mulmod, both
// bodies of modexp_fixed, all four bodies of modexp): lane j of the group
// holds words j*NW .. j*NW + NW-1 of every operand in registers (TPI and
// NW are template parameters, so every register array is indexed by
// unrolled loops only), C = TPI*NW words in all.  Words at and above the
// width k are zero.  mont_mul below is the CIOS product of Koc et al.
// 1996 distributed over the group, in the layout of NVlabs' CGBN;
// barrett_mul is HAC 14.42 on three product scans in the same layout.
// Barrett's quantities of k+1 words (q1, mu, q3, r) keep their word at
// position C, which the group cannot hold when C == k (k = 64 at TPI 32,
// NW 2), as a per-group scalar that every lane of the group holds alike;
// when C > k that scalar is 0 and word k lies inside the group.
// GroupField wraps either product for the exponentiation ladders.
//
// Products are 32x32->64 bits, so a k-word schoolbook product costs k^2
// word products.  At the public boundary every row is the reference's
// radix-2^16 layout (int32 limbs < 2^16), packed into words on load and
// unpacked on store; the Python wrappers never reinterpret integer types.
//
// Launch geometry (threads per integer, integers per block, blocks and
// dynamic shared memory) is computed by the Python function
// repro_torch.kernels.geometry.launch_geometry and passed to every C
// launcher, which checks it and launches with it.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace limbs {

typedef uint32_t u32;
typedef uint64_t u64;

// Widest modulus the kernels take: 128 words = 4096 bits (n^2 of a
// 2048-bit Paillier key).
constexpr int MAXW = 128;
constexpr u32 FULL = 0xFFFFFFFFu;

// Word i of a radix-2^16 int32 row of l16 limbs (missing limbs are 0).
__device__ __forceinline__ u32 word16(const int32_t* __restrict__ src,
                                      int l16, int i) {
  u32 lo = (2 * i < l16) ? (u32)src[2 * i] : 0u;
  u32 hi = (2 * i + 1 < l16) ? (u32)src[2 * i + 1] : 0u;
  return (lo & 0xFFFFu) | (hi << 16);
}

// Lane of this thread within its group (TPI is a power of two <= 32).
template <int TPI>
__device__ __forceinline__ int group_lane() {
  return threadIdx.x & (TPI - 1);
}

// This group's TPI bits of a warp-wide ballot.
template <int TPI>
__device__ __forceinline__ u32 group_bits(u32 ballot) {
  if constexpr (TPI == 32) {
    return ballot;
  } else {
    const int first = (threadIdx.x & 31) & ~(TPI - 1);
    return (ballot >> first) & ((1u << TPI) - 1u);
  }
}

// Carry lookahead across the group in a fixed instruction count.  Lane j
// generates a carry (bit j of g) or propagates an incoming one (bit j of
// p: its words are all ones, or all zeros for a borrow); never both.  Bit
// j of the result is the carry into lane j, bit TPI the carry out of the
// group: c_j = g_{j-1} | (p_{j-1} & c_{j-1}) evaluated by one addition.
__device__ __forceinline__ u64 lookahead(u64 g, u64 p) {
  return ((g << 1) + p) ^ p;
}

// The group's row of src (l16 radix-2^16 limbs): lane j gets words
// j*NW .. j*NW + NW-1, zero at and above word k and everywhere when !live.
template <int TPI, int NW>
__device__ __forceinline__ void group_load(const int32_t* __restrict__ src,
                                           int l16, int k, bool live,
                                           u32 (&x)[NW]) {
  const int lane = group_lane<TPI>();
#pragma unroll
  for (int w = 0; w < NW; ++w) {
    const int i = lane * NW + w;
    x[w] = (live && i < k) ? word16(src, l16, i) : 0u;
  }
}

// Store the group's row as l16 radix-2^16 limbs.
template <int TPI, int NW>
__device__ __forceinline__ void group_store(const u32 (&x)[NW], int l16,
                                            int32_t* __restrict__ dst) {
  const int lane = group_lane<TPI>();
#pragma unroll
  for (int w = 0; w < NW; ++w) {
    const int i = lane * NW + w;
    if (2 * i < l16) dst[2 * i] = (int32_t)(x[w] & 0xFFFFu);
    if (2 * i + 1 < l16) dst[2 * i + 1] = (int32_t)(x[w] >> 16);
  }
}

// The integer 1 (Montgomery exit multiplier, Barrett's first reduction)
// in the group layout.
template <int TPI, int NW>
__device__ __forceinline__ void group_one(u32 (&x)[NW]) {
  const int lane = group_lane<TPI>();
#pragma unroll
  for (int w = 0; w < NW; ++w) x[w] = (lane == 0 && w == 0) ? 1u : 0u;
}

// mu = floor(2^{64k} / m), k+1 words given as 2(k+1) radix-2^16 limbs:
// words below C in the group, word C (word k when C == k, else 0) in muH.
template <int TPI, int NW>
__device__ __forceinline__ void group_load_mu(const int32_t* __restrict__ mu16,
                                              int k, u32 (&mu)[NW],
                                              u32& muH) {
  group_load<TPI, NW>(mu16, 2 * (k + 1), k + 1, true, mu);
  muH = (TPI * NW == k) ? word16(mu16, 2 * (k + 1), k) : 0u;
}

// t += the carry c (< 2^32) of lane j-1 in every lane j, carries resolved
// across the group by lookahead.  Lane TPI-1's own c is not added (it
// lies at word C).  Returns the carry out of the group (0 or 1, alike in
// every lane).
template <int TPI, int NW>
__device__ __forceinline__ u32 group_carry(u32 (&t)[NW], u64 c) {
  const int lane = group_lane<TPI>();
  u32 cin = __shfl_up_sync(FULL, (u32)c, 1, TPI);
  if (lane == 0) cin = 0;
  u32 ones = FULL;
#pragma unroll
  for (int x = 0; x < NW; ++x) {
    const u64 s = (u64)t[x] + cin;
    t[x] = (u32)s;
    cin = (u32)(s >> 32);
    ones &= t[x];
  }
  const u64 look = lookahead(group_bits<TPI>(__ballot_sync(FULL, cin != 0)),
                             group_bits<TPI>(__ballot_sync(FULL, ones == FULL)));
  cin = (u32)(look >> lane) & 1u;
#pragma unroll
  for (int x = 0; x < NW; ++x) {
    const u64 s = (u64)t[x] + cin;
    t[x] = (u32)s;
    cin = (u32)(s >> 32);
  }
  return (u32)(look >> TPI) & 1u;
}

// d = x - y mod 2^{32C}, the borrows resolved across the group by
// lookahead.  Returns the borrow out of the group (0 or 1, alike in every
// lane): 1 when x < y.  d may alias x.
template <int TPI, int NW>
__device__ __forceinline__ u32 group_sub(const u32 (&x)[NW],
                                         const u32 (&y)[NW], u32 (&d)[NW]) {
  const int lane = group_lane<TPI>();
  u32 br = 0, zeros = 0;
#pragma unroll
  for (int w = 0; w < NW; ++w) {
    const u64 s = (u64)x[w] - y[w] - br;
    d[w] = (u32)s;
    br = (u32)(s >> 63);
    zeros |= d[w];
  }
  const u64 look = lookahead(group_bits<TPI>(__ballot_sync(FULL, br != 0)),
                             group_bits<TPI>(__ballot_sync(FULL, zeros == 0)));
  br = (u32)(look >> lane) & 1u;
#pragma unroll
  for (int w = 0; w < NW; ++w) {
    const u64 s = (u64)d[w] - br;
    d[w] = (u32)s;
    br = (u32)(s >> 63);
  }
  return (u32)(look >> TPI) & 1u;
}

// Cooperative Montgomery product (CIOS): r = a * b * 2^{-32k} mod m,
// canonical, for m odd, mp = -m^{-1} mod 2^32, a, b < 2^{32k} and
// a * b < 2^{32k} m.  R = 2^{32k} whatever the padding TPI * NW - k.
// r may alias a or b.  Every thread of the warp must call it with the
// same k: it shuffles and ballots across the full warp.
//
// Word i of b (lane i / NW, slot i % NW) is broadcast by a shuffle; each
// lane multiply-adds its NW words of a into its words of the running sum
// t; u = t_0 mp comes from lane 0; each lane adds u times its words of m;
// the one-word shift moves lane j+1's lowest word to lane j's top.  The
// carry out of lane j's words is kept in c (at word (j+1)NW) and enters
// lane j's top word at the shift, so c stays below 2^34 and no carry ever
// ripples inside the loop.  After the k steps, c (< 4) goes to lane j+1
// and the group resolves the one-bit carries by lookahead; then r - m is
// formed with the borrow resolved the same way, and kept by a mask when
// r >= m.
template <int TPI, int NW>
__device__ __forceinline__ void mont_mul(const u32 (&a)[NW],
                                         const u32 (&b)[NW],
                                         const u32 (&m)[NW], u32 mp, int k,
                                         u32 (&r)[NW]) {
  const int lane = group_lane<TPI>();
  u32 t[NW];
#pragma unroll
  for (int w = 0; w < NW; ++w) t[w] = 0;
  u64 c = 0;
  const int n_src = (k + NW - 1) / NW;
  for (int src = 0; src < n_src; ++src) {
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      if (src * NW + w < k) {
        const u32 bi = __shfl_sync(FULL, b[w], src, TPI);
        u32 cy = 0;
#pragma unroll
        for (int x = 0; x < NW; ++x) {  // t += a * b_i
          const u64 s = (u64)a[x] * bi + t[x] + cy;
          t[x] = (u32)s;
          cy = (u32)(s >> 32);
        }
        c += cy;
        const u32 u = __shfl_sync(FULL, t[0] * mp, 0, TPI);
        cy = 0;
#pragma unroll
        for (int x = 0; x < NW; ++x) {  // t += u * m; lane 0's t[0] -> 0
          const u64 s = (u64)u * m[x] + t[x] + cy;
          t[x] = (u32)s;
          cy = (u32)(s >> 32);
        }
        c += cy;
        // t >>= 32 across the group
        const u32 next = __shfl_down_sync(FULL, t[0], 1, TPI);
#pragma unroll
        for (int x = 0; x + 1 < NW; ++x) t[x] = t[x + 1];
        const u64 s = (u64)(lane == TPI - 1 ? 0u : next) + c;
        t[NW - 1] = (u32)s;
        c = s >> 32;
      }
    }
  }
  // lane j-1's carry (< 4) into lane j's words; carries out by lookahead.
  // The word above the group's capacity: lane TPI-1's own carry plus the
  // lookahead's carry out (0 or 1 in all, since the result is < 2m)
  const u32 over = group_carry<TPI, NW>(t, c) |
      (group_bits<TPI>(__ballot_sync(FULL, lane == TPI - 1 && c != 0)) != 0);
  // keep t - m when t >= m: an overflow word, or no borrow out of the group
  u32 d[NW];
  const u32 keep = 0u - (over | (group_sub<TPI, NW>(t, m, d) ^ 1u));
#pragma unroll
  for (int x = 0; x < NW; ++x) r[x] = (d[x] & keep) | (t[x] & ~keep);
}

// Product scan of the cooperative Barrett product: u * v for u and v of up
// to C+1 words (group rows plus the per-group scalar word C: uH, vH),
// over v's words 0 .. n-1 (n <= C+1; v's higher words must be 0).
//
// Word i of v is broadcast by a shuffle (vH when i == C); each lane
// multiply-adds its NW words of u into its words of the running sum t and
// every lane adds uH v_i into the sum's word C, top (a 64-bit scalar, the
// same in every lane).  The lowest word of the sum is then word i of the
// product: it is shifted out, and with LO kept at position i of lo (lane
// i / NW, slot i % NW; loH when i == C).  As in mont_mul, lane j's carry
// out c waits at word (j+1)NW and enters lane j's top word at the shift
// (lane TPI-1's top word takes top's low word and top moves down), so c
// stays <= 2 and no carry ripples inside the loop.  With HI, after the n
// steps the carries are resolved by lookahead and (hi, hiH) =
// floor(u v / 2^{32n}), which must be below 2^{32(C+1)}.  Every lane of
// the warp must take part with the same n.
template <int TPI, int NW, bool LO, bool HI>
__device__ __forceinline__ void product_scan(
    const u32 (&u)[NW], u32 uH, const u32 (&v)[NW], u32 vH, int n,
    u32 (&lo)[NW], u32& loH, u32 (&hi)[NW], u32& hiH) {
  constexpr int C = TPI * NW;
  const int lane = group_lane<TPI>();
#pragma unroll
  for (int w = 0; w < NW; ++w) {
    hi[w] = 0;
    if (LO) lo[w] = 0;
  }
  if (LO) loH = 0;
  u64 c = 0, top = 0;
  const int n_src = (n + NW - 1) / NW;
  for (int src = 0; src < n_src; ++src) {
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      const int i = src * NW + w;
      if (i < n) {
        // src == TPI only for i == C: the shuffle's lane wraps, vH is taken
        const u32 vs = __shfl_sync(FULL, v[w], src, TPI);
        const u32 vi = src < TPI ? vs : vH;
        u32 cy = 0;
#pragma unroll
        for (int x = 0; x < NW; ++x) {  // t += u * v_i
          const u64 s = (u64)u[x] * vi + hi[x] + cy;
          hi[x] = (u32)s;
          cy = (u32)(s >> 32);
        }
        c += cy;
        top += (u64)uH * vi;
        if (LO) {
          const u32 w0 = __shfl_sync(FULL, hi[0], 0, TPI);  // word i
          if (lane == src) lo[w] = w0;
          if (i == C) loH = w0;
        }
        // sum >>= 32 across the group
        const u32 next = __shfl_down_sync(FULL, hi[0], 1, TPI);
#pragma unroll
        for (int x = 0; x + 1 < NW; ++x) hi[x] = hi[x + 1];
        const u64 s = (u64)(lane == TPI - 1 ? (u32)top : next) + c;
        top >>= 32;
        hi[NW - 1] = (u32)s;
        c = s >> 32;
      }
    }
  }
  if (HI) {
    // word C: top, lane TPI-1's carry and the group's carry out
    const u32 cout = group_carry<TPI, NW>(hi, c);
    hiH = (u32)top + __shfl_sync(FULL, (u32)c, TPI - 1, TPI) + cout;
  }
}

// Cooperative Barrett product (HAC 14.42, b = 2^32): r = a * b mod m,
// canonical, for any a, b < 2^{32k} and any m of k words with a non-zero
// top word, odd or even; mu = floor(b^{2k} / m) (k+1 words: group_load_mu).
// r may alias a or b.  Every thread of the warp must call it with the
// same k.
//
//   x  = a b                           (scan over b's k words; 2k words)
//   q1 = floor(x / b^{k-1})            (x's high half one word up, x_{k-1}
//                                       below it; k+1 words)
//   q3 = floor(q1 mu / b^{k+1})        (scan over q1's k+1 words; the low
//                                       words are shifted out unused)
//   r  = (x - q3 m) mod b^{k+1}        (scan over q3's k+1 words keeps the
//                                       low k+1 words of q3 m)
// then r < 3m, and two masked subtractions of m make it canonical.  The
// shifts must be k-1 and k+1: q1 then loses less than b^{k-1} <= m, so q3
// falls short of floor(x / m) by at most 2.  Words at position C (q1's
// top word when C == k, mu's, q3's, r's) are per-group scalars.  No branch
// depends on the data: every borrow is resolved by lookahead and every
// choice is a mask.
template <int TPI, int NW>
__device__ __forceinline__ void barrett_mul(const u32 (&a)[NW],
                                            const u32 (&b)[NW],
                                            const u32 (&m)[NW],
                                            const u32 (&mu)[NW], u32 muH,
                                            int k, u32 (&r)[NW]) {
  constexpr int C = TPI * NW;
  const int lane = group_lane<TPI>();
  u32 xlo[NW], xhi[NW], xloH, xhiH;
  product_scan<TPI, NW, true, true>(a, 0u, b, 0u, k, xlo, xloH, xhi, xhiH);
  // x_{k-1} (the last word of xlo) and x_k (xhi's lowest word)
  const int km1 = k - 1;
  u32 mine = 0;
#pragma unroll
  for (int w = 0; w < NW; ++w) mine |= (lane * NW + w == km1) ? xlo[w] : 0u;
  const u32 xk1 = __shfl_sync(FULL, mine, km1 / NW, TPI);
  const u32 xk = __shfl_sync(FULL, xhi[0], 0, TPI);
  // q1: xhi one word up; its top word leaves the group (0 unless C == k)
  u32 q1[NW];
  const u32 below = __shfl_up_sync(FULL, xhi[NW - 1], 1, TPI);
  const u32 q1H = __shfl_sync(FULL, xhi[NW - 1], TPI - 1, TPI);
  q1[0] = lane == 0 ? xk1 : below;
#pragma unroll
  for (int w = 1; w < NW; ++w) q1[w] = xhi[w - 1];
  u32 q3[NW], q3H, unused[NW], unusedH;
  product_scan<TPI, NW, false, true>(mu, muH, q1, q1H, k + 1, unused,
                                     unusedH, q3, q3H);
  u32 r2[NW], r2H;
  product_scan<TPI, NW, true, false>(m, 0u, q3, q3H, k + 1, r2, r2H, unused,
                                     unusedH);
  // r = (x mod b^{k+1}) - r2 mod b^{k+1}: x_k at position k
  u32 rr[NW];
#pragma unroll
  for (int w = 0; w < NW; ++w)
    rr[w] = xlo[w] | ((lane * NW + w == k) ? xk : 0u);
  u32 rH = (C == k ? xk : 0u) - r2H - group_sub<TPI, NW>(rr, r2, rr);
  if (C > k) {  // mod b^{k+1}: clear the borrow's words above position k
#pragma unroll
    for (int w = 0; w < NW; ++w)
      if (lane * NW + w > k) rr[w] = 0;
    rH = 0;
  }
  // r < 3m: keep r - m when r >= m, twice
  for (int s = 0; s < 2; ++s) {
    u32 d[NW];
    const u32 bout = group_sub<TPI, NW>(rr, m, d);
    const u32 keep = 0u - (u32)((rH != 0) | (bout == 0));
#pragma unroll
    for (int w = 0; w < NW; ++w) rr[w] = (d[w] & keep) | (rr[w] & ~keep);
    rH -= bout & keep;
  }
#pragma unroll
  for (int w = 0; w < NW; ++w) r[w] = rr[w];
}

// The product of one exponentiation ladder over a group: Montgomery
// (s: mp = -m^{-1} mod 2^32; the ladder runs on x R mod m, R = 2^{32k})
// or Barrett (aux: mu below word C, s: mu's word C; no domain, so any
// modulus, odd or even).
template <int TPI, int NW, bool MONT>
struct GroupField {
  u32 m[NW], aux[NW], s;
  int k;

  __device__ __forceinline__ void mul(const u32 (&a)[NW], const u32 (&b)[NW],
                                      u32 (&r)[NW]) const {
    if constexpr (MONT)
      mont_mul<TPI, NW>(a, b, m, s, k, r);
    else
      barrett_mul<TPI, NW>(a, b, m, aux, s, k, r);
  }

  // Load the field of the modulus m16 (2k limbs): aux16 is R mod m (2k
  // limbs, Montgomery) or mu (2(k+1) limbs, Barrett), r2_16 R^2 mod m and
  // mp (Montgomery only).  Then bring the base b into the ladder's form
  // (Montgomery b R mod m; Barrett b mod m, reduced first as the plain
  // version does) and set one to the ladder's 1.  x is scratch.
  __device__ __forceinline__ void enter(const int32_t* __restrict__ m16,
                                        const int32_t* __restrict__ aux16,
                                        const int32_t* __restrict__ r2_16,
                                        u32 mp, int width, u32 (&b)[NW],
                                        u32 (&one)[NW], u32 (&x)[NW]) {
    k = width;
    group_load<TPI, NW>(m16, 2 * k, k, true, m);
    if constexpr (MONT) {
      s = mp;
      group_load<TPI, NW>(r2_16, 2 * k, k, true, x);
      mul(b, x, b);
      group_load<TPI, NW>(aux16, 2 * k, k, true, one);  // R mod m
    } else {
      group_load_mu<TPI, NW>(aux16, k, aux, s);
      group_one<TPI, NW>(one);
      mul(b, one, b);
    }
  }

  // res out of the ladder's form: Montgomery REDC(res) = res * 1; Barrett
  // has no domain to leave.  x is scratch.
  __device__ __forceinline__ void leave(u32 (&res)[NW], u32 (&x)[NW]) const {
    if constexpr (MONT) {
      group_one<TPI, NW>(x);
      mul(res, x, res);
    }
  }

  // The 16-entry power table one, b, b^2, ..., b^15 in dynamic shared
  // memory: entry t word w of thread i at tab[(t NW + w) blockDim + i], so
  // a warp's accesses hit 32 banks and each thread reads back only what
  // it wrote (no barrier).  x is scratch.
  __device__ __forceinline__ void power_table(u32* tab, const u32 (&one)[NW],
                                              const u32 (&b)[NW],
                                              u32 (&x)[NW]) const {
    u32* mine = tab + threadIdx.x;
    const int bd = blockDim.x;
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      mine[w * bd] = one[w];
      mine[(NW + w) * bd] = b[w];
      x[w] = b[w];
    }
    for (int t = 2; t < 16; ++t) {
      mul(x, b, x);
#pragma unroll
      for (int w = 0; w < NW; ++w) mine[(t * NW + w) * bd] = x[w];
    }
  }
};

}  // namespace limbs
