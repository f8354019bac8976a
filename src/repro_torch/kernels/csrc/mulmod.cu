// mulmod: (a * b) mod m over a batch of big integers, one modulus.
//
// Replaces the TPU kernel repro/kernels/limb_mulmod.py::mulmod_pallas
// (body _mulmod_kernel -> common.mulmod2d: radix-256 convolution, carry,
// Barrett with two more convolutions).
//
// Bound on this card: 32-bit integer multiply-adds.  Per element a k-word
// product is k^2 word products; Barrett needs the upper k + 1 words of
// q1 * mu ((k+1)^2 - k(k-1)/2 word products) and the low k + 1 words of
// q3 * m (about k(k+1)/2 + k), and each 32x32->64-bit word product is two
// IMAD results (low and high word).  At the main path's n^2 width (k =
// 128) that is about 66k IMADs per element against 1.5 KB of operand
// traffic, so the kernel is far on the compute side of the card's
// roofline.  This kernel forms all of q1 * mu.
//
// Design: one thread per element, 32-bit words (the reference's radix 256
// was forced by the TPU's missing 64-bit integer path; Hopper has 64-bit
// products), modulus and mu broadcast from shared memory, operands and
// scratch in per-thread local rows.  Barrett is exact for any a * b <
// 2^{64k}, so full-width operands that exceed m (paillier_vec._reduce_into
// feeds such chunks) reduce correctly; operands are never cut to the
// modulus width.  The ragged batch edge is masked in the kernel.
#include "limbs.cuh"

using namespace limbs;

__global__ void mulmod_kernel(const int32_t* __restrict__ a,
                              const int32_t* __restrict__ b,
                              int32_t* __restrict__ out, int B, int l16,
                              const int32_t* __restrict__ m16,
                              const int32_t* __restrict__ mu16, int k) {
  __shared__ u32 sm[MAXW];
  __shared__ u32 smu[MAXW + 1];
  load_shared(m16, 2 * k, sm, k);
  load_shared(mu16, 2 * (k + 1), smu, k + 1);
  __syncthreads();
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= B) return;

  u32 aw[MAXW], bw[MAXW], x[2 * MAXW], q[2 * MAXW + 2], r2[MAXW + 1],
      r[MAXW + 1];
  load_row(a + (size_t)e * l16, l16, aw, k);
  load_row(b + (size_t)e * l16, l16, bw, k);
  mul(aw, k, bw, k, x);
  barrett(x, sm, smu, k, q, r2, r);
  store_row(r, l16, out + (size_t)e * l16);
}

// a, b, out: (B, l16) int32 radix-2^16 rows; m16: 2k limbs; mu16: 2(k+1)
// limbs; threads and blocks: the launch geometry (one thread per
// element, geometry.launch_geometry).  Returns the CUDA error of the
// launch (0 on success).
extern "C" int mulmod_launch(const int32_t* a, const int32_t* b, int32_t* out,
                             int B, int l16, const int32_t* m16,
                             const int32_t* mu16, int k, int threads,
                             int blocks, void* stream) {
  if (k < 1 || k > MAXW || l16 > 2 * k || threads < 1 || threads > 1024 ||
      (long long)blocks * threads < B)
    return (int)cudaErrorInvalidValue;
  if (B <= 0) return 0;
  mulmod_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      a, b, out, B, l16, m16, mu16, k);
  return (int)cudaGetLastError();
}
