// GF(2^255-19) field arithmetic for one lane, in registers.
//
// The row math of tendermint_tpu/ops/pallas_fe.py (_rcarry, _radd, _rsub,
// _rmul_small, _product_rows, _square_rows, _reduce_39), which mirrors
// tendermint_tpu/ops/fe25519.py: a field element is 20 int32 limbs in
// uniform radix 2^13, the wrap at limb 20 is 2^260 mod p = 608. Every op here
// runs the reference's exact carry schedule in int32, so the limbs a kernel
// writes are bit-identical to the reference and to ops/fe25519.py. Carried
// limbs are <= 2^13 (limb 0 <= 2^13 + 607); a 20-term sum of their products
// stays below 2^31, so no intermediate overflows int32.
//
// Every loop has a compile-time trip count and is fully unrolled, so a field
// element lives in 20 registers and a product accumulator in 39.
#pragma once
#include <stdint.h>

#define FE_NL 20
#define FE_RADIX 13
#define FE_MASK 8191
#define FE_WRAP 608

// COMP + CORR of fe25519.sub: a - b == a + (COMP - b) + CORR (mod p).
__device__ __constant__ int32_t FE_COMP[FE_NL] = {
    8800, 8192, 8192, 8192, 8192, 8192, 8192, 8192, 8192, 8192,
    8192, 8192, 8192, 8192, 8192, 8192, 8192, 8192, 8192, 8192};
__device__ __constant__ int32_t FE_CORR[FE_NL] = {
    6957, 8190, 8190, 8190, 8190, 8190, 8190, 8190, 8190, 8190,
    8190, 8190, 8190, 8190, 8190, 8190, 8190, 8190, 8190, 254};
// 2d, canonical limbs.
__device__ __constant__ int32_t FE_D2[FE_NL] = {
    4441, 5527, 1289, 3383, 3773, 6315, 2574, 4944, 20,   7,
    5196, 7655, 3886, 1856, 7270, 8092, 5855, 3810, 438,  72};

struct fe_t {
  int32_t v[FE_NL];
};

// Four parallel carry passes + the 2^260 wrap (fe25519.carry).
__device__ __forceinline__ void fe_carry(fe_t &x) {
#pragma unroll
  for (int pass = 0; pass < 4; pass++) {
    int32_t c[FE_NL];
#pragma unroll
    for (int i = 0; i < FE_NL; i++) c[i] = x.v[i] >> FE_RADIX;
    x.v[0] = (x.v[0] & FE_MASK) + FE_WRAP * c[FE_NL - 1];
#pragma unroll
    for (int i = 1; i < FE_NL; i++) x.v[i] = (x.v[i] & FE_MASK) + c[i - 1];
  }
}

__device__ __forceinline__ fe_t fe_add(const fe_t &a, const fe_t &b) {
  fe_t r;
#pragma unroll
  for (int i = 0; i < FE_NL; i++) r.v[i] = a.v[i] + b.v[i];
  fe_carry(r);
  return r;
}

__device__ __forceinline__ fe_t fe_sub(const fe_t &a, const fe_t &b) {
  fe_t r;
#pragma unroll
  for (int i = 0; i < FE_NL; i++) r.v[i] = a.v[i] + (FE_COMP[i] - b.v[i]) + FE_CORR[i];
  fe_carry(r);
  return r;
}

__device__ __forceinline__ fe_t fe_neg(const fe_t &a) {
  fe_t r;
#pragma unroll
  for (int i = 0; i < FE_NL; i++) r.v[i] = (FE_COMP[i] - a.v[i]) + FE_CORR[i];
  fe_carry(r);
  return r;
}

__device__ __forceinline__ fe_t fe_mul_small(const fe_t &a, int32_t k) {
  fe_t r;
#pragma unroll
  for (int i = 0; i < FE_NL; i++) r.v[i] = a.v[i] * k;
  fe_carry(r);
  return r;
}

// fe25519.mul's reduction of the 39-row product: two parallel passes (the top
// carry folds onto row 19 with 608), fold rows >= 20 with 608, carry.
__device__ __forceinline__ fe_t fe_reduce39(int32_t (&acc)[2 * FE_NL - 1]) {
  const int n = 2 * FE_NL - 1;
#pragma unroll
  for (int pass = 0; pass < 2; pass++) {
    int32_t c[2 * FE_NL - 1];
#pragma unroll
    for (int k = 0; k < n; k++) c[k] = acc[k] >> FE_RADIX;
    acc[0] = acc[0] & FE_MASK;
#pragma unroll
    for (int k = 1; k < n; k++) acc[k] = (acc[k] & FE_MASK) + c[k - 1];
    acc[FE_NL - 1] += FE_WRAP * c[n - 1];
  }
  fe_t r;
#pragma unroll
  for (int k = 0; k < FE_NL - 1; k++) r.v[k] = acc[k] + FE_WRAP * acc[k + FE_NL];
  r.v[FE_NL - 1] = acc[FE_NL - 1];
  fe_carry(r);
  return r;
}

__device__ __forceinline__ fe_t fe_mul(const fe_t &a, const fe_t &b) {
  int32_t acc[2 * FE_NL - 1];
#pragma unroll
  for (int k = 0; k < 2 * FE_NL - 1; k++) acc[k] = 0;
#pragma unroll
  for (int i = 0; i < FE_NL; i++) {
#pragma unroll
    for (int j = 0; j < FE_NL; j++) acc[i + j] += a.v[i] * b.v[j];
  }
  return fe_reduce39(acc);
}

// Product with a constant in __constant__ memory (pallas_fe._rmul_const).
__device__ __forceinline__ fe_t fe_mul_const(const fe_t &a, const int32_t *c) {
  int32_t acc[2 * FE_NL - 1];
#pragma unroll
  for (int k = 0; k < 2 * FE_NL - 1; k++) acc[k] = 0;
#pragma unroll
  for (int i = 0; i < FE_NL; i++) {
#pragma unroll
    for (int j = 0; j < FE_NL; j++) acc[i + j] += a.v[i] * c[j];
  }
  return fe_reduce39(acc);
}

// Symmetric convolution (pallas_fe._square_rows): 210 products instead of
// 400; each row sums the same integers as fe_mul(a, a).
__device__ __forceinline__ fe_t fe_square(const fe_t &a) {
  int32_t acc[2 * FE_NL - 1];
#pragma unroll
  for (int k = 0; k < 2 * FE_NL - 1; k++) acc[k] = 0;
#pragma unroll
  for (int i = 0; i < FE_NL; i++) {
    acc[2 * i] += a.v[i] * a.v[i];
    const int32_t a2 = a.v[i] + a.v[i];
#pragma unroll
    for (int j = i + 1; j < FE_NL; j++) acc[i + j] += a2 * a.v[j];
  }
  return fe_reduce39(acc);
}

// Lane `lane` of limb-major rows: element (row r) at base[r * n + lane].
__device__ __forceinline__ fe_t fe_load(const int32_t *__restrict__ base, int64_t n,
                                        int64_t lane) {
  fe_t r;
#pragma unroll
  for (int i = 0; i < FE_NL; i++) r.v[i] = __ldg(base + (int64_t)i * n + lane);
  return r;
}

__device__ __forceinline__ void fe_store(int32_t *__restrict__ base, int64_t n, int64_t lane,
                                         const fe_t &x) {
#pragma unroll
  for (int i = 0; i < FE_NL; i++) base[(int64_t)i * n + lane] = x.v[i];
}
