// BLS12-381 base-field arithmetic for one lane, in registers.
//
// The row math of tendermint_tpu/ops/fp381.py (carry_rows, add_rows,
// fold_top_rows, sub_rows, _mul_rows_loop), which ops/fp381.py mirrors in
// torch: a field element is 33 int32 limbs in uniform radix 2^12, in the
// Montgomery domain (R = 2^396). Every op runs the reference's exact carry
// schedule in int32, so the limbs a kernel writes equal the reference's limb
// for limb, not only mod p (the carried form is not unique: a limb may sit at
// 4096). The reference's bound holds for any order of the additions within a
// sum: every accumulator stays below 1.11e9 < 2^31 and non-negative.
//
// Every loop has a compile-time trip count and is fully unrolled; p's limbs
// and the sub/fold constants sit in __constant__ memory, so the unrolled
// multiply-adds take them as constant-bank operands.
// tests/test_torch_fp381.py checks these tables against ops/fp381.py.
#pragma once
#include <stdint.h>

#define FP_NL 33
#define FP_RADIX 12
#define FP_MASK 4095
#define FP_PPRIME 4093  // -p^-1 mod 2^12

// p
__device__ __constant__ int32_t FP_P[FP_NL] = {
    2731, 4090, 4095, 4095, 2558, 4091, 1023, 2837, 4094, 2751, 1054,
    3938, 1712, 2575, 210,  1651, 703,  2129, 1267, 1208, 1143, 3446,
    2988, 1076, 1974, 442,  2635, 3689, 2431, 3747, 273,  416,  0};
// COMP + CORR of sub: a - b == a + (COMP - b) + CORR (mod p).
__device__ __constant__ int32_t FP_COMP_CORR[FP_NL] = {
    10982, 11336, 12285, 12285, 9035,  11507, 10237, 9412,  12053, 10621, 11601,
    8783,  9993,  11958, 8817,  11261, 10515, 10350, 8528,  10277, 10992, 11323,
    11819, 11431, 11448, 9127,  10295, 9586,  10988, 11709, 11890, 8521,  16};
// W384 = 2^384 mod p, with W384[32] - 1 (= -1) in the top limb: a + top * W
// gives limb i + top * W384_i below 32 and top * W384_32 = 0 in limb 32.
__device__ __constant__ int32_t FP_W384[FP_NL] = {
    4093, 47,   0,    0,    1545, 39,   3072, 3136, 11,   3904, 2795,
    1419, 967,  1397, 2200, 1524, 1861, 1317, 880,  1413, 1998, 1751,
    1772, 2597, 2711, 113,  860,  3657, 2688, 3135, 1630, 351,  -1};

struct fp_t {
  int32_t v[FP_NL];
};

// `passes` parallel carry passes, no top wrap (fp381.carry_rows).
template <int PASSES>
__device__ __forceinline__ void fp_carry(fp_t &x) {
#pragma unroll
  for (int pass = 0; pass < PASSES; pass++) {
    int32_t c[FP_NL];
#pragma unroll
    for (int i = 0; i < FP_NL; i++) c[i] = x.v[i] >> FP_RADIX;
    x.v[0] &= FP_MASK;
#pragma unroll
    for (int i = 1; i < FP_NL; i++) x.v[i] = (x.v[i] & FP_MASK) + c[i - 1];
  }
}

__device__ __forceinline__ fp_t fp_add(const fp_t &a, const fp_t &b) {
  fp_t r;
#pragma unroll
  for (int i = 0; i < FP_NL; i++) r.v[i] = a.v[i] + b.v[i];
  fp_carry<1>(r);
  return r;
}

// fold_top_rows: limb 32 folded through 2^384 mod p, two carry passes.
__device__ __forceinline__ void fp_fold_top(fp_t &x) {
  const int32_t hi = x.v[FP_NL - 1];
#pragma unroll
  for (int i = 0; i < FP_NL; i++) x.v[i] += hi * FP_W384[i];
  fp_carry<2>(x);
}

__device__ __forceinline__ fp_t fp_sub(const fp_t &a, const fp_t &b) {
  fp_t r;
#pragma unroll
  for (int i = 0; i < FP_NL; i++) r.v[i] = a.v[i] - b.v[i] + FP_COMP_CORR[i];
  fp_carry<2>(r);
  fp_fold_top(r);
  return r;
}

// Montgomery product a * b * 2^-396 (fp381._mul_rows_loop): the 65-limb
// schoolbook product, 33 interleaved reduction steps (step i zeroes limb i:
// m = limb_i * (-p^-1) mod 2^12, limbs i..i+32 += m * p, limb i+1 += limb_i
// >> 12), then 3 carry passes over the top 33 limbs. b is held in registers;
// a's limbs are read one at a time through `a_at(i)` so that only the 66-word
// accumulator and b stay live: 1,089 + 1,089 multiply-adds and 33 m_i.
template <typename A>
__device__ __forceinline__ fp_t fp_mul_stream(A a_at, const fp_t &b) {
  int32_t prod[2 * FP_NL];
#pragma unroll
  for (int k = 0; k < 2 * FP_NL; k++) prod[k] = 0;
#pragma unroll
  for (int i = 0; i < FP_NL; i++) {
    const int32_t ai = a_at(i);
#pragma unroll
    for (int j = 0; j < FP_NL; j++) prod[i + j] += ai * b.v[j];
  }
#pragma unroll
  for (int i = 0; i < FP_NL; i++) {
    const int32_t m = ((prod[i] & FP_MASK) * FP_PPRIME) & FP_MASK;
#pragma unroll
    for (int j = 0; j < FP_NL; j++) prod[i + j] += m * FP_P[j];
    prod[i + 1] += prod[i] >> FP_RADIX;
  }
  fp_t r;
#pragma unroll
  for (int k = 0; k < FP_NL; k++) r.v[k] = prod[FP_NL + k];
  fp_carry<3>(r);
  return r;
}

// Lane `lane` of limb-major rows: limb i at base[i * n + lane].
__device__ __forceinline__ fp_t fp_load(const int32_t *__restrict__ base, int64_t n,
                                        int64_t lane) {
  fp_t r;
#pragma unroll
  for (int i = 0; i < FP_NL; i++) r.v[i] = __ldg(base + (int64_t)i * n + lane);
  return r;
}

__device__ __forceinline__ void fp_store(int32_t *__restrict__ base, int64_t n, int64_t lane,
                                         const fp_t &x) {
#pragma unroll
  for (int i = 0; i < FP_NL; i++) base[(int64_t)i * n + lane] = x.v[i];
}
