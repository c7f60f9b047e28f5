// BLS12-381 kernels for Hopper (sm_90a): fp381_mul and fp12_sparse_mul.
//
// Replaces the Pallas TPU kernels of tendermint_tpu/ops/pallas_bls.py:
//   tm_fp381_mul       <- _fp381_mul_kernel / fp381_mul (pallas_call at :344)
//   tm_fp12_sparse_mul <- _fp12_sparse_mul_kernel / fp12_sparse_mul (at :387)
//
// Layout: a field batch is int32 (G, 33, n) — group g, limb i, lane j at
// (g * 33 + i) * n + j; G stacks independent batches (the products of one
// formula stage), so a stage is one launch. Fp12 values are (6, 2, 33, n):
// w-basis coefficient m, Fp2 component c; a sparse line (c0, c3, c5) is
// (3, 2, 33, n). Neighbouring threads own neighbouring lanes, so each limb
// row is read and written as one coalesced access per warp.
//
// What bounds each kernel on the H100, and what the design does about it:
// - fp381_mul is one thread per product: 2,211 int32 multiply-adds (1,089
//   product, 1,089 reduction, 33 m_i) against 396 bytes (two operands in,
//   one out), so at every width it is bound by its multiply-adds, not its
//   bytes (~5.6 multiply-adds per byte against the card's ~5 IMAD/byte
//   balance). The 66-word accumulator never leaves registers: the TPU
//   kernel's reason to exist (65 HBM-materialized accumulator rows in XLA).
//   One operand is read limb by limb into the product so that the
//   accumulator and the other operand are all that stays live.
// - fp12_sparse_mul on the Miller loop's 2 lanes is latency-bound by
//   construction: 12 threads. The per-lane state (f: 396 words, the line:
//   198, 11 Fp2 accumulators: 726) does not fit one thread's registers, so
//   one thread computes one output coefficient k of one lane. acc[k] and
//   acc[k+6] together take exactly 3 Fp2 products for every k (k = 0, 1, 2:
//   1 + 2; k = 3, 4: 2 + 1; k = 5: 3 + 0), 9 base products per thread.
// Shared-memory staging of the line, a wider radix with 64-bit products and
// fusing whole Miller steps are later work.
#include <cuda_runtime.h>
#include <stdint.h>

#include "fp381.cuh"

#define BLS_THREADS 128

__global__ void __launch_bounds__(BLS_THREADS)
fp381_mul_kernel(const int32_t *__restrict__ a, const int32_t *__restrict__ b,
                 int32_t *__restrict__ out, int64_t n, int64_t groups) {
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n * groups) return;
  const int64_t g = t / n;
  const int64_t base = g * FP_NL * n + (t - g * n);
  const fp_t bv = fp_load(b + base, n, 0);
  const int32_t *__restrict__ ap = a + base;
  const fp_t r = fp_mul_stream([&](int i) { return __ldg(ap + (int64_t)i * n); }, bv);
  fp_store(out + base, n, 0, r);
}

// The terms of pallas_bls.sparse_mul12 that land on w^k, in the reference's
// loop order (line coefficient j in (0, 3, 5) outer, f index i inner): for
// k = 0..10 a list of (f index, line index), at most 3 terms.
__device__ __constant__ int8_t SPARSE_TERMS[11][3][2] = {
    {{0, 0}, {-1, -1}, {-1, -1}},  // k=0: f0 c0
    {{1, 0}, {-1, -1}, {-1, -1}},
    {{2, 0}, {-1, -1}, {-1, -1}},
    {{3, 0}, {0, 1}, {-1, -1}},    // k=3: f3 c0, f0 c3
    {{4, 0}, {1, 1}, {-1, -1}},
    {{5, 0}, {2, 1}, {0, 2}},      // k=5: f5 c0, f2 c3, f0 c5
    {{3, 1}, {1, 2}, {-1, -1}},    // k=6: f3 c3, f1 c5
    {{4, 1}, {2, 2}, {-1, -1}},
    {{5, 1}, {3, 2}, {-1, -1}},
    {{4, 2}, {-1, -1}, {-1, -1}},  // k=9: f4 c5 (f6 c3 does not exist)
    {{5, 2}, {-1, -1}, {-1, -1}},
};

__device__ __forceinline__ fp2_t fp2_load(const int32_t *__restrict__ planes, int64_t idx,
                                          int64_t n, int64_t lane) {
  const int64_t ps = (int64_t)FP_NL * n;  // plane stride
  return {fp_load(planes + (2 * idx) * ps, n, lane), fp_load(planes + (2 * idx + 1) * ps, n, lane)};
}

// acc = sum of the terms of w^k, as `acc = t if acc is None else add2(acc, t)`.
__device__ __forceinline__ fp2_t sparse_acc(const int32_t *__restrict__ f,
                                            const int32_t *__restrict__ line, int k, int64_t n,
                                            int64_t lane) {
  fp2_t acc;
#pragma unroll 1
  for (int s = 0; s < 3; s++) {
    const int fi = SPARSE_TERMS[k][s][0];
    if (fi < 0) break;
    const fp2_t t = fp2_mul(fp2_load(f, fi, n, lane), fp2_load(line, SPARSE_TERMS[k][s][1], n, lane));
    if (s == 0)
      acc = t;
    else
      acc = fp2_add(acc, t);
  }
  return acc;
}

// out[k] = add2(acc[k], mul2_by_xi(acc[k + 6])) for k < 5, out[5] = acc[5]
// (w^6 = XI). Thread t: coefficient k = t / n, lane t % n.
__global__ void __launch_bounds__(BLS_THREADS)
fp12_sparse_mul_kernel(const int32_t *__restrict__ f, const int32_t *__restrict__ line,
                       int32_t *__restrict__ out, int64_t n) {
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= 6 * n) return;
  const int k = (int)(t / n);
  const int64_t lane = t - (int64_t)k * n;
  fp2_t r = sparse_acc(f, line, k, n, lane);
  if (k < 5) r = fp2_add(r, fp2_mul_by_xi(sparse_acc(f, line, k + 6, n, lane)));
  const int64_t ps = (int64_t)FP_NL * n;
  fp_store(out + (2 * k) * ps, n, lane, r.c0);
  fp_store(out + (2 * k + 1) * ps, n, lane, r.c1);
}

static inline unsigned bls_blocks(int64_t threads) {
  return (unsigned)((threads + BLS_THREADS - 1) / BLS_THREADS);
}

// C interface (ctypes): launch on `stream`, return cudaGetLastError().
extern "C" int tm_fp381_mul(const int32_t *a, const int32_t *b, int32_t *out, int64_t n,
                            int64_t groups, void *stream) {
  fp381_mul_kernel<<<bls_blocks(n * groups), BLS_THREADS, 0, (cudaStream_t)stream>>>(
      a, b, out, n, groups);
  return (int)cudaGetLastError();
}

extern "C" int tm_fp12_sparse_mul(const int32_t *f, const int32_t *line, int32_t *out,
                                  int64_t n, void *stream) {
  fp12_sparse_mul_kernel<<<bls_blocks(6 * n), BLS_THREADS, 0, (cudaStream_t)stream>>>(
      f, line, out, n);
  return (int)cudaGetLastError();
}
