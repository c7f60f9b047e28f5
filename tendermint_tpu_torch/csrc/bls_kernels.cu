// BLS12-381 kernels for Hopper (sm_90a): fp381_mul and fp12_sparse_mul.
//
// Replaces the Pallas TPU kernels of tendermint_tpu/ops/pallas_bls.py:
//   tm_fp381_mul, tm_fp381_mul_few <- _fp381_mul_kernel / fp381_mul (pallas_call at :344)
//   tm_fp12_sparse_mul <- _fp12_sparse_mul_kernel / fp12_sparse_mul (at :387)
//
// Layout: a field batch is int32 (G, 33, n) — group g, limb i, lane j at
// (g * 33 + i) * n + j; G stacks independent batches (the products of one
// formula stage), so a stage is one launch. Fp12 values are (6, 2, 33, n):
// w-basis coefficient m, Fp2 component c; a sparse line (c0, c3, c5) is
// (3, 2, 33, n). In the thread-per-product kernels neighbouring threads own
// neighbouring lanes, so each limb row is read and written as one coalesced
// access per warp.
//
// What bounds each kernel on the H100, and what the design does about it:
// - fp381_mul has two kernels behind one wrapper (cuda_bls.fp381_mul_entry).
//   fp381_mul_kernel is one thread per product: 2,211 int32 multiply-adds
//   (1,089 product, 1,089 reduction, 33 m_i) against 396 bytes (two operands
//   in, one out), so on many products it is bound by its multiply-adds, not
//   its bytes (~5.6 multiply-adds per byte against the card's ~5 IMAD/byte
//   balance). The 66-word accumulator never leaves registers: the TPU
//   kernel's reason to exist (65 HBM-materialized accumulator rows in XLA).
//   One operand is read limb by limb into the product so that the
//   accumulator and the other operand are all that stays live. It keeps the
//   key fold's wide levels (more than FP_FEW_PRODUCTS products).
//   The Miller loop's launches hold 8-216 products on 2 lanes: one or two
//   blocks, so one thread's ~2,900 instructions in a row set the time.
//   fp381_mul_few_kernel gives each product a warp (fp_mul_group,
//   fp381.cuh: 32 lanes of 2 limb positions; M's digits from a truncated
//   product T N', so no chain of 33 dependent digits; carries by
//   __shfl_sync): ~830 instructions a lane (tools/fp_probe.py), about half
//   of its time the launch, loads and stores that a kernel with no product
//   takes. Groups of 3, 4, 8, 11, 16 and 17 threads a product were slower
//   at the Miller shapes (PERF.md §6).
// - fp12_sparse_mul is 54 base products a lane (18 Karatsuba Fp2 products of
//   3) and ~200 adds and subs. On the Miller loop's 2 lanes it is latency-
//   bound: the work of one lane is what one thread per product can overlap.
//   So a thread runs one base product, not one output coefficient (which
//   took 9 products in a row, 255 registers and 952 B of spill). A block of
//   SP_THREADS threads holds SP_LANES lanes; per lane, in shared memory:
//   0. 27 threads stage the operands: f_i.c0, f_i.c1, f_i.c0 + f_i.c1 and the
//      same three of each line coefficient (fp_add on load);
//   1. 54 threads each run one Montgomery product through fp_mul_stream,
//      the operand a streamed limb by limb from shared memory and b in
//      registers (fp381_mul_kernel's schedule: 127 registers, no spill);
//   2. 18 threads each finish one Karatsuba product, c0 = t0 - t1 and
//      c1 = t2 - (t0 + t1), over its t0 and t1 slots;
//   3. 12 threads, one per output coefficient k and component, sum the
//      terms of w^k and of w^(k+6) in the reference's order (SPARSE_TERMS),
//      apply mul2_by_xi to the second (both of its components) and store.
//   A barrier separates the phases. The Miller step's 2 lanes are one block
//   of 4 warps on 4 sub-partitions; 16,384 lanes are 8,192 blocks. Measured
//   by chip_smoke.py on an H100 SXM (700 W): ~0.009 ms at 2 lanes (a thread
//   per coefficient: 0.12 ms), ~0.26 ms at 16,384 lanes (0.46 ms); 128
//   registers, no spill.
// Fusing whole Miller steps is later work.
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

// fp381_mul on few products: a warp a product (fp_mul_group, fp381.cuh),
// FP_FEW_WARPS warps a block. Lane t loads limbs 2t, 2t + 1 of its product's
// operands (zeros past limb 32) and stores the limbs fpg_out_limb names.
#define FP_FEW_WARPS 4

__global__ void __launch_bounds__(32 * FP_FEW_WARPS)
fp381_mul_few_kernel(const int32_t *__restrict__ a, const int32_t *__restrict__ b,
                     int32_t *__restrict__ out, int64_t n, int64_t total) {
  __shared__ fp_group_smem sm[FP_FEW_WARPS];
  const int t = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int64_t pr = (int64_t)blockIdx.x * FP_FEW_WARPS + w;
  if (pr >= total) return;  // a warp past the end
  const int64_t g = pr / n;
  const int64_t base = g * FP_NL * n + (pr - g * n);
  int32_t av[FPG_L], bv[FPG_L], rv[FPG_L];
#pragma unroll
  for (int s = 0; s < FPG_L; s++) {
    const int p = FPG_L * t + s;
    av[s] = p < FP_NL ? __ldg(a + base + (int64_t)p * n) : 0;
    bv[s] = p < FP_NL ? __ldg(b + base + (int64_t)p * n) : 0;
  }
  fp_mul_group(av, bv, rv, sm[w], t);
#pragma unroll
  for (int s = 0; s < FPG_L; s++) {
    const int k = fpg_out_limb(t, s);
    if (k >= 0) out[base + (int64_t)k * n] = rv[s];
  }
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

#define SP_LANES 2      // lanes per block
#define SP_THREADS 128  // 54 product threads per lane
#define SP_OPS 27       // staged operands per lane: 3 per Fp2 of f (18), of the line (9)
#define SP_PRODS 54     // base products per lane: 3 per Fp2 product (f_i, line_l) at 3 (6 l + i)

// Shared-memory field element: 33 consecutive words (an odd stride, so the
// threads of a warp touching different elements hit different banks).
__device__ __forceinline__ fp_t fp_ld_sh(const int32_t *p) {
  fp_t r;
#pragma unroll
  for (int i = 0; i < FP_NL; i++) r.v[i] = p[i];
  return r;
}

__device__ __forceinline__ void fp_st_sh(int32_t *p, const fp_t &x) {
#pragma unroll
  for (int i = 0; i < FP_NL; i++) p[i] = x.v[i];
}

// Component c of the sum of the Karatsuba-finished products of w^k (phase 3),
// in SPARSE_TERMS order: `acc = t if acc is None else add2(acc, t)`.
__device__ __forceinline__ fp_t sparse_term_sum(const int32_t *prod, int k, int c) {
  fp_t acc = fp_ld_sh(prod + (3 * (6 * SPARSE_TERMS[k][0][1] + SPARSE_TERMS[k][0][0]) + c) * FP_NL);
#pragma unroll 1
  for (int s = 1; s < 3; s++) {
    const int fi = SPARSE_TERMS[k][s][0];
    if (fi < 0) break;
    acc = fp_add(acc, fp_ld_sh(prod + (3 * (6 * SPARSE_TERMS[k][s][1] + fi) + c) * FP_NL));
  }
  return acc;
}

// f (6, 2, 33, n) times the line (3, 2, 33, n) -> out (6, 2, 33, n):
// out[k] = add2(acc[k], mul2_by_xi(acc[k + 6])) for k < 5, out[5] = acc[5]
// (w^6 = XI). Block b holds lanes SP_LANES b + (0 .. SP_LANES - 1).
__global__ void __launch_bounds__(SP_THREADS, 4)
fp12_sparse_mul_kernel(const int32_t *__restrict__ f, const int32_t *__restrict__ line,
                       int32_t *__restrict__ out, int64_t n) {
  __shared__ int32_t ops[SP_LANES][SP_OPS * FP_NL];
  __shared__ int32_t prod[SP_LANES][SP_PRODS * FP_NL];
  const int t = threadIdx.x;
  const int64_t lane0 = (int64_t)blockIdx.x * SP_LANES;
  const int64_t ps = (int64_t)FP_NL * n;  // plane stride: one Fp row block of (.., 33, n)

  // 0. operand slot o of lane lb: o = 3 i + s (f_i), 18 + 3 l + s (line_l);
  //    s = 0, 1: component s; s = 2: c0 + c1
  if (t < SP_LANES * SP_OPS) {
    const int lb = t / SP_OPS, o = t % SP_OPS;
    const int64_t lane = lane0 + lb;
    if (lane < n) {
      const int32_t *src = o < 18 ? f + (int64_t)(2 * (o / 3)) * ps : line + (int64_t)(2 * ((o - 18) / 3)) * ps;
      const int s = (o < 18 ? o : o - 18) % 3;
      fp_t x;
      if (s < 2)
        x = fp_load(src + s * ps, n, lane);
      else
        x = fp_add(fp_load(src, n, lane), fp_load(src + ps, n, lane));
      fp_st_sh(&ops[lb][o * FP_NL], x);
    }
  }
  __syncthreads();

  // 1. product p = 3 (6 l + i) + s: t_s of mul2(f_i, line_l)
  if (t < SP_LANES * SP_PRODS) {
    const int lb = t / SP_PRODS, p = t % SP_PRODS;
    if (lane0 + lb < n) {
      const int q = p / 3, s = p % 3, l = q / 6, i = q % 6;
      const int32_t *a = &ops[lb][(3 * i + s) * FP_NL];
      const fp_t b = fp_ld_sh(&ops[lb][(18 + 3 * l + s) * FP_NL]);
      fp_st_sh(&prod[lb][p * FP_NL], fp_mul_stream([&](int k) { return a[k]; }, b));
    }
  }
  __syncthreads();

  // 2. Karatsuba finish of Fp2 product q: c0 = t0 - t1 into t0's slot,
  //    c1 = t2 - (t0 + t1) into t1's
  if (t < SP_LANES * 18) {
    const int lb = t / 18, q = t % 18;
    if (lane0 + lb < n) {
      int32_t *pq = &prod[lb][3 * q * FP_NL];
      const fp_t t0 = fp_ld_sh(pq), t1 = fp_ld_sh(pq + FP_NL);
      const fp_t c0 = fp_sub(t0, t1);
      const fp_t s01 = fp_add(t0, t1);
      fp_st_sh(pq, c0);
      fp_st_sh(pq + FP_NL, fp_sub(fp_ld_sh(pq + 2 * FP_NL), s01));
    }
  }
  __syncthreads();

  // 3. output coefficient k, component c
  if (t < SP_LANES * 12) {
    const int lb = t / 12, k = (t % 12) >> 1, c = t & 1;
    const int64_t lane = lane0 + lb;
    if (lane < n) {
      // mul2_by_xi(acc[k + 6]) first, (a0 - a1, fold_top(a0 + a1)), so that
      // at most three field elements are live
      fp_t x;
      if (k < 5) {
        const fp_t a0 = sparse_term_sum(prod[lb], k + 6, 0);
        const fp_t a1 = sparse_term_sum(prod[lb], k + 6, 1);
        if (c == 0) {
          x = fp_sub(a0, a1);
        } else {
          x = fp_add(a0, a1);
          fp_fold_top(x);
        }
      }
      fp_t r = sparse_term_sum(prod[lb], k, c);
      if (k < 5) r = fp_add(r, x);
      fp_store(out + (int64_t)(2 * k + c) * ps, n, lane, r);
    }
  }
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

extern "C" int tm_fp381_mul_few(const int32_t *a, const int32_t *b, int32_t *out, int64_t n,
                                int64_t groups, void *stream) {
  fp381_mul_few_kernel<<<(unsigned)((n * groups + FP_FEW_WARPS - 1) / FP_FEW_WARPS),
                         32 * FP_FEW_WARPS, 0, (cudaStream_t)stream>>>(a, b, out, n, n * groups);
  return (int)cudaGetLastError();
}

extern "C" int tm_fp12_sparse_mul(const int32_t *f, const int32_t *line, int32_t *out,
                                  int64_t n, void *stream) {
  const unsigned blocks = (unsigned)((n + SP_LANES - 1) / SP_LANES);
  fp12_sparse_mul_kernel<<<blocks, SP_THREADS, 0, (cudaStream_t)stream>>>(f, line, out, n);
  return (int)cudaGetLastError();
}
