// GF(2^255-19) arithmetic split over a warp, and the curve add built on it.
//
// One warp holds one field element per register: lane k < 20 holds limb k
// (lanes 20-31 shadow lanes 0-11: they compute the same values and store
// nothing). A product's 39 columns are integer sums whose order does not
// matter (each stays below 2^31): lane k sums column k (a_i b_{k-i}, i <= k)
// and column k + 20 (a_i b_{k+20-i}, i > k), 20 multiply-adds, reading a_i as
// a shared-memory broadcast and b from a doubled copy (b[m] = b[m mod 20]).
// Every carry pass of fe25519.cuh is one __shfl_sync from lane k - 1 (lane 0
// takes lane 19's carry x 608); in the 39-row reduction row 38's carry (lane
// 18's high column) folds onto row 19 with 608, as fe_reduce39 does. So every
// limb is the one fe25519.cuh's single-thread code computes.
//
// Used by point_kernels.cu (pdbl_lanes_kernel, padd_lanes_kernel) and
// msm_kernels.cu (bucket_fold_kernel): the kernels whose adds and doublings
// form dependent chains on few lanes, where one thread per add leaves the
// card idle.
#pragma once
#include <stdint.h>

#include "fe25519.cuh"

#define PDW_FULL 0xffffffffu

template <int NV>
__device__ __forceinline__ void w_carry(int32_t (&v)[NV], int wrap_mul, int src) {
#pragma unroll
  for (int pass = 0; pass < 4; pass++) {
    int32_t up[NV];
#pragma unroll
    for (int j = 0; j < NV; j++) up[j] = __shfl_sync(PDW_FULL, v[j] >> FE_RADIX, src);
#pragma unroll
    for (int j = 0; j < NV; j++) v[j] = (v[j] & FE_MASK) + wrap_mul * up[j];
  }
}

// Columns (k, k + 20) of a[j] * b[j]; a and b point at doubled copies.
template <int NV>
__device__ __forceinline__ void w_products(const int32_t *const (&a)[NV],
                                           const int32_t *const (&b)[NV], int k,
                                           int32_t (&lo)[NV], int32_t (&hi)[NV]) {
#pragma unroll
  for (int j = 0; j < NV; j++) lo[j] = hi[j] = 0;
#pragma unroll
  for (int i = 0; i < FE_NL; i++) {
    const bool low = i <= k;
#pragma unroll
    for (int j = 0; j < NV; j++) {
      const int32_t t = a[j][i] * b[j][k - i + FE_NL];
      if (low)
        lo[j] += t;
      else
        hi[j] += t;
    }
  }
}

// fe_reduce39 on rows (k, k + 20) per lane; the result is left in lo.
template <int NV>
__device__ __forceinline__ void w_reduce39(int32_t (&lo)[NV], int32_t (&hi)[NV], int k, int src) {
  const int32_t lo_in = k >= 1 ? 1 : 0;           // row k takes row k-1's carry
  const int32_t top_in = k == FE_NL - 1 ? FE_WRAP : 0;  // row 19 takes 608 x row 38's
  const int32_t hi_keep = k == FE_NL - 1 ? 0 : -1;      // row 39 does not exist
#pragma unroll
  for (int pass = 0; pass < 2; pass++) {
    int32_t ulo[NV], uhi[NV];
#pragma unroll
    for (int j = 0; j < NV; j++) {
      ulo[j] = __shfl_sync(PDW_FULL, lo[j] >> FE_RADIX, src);
      uhi[j] = __shfl_sync(PDW_FULL, hi[j] >> FE_RADIX, src);
    }
#pragma unroll
    for (int j = 0; j < NV; j++) {
      const int32_t nlo = (lo[j] & FE_MASK) + lo_in * ulo[j] + top_in * uhi[j];
      hi[j] = ((hi[j] & FE_MASK) + (k == 0 ? ulo[j] : uhi[j])) & hi_keep;
      lo[j] = nlo;
    }
  }
#pragma unroll
  for (int j = 0; j < NV; j++) lo[j] += FE_WRAP * hi[j];
  w_carry<NV>(lo, k == 0 ? FE_WRAP : 1, src);
}

// Limb `lane` of an element into a doubled buffer (lanes >= 20 write nothing).
__device__ __forceinline__ void w_put(int32_t *buf, int lane, int32_t v) {
  if (lane < FE_NL) {
    buf[lane] = v;
    buf[lane + FE_NL] = v;
  }
}

// Shared memory of one warp's w_padd: 9 doubled field elements.
#define WP_BUFS 9
#define WP_WORDS (WP_BUFS * 2 * FE_NL)

// p + q, the unified a=-1 extended add add-2008-hwcd-3 in fe25519.cuh's
// operation order (padd_kernel): p[c], q[c] hold this lane's limb of
// coordinate c (x, y, z, t); r[c] gets the sum's. `buf` is the warp's
// WP_WORDS words of shared memory. The add runs in three product batches,
// each batch's independent products side by side in one instruction stream
// so their latencies overlap: (py-px)(qy-qx), (py+px)(qy+qx), pt qt, pz qz;
// then (pt qt) 2d, beside the sums e = b - a, h = b + a and d = 2 pz qz;
// then e f, g h, f g, e h. Only __syncwarp orders the buffers.
__device__ __forceinline__ void w_padd(const int32_t (&p)[4], const int32_t (&q)[4],
                                       int32_t (&r)[4], int32_t *buf) {
  const int lane = threadIdx.x & 31, k = lane % FE_NL, src = (k + FE_NL - 1) % FE_NL;
  const int wrap_mul = k == 0 ? FE_WRAP : 1;
  const int32_t comp = FE_COMP[k], corr = FE_CORR[k];
  int32_t *const b0 = buf, *const b1 = buf + 2 * FE_NL, *const b2 = buf + 4 * FE_NL,
                 *const b3 = buf + 6 * FE_NL, *const b4 = buf + 8 * FE_NL,
                 *const b5 = buf + 10 * FE_NL, *const b6 = buf + 12 * FE_NL,
                 *const b7 = buf + 14 * FE_NL, *const b8 = buf + 16 * FE_NL;
  int32_t s[4] = {p[1] + (comp - p[0]) + corr, p[1] + p[0], q[1] + (comp - q[0]) + corr,
                  q[1] + q[0]};
  w_carry<4>(s, wrap_mul, src);  // py - px, py + px, qy - qx, qy + qx
  __syncwarp();                  // the warp's previous add has read buf
  w_put(b0, lane, s[0]);
  w_put(b1, lane, s[1]);
  w_put(b2, lane, p[3]);
  w_put(b3, lane, p[2]);
  w_put(b4, lane, s[2]);
  w_put(b5, lane, s[3]);
  w_put(b6, lane, q[3]);
  w_put(b7, lane, q[2]);
  w_put(b8, lane, FE_D2[k]);
  __syncwarp();
  int32_t lo[4], hi[4];
  w_products<4>({b0, b1, b2, b3}, {b4, b5, b6, b7}, k, lo, hi);
  w_reduce39<4>(lo, hi, k, src);  // a, b, pt qt, pz qz
  __syncwarp();
  w_put(b0, lane, lo[2]);
  __syncwarp();
  int32_t clo[1], chi[1];
  w_products<1>({b0}, {b8}, k, clo, chi);
  int32_t u[3] = {lo[1] + (comp - lo[0]) + corr, lo[1] + lo[0], lo[3] * 2};
  w_carry<3>(u, wrap_mul, src);     // e = b - a, h = b + a, d = 2 pz qz
  w_reduce39<1>(clo, chi, k, src);  // c = (pt qt) 2d
  int32_t v[2] = {u[2] + (comp - clo[0]) + corr, u[2] + clo[0]};
  w_carry<2>(v, wrap_mul, src);  // f = d - c, g = d + c
  __syncwarp();
  w_put(b0, lane, u[0]);
  w_put(b1, lane, v[0]);
  w_put(b2, lane, v[1]);
  w_put(b3, lane, u[1]);
  __syncwarp();
  w_products<4>({b0, b2, b1, b0}, {b1, b3, b2, b3}, k, lo, hi);
  w_reduce39<4>(lo, hi, k, src);  // x = e f, y = g h, z = f g, t = e h
#pragma unroll
  for (int c = 0; c < 4; c++) r[c] = lo[c];
}
