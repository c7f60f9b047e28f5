// Curve-point kernels for Hopper (sm_90a): padd, pdbl(times), fsquare_chain.
//
// Replaces the Pallas TPU kernels of tendermint_tpu/ops/pallas_fe.py:
//   tm_padd          <- _padd_kernel / _padd_call  (public pallas_fe.padd)
//   tm_pdbl          <- _pdbl_kernel, _pdbl_n_kernel / _pdbl_call (pallas_fe.pdbl)
//   tm_fsquare_chain <- _fsq_n_kernel / _fsq_call  (pallas_fe.fsquare_chain)
//
// Layout: a point batch is int32 (4, 20, n) — coordinate c, limb i, lane j at
// c*20*n + i*n + j; a field batch is (20, n). One thread owns one lane: it
// reads its limbs (neighbouring threads read neighbouring words, so every
// limb row is one coalesced 128-byte access per warp), does all the field
// arithmetic in registers, and writes its output limbs once.
//
// What bounds each kernel on the H100, and what the design does about it:
// - padd at the MSM's widths (up to 327,680 lanes: the first tree level, 32
//   windows x 10,240 pairs) moves 960 B per lane (two points in, one out)
//   against 3,620 int32 multiply-adds per lane: at 3.35 TB/s and ~16.7 T
//   IMAD/s the two bounds are close, with bytes the larger. The kernel reads
//   each input limb once and writes each output limb once, nothing else
//   touches memory; the point of the design is that no 39-row product
//   accumulator ever leaves registers (the TPU kernel's reason to exist,
//   pallas_fe.py:1-12).
// - pdbl runs the MSM's window fold and bucket sum on 32 lanes or fewer with
//   up to 128 chained doublings (a latency-bound dependent chain on a warp or
//   less), and the per-signature ladder's 1-4 doublings on up to 16,384
//   lanes. The run-time loop keeps x, y, z in registers across doublings (t
//   is only produced on the last one, since dbl-2008-hwcd never reads it)
//   and replaces the TPU's 8-deep cap.
// - fsquare_chain (10,240-20,480 lanes, k up to 100) is bound by its
//   multiply-adds (210 per squaring per lane); the element stays in registers
//   for all k squarings, k is a run-time count (no 16-deep cap).
// Register pressure is the known cost: two points are 160 words and a
// product accumulator 39 more; loading each coordinate pair just before its
// product keeps padd within the register file (`-Xptxas -v` in PERF.md).
// A wider radix with 64-bit products, shared-memory staging of the second
// operand and fusing the tree's even/odd lane gather are later work.
#include <cuda_runtime.h>
#include <stdint.h>

#include "fe25519.cuh"

#define PK_THREADS 128

// Unified a=-1 extended add, add-2008-hwcd-3 (pallas_fe._padd_rows).
__global__ void __launch_bounds__(PK_THREADS)
padd_kernel(const int32_t *__restrict__ p, const int32_t *__restrict__ q,
            int32_t *__restrict__ out, int64_t n) {
  const int64_t lane = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n) return;
  const int64_t cs = (int64_t)FE_NL * n;  // coordinate stride
  fe_t a, b, c, d;
  {
    const fe_t px = fe_load(p, n, lane), py = fe_load(p + cs, n, lane);
    const fe_t qx = fe_load(q, n, lane), qy = fe_load(q + cs, n, lane);
    a = fe_mul(fe_sub(py, px), fe_sub(qy, qx));
    b = fe_mul(fe_add(py, px), fe_add(qy, qx));
  }
  {
    const fe_t pt = fe_load(p + 3 * cs, n, lane), qt = fe_load(q + 3 * cs, n, lane);
    c = fe_mul_const(fe_mul(pt, qt), FE_D2);
  }
  {
    const fe_t pz = fe_load(p + 2 * cs, n, lane), qz = fe_load(q + 2 * cs, n, lane);
    d = fe_mul_small(fe_mul(pz, qz), 2);
  }
  const fe_t e = fe_sub(b, a);
  const fe_t f = fe_sub(d, c);
  const fe_t g = fe_add(d, c);
  const fe_t h = fe_add(b, a);
  fe_store(out, n, lane, fe_mul(e, f));
  fe_store(out + cs, n, lane, fe_mul(g, h));
  fe_store(out + 2 * cs, n, lane, fe_mul(f, g));
  fe_store(out + 3 * cs, n, lane, fe_mul(e, h));
}

// `times` chained dbl-2008-hwcd doublings for a=-1 (pallas_fe._pdbl_rows).
__global__ void __launch_bounds__(PK_THREADS)
pdbl_kernel(const int32_t *__restrict__ p, int32_t *__restrict__ out, int64_t n,
            int times) {
  const int64_t lane = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n) return;
  const int64_t cs = (int64_t)FE_NL * n;
  fe_t x = fe_load(p, n, lane);
  fe_t y = fe_load(p + cs, n, lane);
  fe_t z = fe_load(p + 2 * cs, n, lane);
  fe_t t;
  for (int it = 0; it < times; it++) {
    const fe_t xx = fe_square(x);
    const fe_t yy = fe_square(y);
    const fe_t zz2 = fe_mul_small(fe_square(z), 2);
    const fe_t xy2 = fe_square(fe_add(x, y));
    const fe_t s = fe_add(xx, yy);
    const fe_t e = fe_sub(xy2, s);
    const fe_t g = fe_sub(yy, xx);
    const fe_t f = fe_sub(g, zz2);
    const fe_t h = fe_neg(s);
    x = fe_mul(e, f);
    y = fe_mul(g, h);
    z = fe_mul(f, g);
    if (it == times - 1) t = fe_mul(e, h);
  }
  fe_store(out, n, lane, x);
  fe_store(out + cs, n, lane, y);
  fe_store(out + 2 * cs, n, lane, z);
  fe_store(out + 3 * cs, n, lane, t);
}

// x -> x^(2^k) (pallas_fe._fsq_n_kernel).
__global__ void __launch_bounds__(PK_THREADS)
fsquare_chain_kernel(const int32_t *__restrict__ x, int32_t *__restrict__ out, int64_t n,
                     int k) {
  const int64_t lane = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n) return;
  fe_t v = fe_load(x, n, lane);
  for (int it = 0; it < k; it++) v = fe_square(v);
  fe_store(out, n, lane, v);
}

static inline unsigned pk_blocks(int64_t n) {
  return (unsigned)((n + PK_THREADS - 1) / PK_THREADS);
}

// C interface (ctypes): launch on `stream`, return cudaGetLastError().
extern "C" int tm_padd(const int32_t *p, const int32_t *q, int32_t *out, int64_t n,
                       void *stream) {
  padd_kernel<<<pk_blocks(n), PK_THREADS, 0, (cudaStream_t)stream>>>(p, q, out, n);
  return (int)cudaGetLastError();
}

extern "C" int tm_pdbl(const int32_t *p, int32_t *out, int64_t n, int times, void *stream) {
  pdbl_kernel<<<pk_blocks(n), PK_THREADS, 0, (cudaStream_t)stream>>>(p, out, n, times);
  return (int)cudaGetLastError();
}

extern "C" int tm_fsquare_chain(const int32_t *x, int32_t *out, int64_t n, int k,
                                void *stream) {
  fsquare_chain_kernel<<<pk_blocks(n), PK_THREADS, 0, (cudaStream_t)stream>>>(x, out, n, k);
  return (int)cudaGetLastError();
}
