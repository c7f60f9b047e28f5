// Curve-point kernels for Hopper (sm_90a): padd, pdbl(times), fsquare_chain.
//
// Replaces the Pallas TPU kernels of tendermint_tpu/ops/pallas_fe.py:
//   tm_padd, tm_padd_lanes <- _padd_kernel / _padd_call  (public pallas_fe.padd)
//   tm_pdbl, tm_pdbl_lanes <- _pdbl_kernel, _pdbl_n_kernel / _pdbl_call (pallas_fe.pdbl)
//   tm_fsquare_chain <- _fsq_n_kernel / _fsq_call  (pallas_fe.fsquare_chain)
//
// Layout: a point batch is int32 (4, 20, n) — coordinate c, limb i, lane j at
// c*20*n + i*n + j; a field batch is (20, n). In the thread-per-lane kernels
// one thread owns one lane: it reads its limbs (neighbouring threads read
// neighbouring words, so every limb row is one coalesced 128-byte access per
// warp), does all the field arithmetic in registers, and writes its output
// limbs once.
//
// What bounds each kernel on the H100, and what the design does about it:
// - padd has two kernels behind one wrapper (cuda_fe.padd_entry). On the
//   MSM's top tree, bucket tail, window fold and the streamed partial sums
//   it runs on 1-192 lanes: one add per lane, a few warps on the whole card,
//   so one thread's chain of ~3,620 dependent multiply-adds and their carries
//   sets the time. There padd_lanes_kernel gives each lane a warp (w_padd,
//   fe25519_warp.cuh: the limbs split over the warp, each batch of
//   independent products side by side). The per-signature ladder's 16,384
//   lanes move 960 B per lane (two points in, one out) against 3,620 int32
//   multiply-adds, close to both the byte and the operation bound: there
//   padd_kernel keeps one thread per lane, reads each input limb once and
//   writes each output limb once, and no 39-row product accumulator ever
//   leaves registers (the TPU kernel's reason to exist, pallas_fe.py:1-12).
// - pdbl has two kernels behind one wrapper. The MSM's window fold and
//   [256]P_255 run up to 128 chained doublings on 32 lanes or fewer: a
//   dependent chain, bound by latency, not by the card's rate. There
//   pdbl_lanes_kernel gives each lane a warp and splits every field op
//   across the limbs, ~1/6 of one thread's chain per doubling. The
//   per-signature ladder's 1-4 doublings on up to 16,384 lanes are
//   throughput-bound: pdbl_kernel keeps one thread per lane. Both keep x, y,
//   z in registers across doublings (t is only produced on the last one,
//   since dbl-2008-hwcd never reads it) and take `times` at run time.
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
#include "fe25519_warp.cuh"

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

// ---------------------------------------------------------------------------
// pdbl and padd on few lanes: one warp per lane, limb-parallel
// (fe25519_warp.cuh). The doubling's independent field ops run side by side
// in one instruction stream (4 squares, then 3 and 3 sums, then 4 products),
// so their latencies overlap; no block barrier, only __syncwarp around the
// shared-memory operands.

__global__ void __launch_bounds__(32)
pdbl_lanes_kernel(const int32_t *__restrict__ p, int32_t *__restrict__ out, int64_t n, int times) {
  __shared__ __align__(16) int32_t buf[8][2 * FE_NL];
  const int lane = threadIdx.x, k = lane % FE_NL, src = (k + FE_NL - 1) % FE_NL;
  const int wrap_mul = k == 0 ? FE_WRAP : 1;
  const int64_t j = blockIdx.x, cs = (int64_t)FE_NL * n, at = (int64_t)k * n + j;
  const int32_t comp = FE_COMP[k], corr = FE_CORR[k];
  int32_t x = __ldg(p + at), y = __ldg(p + cs + at), z = __ldg(p + 2 * cs + at), t = 0;
  for (int it = 0; it < times; it++) {
    int32_t w[1] = {x + y};
    w_carry<1>(w, wrap_mul, src);
    w_put(buf[0], lane, x);
    w_put(buf[1], lane, y);
    w_put(buf[2], lane, z);
    w_put(buf[3], lane, w[0]);
    __syncwarp();
    int32_t lo[4], hi[4];
    w_products<4>({buf[0], buf[1], buf[2], buf[3]}, {buf[0], buf[1], buf[2], buf[3]}, k, lo, hi);
    w_reduce39<4>(lo, hi, k, src);  // xx, yy, zz, xy2
    int32_t v[3] = {lo[2] * 2, lo[0] + lo[1], lo[1] + (comp - lo[0]) + corr};
    w_carry<3>(v, wrap_mul, src);  // zz2, s = xx + yy, g = yy - xx
    int32_t u[3] = {lo[3] + (comp - v[1]) + corr, v[2] + (comp - v[0]) + corr,
                    (comp - v[1]) + corr};
    w_carry<3>(u, wrap_mul, src);  // e = xy2 - s, f = g - zz2, h = -s
    w_put(buf[4], lane, u[0]);
    w_put(buf[5], lane, u[1]);
    w_put(buf[6], lane, v[2]);
    w_put(buf[7], lane, u[2]);
    __syncwarp();
    w_products<4>({buf[4], buf[6], buf[5], buf[4]}, {buf[5], buf[7], buf[6], buf[7]}, k, lo, hi);
    w_reduce39<4>(lo, hi, k, src);  // e f, g h, f g, e h
    x = lo[0];
    y = lo[1];
    z = lo[2];
    t = lo[3];  // dbl-2008-hwcd never reads t: only the last one is kept
  }
  if (lane < FE_NL) {
    out[at] = x;
    out[cs + at] = y;
    out[2 * cs + at] = z;
    out[3 * cs + at] = t;
  }
}

// padd on few lanes (w_padd): PL_WARPS warps a block, warp w of block b
// takes lane b * PL_WARPS + w. Lane k of the warp reads and writes limb row k
// of the lane's four coordinates.
#define PL_WARPS 4

__global__ void __launch_bounds__(32 * PL_WARPS)
padd_lanes_kernel(const int32_t *__restrict__ p, const int32_t *__restrict__ q,
                  int32_t *__restrict__ out, int64_t n) {
  __shared__ __align__(16) int32_t buf[PL_WARPS][WP_WORDS];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5, k = lane % FE_NL;
  const int64_t j = (int64_t)blockIdx.x * PL_WARPS + w;
  if (j >= n) return;  // uniform across the warp
  const int64_t cs = (int64_t)FE_NL * n, at = (int64_t)k * n + j;
  int32_t a[4], b[4], r[4];
#pragma unroll
  for (int c = 0; c < 4; c++) {
    a[c] = __ldg(p + c * cs + at);
    b[c] = __ldg(q + c * cs + at);
  }
  w_padd(a, b, r, buf[w]);
  if (lane < FE_NL) {
#pragma unroll
    for (int c = 0; c < 4; c++) out[c * cs + at] = r[c];
  }
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

extern "C" int tm_padd_lanes(const int32_t *p, const int32_t *q, int32_t *out, int64_t n,
                             void *stream) {
  padd_lanes_kernel<<<(unsigned)((n + PL_WARPS - 1) / PL_WARPS), 32 * PL_WARPS, 0,
                      (cudaStream_t)stream>>>(p, q, out, n);
  return (int)cudaGetLastError();
}

extern "C" int tm_pdbl(const int32_t *p, int32_t *out, int64_t n, int times, void *stream) {
  pdbl_kernel<<<pk_blocks(n), PK_THREADS, 0, (cudaStream_t)stream>>>(p, out, n, times);
  return (int)cudaGetLastError();
}

extern "C" int tm_pdbl_lanes(const int32_t *p, int32_t *out, int64_t n, int times,
                             void *stream) {
  pdbl_lanes_kernel<<<(unsigned)n, 32, 0, (cudaStream_t)stream>>>(p, out, n, times);
  return (int)cudaGetLastError();
}

extern "C" int tm_fsquare_chain(const int32_t *x, int32_t *out, int64_t n, int k,
                                void *stream) {
  fsquare_chain_kernel<<<pk_blocks(n), PK_THREADS, 0, (cudaStream_t)stream>>>(x, out, n, k);
  return (int)cudaGetLastError();
}
