// Curve-point kernels for Hopper (sm_90a): padd, pdbl(times), fsquare_chain.
//
// Replaces the Pallas TPU kernels of tendermint_tpu/ops/pallas_fe.py:
//   tm_padd, tm_padd_lanes <- _padd_kernel / _padd_call  (public pallas_fe.padd)
//   tm_pdbl, tm_pdbl_lanes <- _pdbl_kernel, _pdbl_n_kernel / _pdbl_call (pallas_fe.pdbl)
//   tm_fsquare_chain <- _fsq_n_kernel / _fsq_call (pallas_fe.fsquare_chain;
//                       writes canonical limbs)
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
//   multiply-adds. One thread per lane (the thread kernel this replaced) put
//   one warp on each of the card's 528 warp schedulers, and one warp alone
//   issues a field op's product phase (FMA pipe) and its carry phase (ALU
//   pipe) one after the other. padd_quad_kernel gives each lane 4 threads
//   (pdbl_quad_kernel's layout) and each thread one field op of each round:
//   the four products a, b, pt qt, pz qz, then thread 2's product by 2d and
//   thread 3's doubling (the round waits for thread 2's second product),
//   the four sums e, f, g, h, the four output products. A lane issues ~1.5x
//   the thread kernel's instructions (its sums are carried by two threads
//   while two wait, and the 2d product runs alone), but each scheduler
//   holds ~4 warps, whose phases overlap.
// - pdbl has two kernels behind one wrapper (cuda_fe.pdbl_entry). The MSM's
//   window fold and [256]P_255 run up to 128 chained doublings on 32 lanes or
//   fewer: a dependent chain, bound by latency, not by the card's rate. There
//   (and up to PDBL_FEW_LANES = 1,024 lanes, by the card sweep)
//   pdbl_lanes_kernel gives each lane a warp and splits every field op
//   across the limbs, ~1/6 of one thread's chain per doubling. The
//   per-signature ladder runs 4 doublings on 16,384 lanes. One thread per
//   lane put one warp on each of the card's 528 warp schedulers, and one
//   warp alone issues a field op's product phase (~230 IMADs, FMA pipe) and
//   its carry phase (~340 LOP3 / LEA.HI, ALU pipe) one after the other,
//   each pipe at half rate: the doubling's ~6,600 instructions ran at ~0.4
//   a clock. pdbl_quad_kernel gives each lane 4 threads and each thread one
//   of the doubling's independent field ops: the four squares (x, y, z,
//   x + y), two rounds of sums, the four products (e f, g h, f g, e h); the
//   elements pass between the 4 threads in shared memory. A lane issues ~20%
//   more instructions (the fourth product e h runs on every doubling though
//   only the last keeps it, and one thread of the 4 sums x + y while the
//   others wait), but each scheduler holds ~4 warps, whose phases overlap.
//   x, y, z stay in shared memory across doublings; t is produced on the
//   last one only, since dbl-2008-hwcd never reads it; `times` is a
//   run-time count.
// - fsquare_chain is one kernel at every width. A lane is one dependent
//   chain of k squarings (k = 10 ... 100 in the pow_p58 / inv chains of every
//   decompression). Bytes are no limit (80 B in and out a lane); one warp's
//   dependent chain is. The paths' 512-24,576
//   lanes put at most one warp on each of the card's 528 warp schedulers up
//   to 16,384 lanes and two above, so a launch takes as long as one warp takes
//   to issue its chain. fsquare_chain_kernel (one thread a lane) therefore
//   cuts the instructions of a squaring: the radix-2^13 form (fe25519.cuh,
//   the reference's limbs) issued ~230 IMADs and ~340 LOP3 / LEA.HI carry
//   steps a squaring; this kernel packs the 20 carried limbs into 8 x 32-bit
//   words once, squares in radix 2^32 on PTX carry chains (fe25519_w32.cuh:
//   28 cross products on two row-wavefront accumulators, 2C by funnel
//   shifts, the 8 squares on one chain, T_lo + 38 T_hi, a 19-fold of the top
//   bits) with lazy reduction below 2^256, freezes once and writes canonical
//   limbs (each < 2^13, value < p: a carried form that every consumer takes;
//   the limbs differ from the reference's, the field element does not).
//   That is 89 multiply instructions a squaring (the function's bound below)
//   and 131 SASS instructions in all (tools/fe_probe.py), against 572.
//   PTX has one carry flag, so ptxas keeps the chains in order: one warp
//   still waits on each dependent step, and forms without the flag (plain
//   64-bit C++, radix 2^25.5 with 64-bit column sums) measured no faster; the
//   loop is unrolled twice, so consecutive squarings overlap at their ends.
//   Tensor cores do not apply (the products are 32-bit integer ones, IMMA
//   is int8), nor do TMA or shared memory (each lane reads 80 B once and
//   writes 80 B once, and nothing is shared between lanes).
//   A 4-threads-a-lane radix-2^13 kernel for few lanes lost to it at every
//   width of the card sweep (1,024-67,584 lanes, k = 50; PERF.md) and was
//   removed: `tools/fe_probe.py --before <an older csrc>` still times it.
//   The bound: a squaring of 8 words needs 36 products of 32-bit words (28
//   cross, 8 squares) of two multiply instructions each (lo and hi), and the
//   reduction 8 more (x 38), plus one for the fold: 89 int32 multiply
//   instructions, k x 89 + 2 (the pack's and the freeze's folds) a lane, over
//   132 SMs x 64 a clock. The radix-2^13 count was 210 a squaring.
#include <cuda_runtime.h>
#include <stdint.h>

#include "fe25519.cuh"
#include "fe25519_w32.cuh"
#include "fe25519_warp.cuh"

#define PK_THREADS 128

// `times` chained dbl-2008-hwcd doublings for a=-1 (pallas_fe._pdbl_rows) on
// 4 threads a lane, one independent field op each, in fe25519.cuh's
// operation order; the 4 threads of a lane are neighbours in one warp and
// meet at __syncwarp. Shared memory holds PQ_SLOTS elements a lane, limb
// quads [q][lane][slot] (int4). Round 1 computes s = xx + yy, g = yy - xx,
// 2 zz and s again (as fe_add / fe_sub / fe_mul_small: the same integers,
// then fe_carry); round 2 e = xy2 - s, f = g - 2 zz, h = 0 - s (fe_sub,
// fe_neg), thread 1 idle.
#define PQ_LANES 16
#define PQ_THREADS (4 * PQ_LANES)
#define PQ_SLOTS 20  // 17 used; 20 puts lanes l and l + 1 on different banks
#define PQ_X 0
#define PQ_W 3
#define PQ_XX 4
#define PQ_YY 5
#define PQ_ZZ 6
#define PQ_XY2 7
#define PQ_U 8
#define PQ_V 12
#define PQ_ZERO 16
// COMP + CORR of fe_sub: a + (COMP - b) + CORR == a - b + CC as integers.
__device__ __constant__ int32_t PQ_CC[FE_NL] = {
    15757, 16382, 16382, 16382, 16382, 16382, 16382, 16382, 16382, 16382,
    16382, 16382, 16382, 16382, 16382, 16382, 16382, 16382, 16382, 8446};
// round 1: u = a + sign * b (+ CC when the sign is -1): s, g, 2 zz, s
__device__ __constant__ int8_t PQ_R1A[4] = {PQ_YY, PQ_YY, PQ_ZZ, PQ_YY};
__device__ __constant__ int8_t PQ_R1B[4] = {PQ_XX, PQ_XX, PQ_ZZ, PQ_XX};
__device__ __constant__ int8_t PQ_R1S[4] = {1, -1, 1, 1};
// round 2: v = a - u + CC: e = xy2 - s, (unused), f = g - 2 zz, h = 0 - s
__device__ __constant__ int8_t PQ_R2A[4] = {PQ_XY2, PQ_XY2, PQ_U + 1, PQ_ZERO};
// products: e f, g h, f g, e h
__device__ __constant__ int8_t PQ_MA[4] = {PQ_V + 0, PQ_U + 1, PQ_V + 2, PQ_V + 0};
__device__ __constant__ int8_t PQ_MB[4] = {PQ_V + 2, PQ_V + 3, PQ_U + 1, PQ_V + 3};

// Element `slot` of a lane's shared-memory slots: limb quad q at
// el[q * STRIDE + slot], STRIDE = lanes a block x slots a lane.
template <int STRIDE = PQ_LANES * PQ_SLOTS>
__device__ __forceinline__ void pq_put(int4 *el, int slot, const fe_t &v) {
#pragma unroll
  for (int q = 0; q < 5; q++)
    el[q * STRIDE + slot] =
        make_int4(v.v[4 * q], v.v[4 * q + 1], v.v[4 * q + 2], v.v[4 * q + 3]);
}

template <int STRIDE = PQ_LANES * PQ_SLOTS>
__device__ __forceinline__ fe_t pq_get(const int4 *el, int slot) {
  fe_t v;
#pragma unroll
  for (int q = 0; q < 5; q++) {
    const int4 w = el[q * STRIDE + slot];
    v.v[4 * q] = w.x;
    v.v[4 * q + 1] = w.y;
    v.v[4 * q + 2] = w.z;
    v.v[4 * q + 3] = w.w;
  }
  return v;
}

__global__ void __launch_bounds__(PQ_THREADS)
pdbl_quad_kernel(const int32_t *__restrict__ p, int32_t *__restrict__ out, int64_t n,
                 int times) {
  __shared__ int4 sm[5 * PQ_LANES * PQ_SLOTS];
  const int r = threadIdx.x & 3, l = threadIdx.x >> 2;
  const int64_t at = (int64_t)blockIdx.x * PQ_LANES + l;
  const int64_t lane = at < n ? at : n - 1;  // the tail's groups redo lane n - 1, unstored
  int4 *const el = sm + l * PQ_SLOTS;
  const int64_t cs = (int64_t)FE_NL * n;
  {
    const fe_t a = fe_load(p + (r == 3 ? 0 : r) * cs, n, lane);
    if (r == 3) {
      pq_put(el, PQ_W, fe_add(a, fe_load(p + cs, n, lane)));
    } else {
      pq_put(el, r, a);
    }
    if (r == 0) {
      fe_t z;
#pragma unroll
      for (int i = 0; i < FE_NL; i++) z.v[i] = 0;
      pq_put(el, PQ_ZERO, z);
    }
  }
  for (int it = 0; it < times; it++) {
    __syncwarp();
    pq_put(el, PQ_XX + r, fe_square(pq_get(el, PQ_X + r)));
    __syncwarp();
    fe_t u;
    {
      const fe_t a = pq_get(el, PQ_R1A[r]), b = pq_get(el, PQ_R1B[r]);
      const int32_t sg = PQ_R1S[r], cc = sg < 0 ? -1 : 0;
#pragma unroll
      for (int i = 0; i < FE_NL; i++) u.v[i] = a.v[i] + sg * b.v[i] + (PQ_CC[i] & cc);
      fe_carry(u);
      pq_put(el, PQ_U + r, u);
    }
    __syncwarp();
    {
      const fe_t a = pq_get(el, PQ_R2A[r]);
      fe_t v;
#pragma unroll
      for (int i = 0; i < FE_NL; i++) v.v[i] = a.v[i] - u.v[i] + PQ_CC[i];
      fe_carry(v);
      pq_put(el, PQ_V + r, v);
    }
    __syncwarp();
    pq_put(el, PQ_X + r, fe_mul(pq_get(el, PQ_MA[r]), pq_get(el, PQ_MB[r])));  // x, y, z, t
    if (it != times - 1) {
      __syncwarp();
      if (r == 3) pq_put(el, PQ_W, fe_add(pq_get(el, PQ_X), pq_get(el, PQ_X + 1)));
    }
  }
  __syncwarp();
  if (at < n) fe_store(out + r * cs, n, lane, pq_get(el, PQ_X + r));
}

// Unified a=-1 extended add, add-2008-hwcd-3 (pallas_fe._padd_rows), on 4
// threads a lane (pdbl_quad_kernel's layout, AQ_SLOTS elements a lane, 8
// used; 12 keeps the two lanes of a quarter warp on different banks), in
// fe25519.cuh's operation order:
//   round 1: thread r computes a = (py - px)(qy - qx), b = (py + px)(qy + qx),
//            c = pt qt 2d or d = 2 pz qz (the sums as fe_sub / fe_add: the
//            same integers, then fe_carry); thread 2's c is a second product;
//   round 2: e = b - a, f = d - c, g = d + c, h = b + a, one a thread;
//   round 3: thread r computes output coordinate r (e f, g h, f g, e h).
#define AQ_LANES 16
#define AQ_SLOTS 12
#define AQ_STRIDE (AQ_LANES * AQ_SLOTS)
// round 1: u = p[C] + S p.x (+ CC, carried) for threads 0 and 1, p[C] as
// loaded for threads 2 and 3; v the same of q
__device__ __constant__ int8_t AQ_C[4] = {1, 1, 3, 2};
__device__ __constant__ int8_t AQ_S[4] = {-1, 1, 0, 0};
// round 2: slot 4 + r = A + S B (+ CC): e, f, g, h from a, b, c, d (0..3)
__device__ __constant__ int8_t AQ_R2A[4] = {1, 3, 3, 1};
__device__ __constant__ int8_t AQ_R2B[4] = {0, 2, 2, 0};
__device__ __constant__ int8_t AQ_R2S[4] = {-1, -1, 1, 1};
// round 3: e f, g h, f g, e h
__device__ __constant__ int8_t AQ_MA[4] = {4, 6, 5, 4};
__device__ __constant__ int8_t AQ_MB[4] = {5, 7, 6, 7};

__global__ void __launch_bounds__(4 * AQ_LANES)
padd_quad_kernel(const int32_t *__restrict__ p, const int32_t *__restrict__ q,
                 int32_t *__restrict__ out, int64_t n) {
  __shared__ int4 sm[5 * AQ_STRIDE];
  const int r = threadIdx.x & 3, l = threadIdx.x >> 2;
  const int64_t at = (int64_t)blockIdx.x * AQ_LANES + l;
  const int64_t lane = at < n ? at : n - 1;  // the tail's groups redo lane n - 1, unstored
  int4 *const el = sm + l * AQ_SLOTS;
  const int64_t cs = (int64_t)FE_NL * n;
  {
    fe_t u = fe_load(p + AQ_C[r] * cs, n, lane), v = fe_load(q + AQ_C[r] * cs, n, lane);
    if (r < 2) {
      const fe_t px = fe_load(p, n, lane), qx = fe_load(q, n, lane);
      const int32_t sg = AQ_S[r], cc = sg < 0 ? -1 : 0;
#pragma unroll
      for (int i = 0; i < FE_NL; i++) {
        u.v[i] += sg * px.v[i] + (PQ_CC[i] & cc);
        v.v[i] += sg * qx.v[i] + (PQ_CC[i] & cc);
      }
      fe_carry(u);
      fe_carry(v);
    }
    fe_t x = fe_mul(u, v);
    if (r == 2) x = fe_mul_const(x, FE_D2);
    if (r == 3) x = fe_mul_small(x, 2);
    pq_put<AQ_STRIDE>(el, r, x);
  }
  __syncwarp();
  {
    const fe_t a = pq_get<AQ_STRIDE>(el, AQ_R2A[r]), b = pq_get<AQ_STRIDE>(el, AQ_R2B[r]);
    const int32_t sg = AQ_R2S[r], cc = sg < 0 ? -1 : 0;
    fe_t x;
#pragma unroll
    for (int i = 0; i < FE_NL; i++) x.v[i] = a.v[i] + sg * b.v[i] + (PQ_CC[i] & cc);
    fe_carry(x);
    pq_put<AQ_STRIDE>(el, 4 + r, x);
  }
  __syncwarp();
  const fe_t o = fe_mul(pq_get<AQ_STRIDE>(el, AQ_MA[r]), pq_get<AQ_STRIDE>(el, AQ_MB[r]));
  if (at < n) fe_store(out + r * cs, n, lane, o);
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

// x -> x^(2^k) (pallas_fe._fsq_n_kernel), one thread a lane, in 8 x 32-bit
// words (fe25519_w32.cuh); writes canonical limbs.
__global__ void __launch_bounds__(PK_THREADS)
fsquare_chain_kernel(const int32_t *__restrict__ x, int32_t *__restrict__ out, int64_t n,
                     int k) {
  const int64_t lane = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n) return;
  int32_t limb[FE_NL];
#pragma unroll
  for (int i = 0; i < FE_NL; i++) limb[i] = __ldg(x + (int64_t)i * n + lane);
  uint32_t w[8];
  w32_pack(limb, w);
#pragma unroll 2
  for (int it = 0; it < k; it++) w32_square(w);
  w32_freeze(w);
  w32_unpack(w, limb);
#pragma unroll
  for (int i = 0; i < FE_NL; i++) out[(int64_t)i * n + lane] = limb[i];
}

static inline unsigned pk_blocks(int64_t n) {
  return (unsigned)((n + PK_THREADS - 1) / PK_THREADS);
}

// C interface (ctypes): launch on `stream`, return cudaGetLastError().
extern "C" int tm_padd(const int32_t *p, const int32_t *q, int32_t *out, int64_t n,
                       void *stream) {
  padd_quad_kernel<<<(unsigned)((n + AQ_LANES - 1) / AQ_LANES), 4 * AQ_LANES, 0,
                     (cudaStream_t)stream>>>(p, q, out, n);
  return (int)cudaGetLastError();
}

extern "C" int tm_padd_lanes(const int32_t *p, const int32_t *q, int32_t *out, int64_t n,
                             void *stream) {
  padd_lanes_kernel<<<(unsigned)((n + PL_WARPS - 1) / PL_WARPS), 32 * PL_WARPS, 0,
                      (cudaStream_t)stream>>>(p, q, out, n);
  return (int)cudaGetLastError();
}

extern "C" int tm_pdbl(const int32_t *p, int32_t *out, int64_t n, int times, void *stream) {
  pdbl_quad_kernel<<<(unsigned)((n + PQ_LANES - 1) / PQ_LANES), PQ_THREADS, 0,
                     (cudaStream_t)stream>>>(p, out, n, times);
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
