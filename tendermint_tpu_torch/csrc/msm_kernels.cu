// Fused Pippenger MSM stages for Hopper (sm_90a): uptree, fenwick_reduce,
// bucket_fold.
//
// Replaces the Pallas TPU kernels of tendermint_tpu/ops/pallas_msm.py:
//   tm_uptree         <- _uptree_block / _uptree_call  (public pallas_msm.uptree)
//   tm_fenwick_reduce <- _fenwick_kernel / _fenwick_call (pallas_msm.fenwick_reduce)
//   tm_bucket_fold    <- _bucket_block / _bucket_call  (pallas_msm.bucket_fold)
//
// Layout: a point batch is int32 (4, 20, n), coordinate c, limb i, lane j at
// (c * 20 + i) * n + j, which is the reference's packed (4, 20, n/128, 128)
// reshaped. Every point add is the unified a=-1 extended add of
// point_kernels.cu (add-2008-hwcd-3), in the same operation order, so every
// limb a kernel writes is bit-identical to its plain torch version.
//
// The TPU kernels keep a whole 2048-lane chunk tree, or the accumulator of a
// sequential grid axis, in VMEM. On the H100 a 2048-lane chunk of points is
// 655 KB, three times an SM's shared memory, and nothing carries across
// blocks, so each kernel is written for what it computes:
//
// - uptree: one block per chunk tree (320 at a 10k commit, 384 per planner
//   chunk). Level l position q < width = ch >> l gets prev[q] + prev[q+width],
//   where prev is the bit-reversed level-0 input for l = 1 and level l-1
//   otherwise; this one rule is both the row folds and the lane folds of
//   _uptree_block. Position q of level l goes to chunk-local offset
//   row_off[l] * 128 + q (msm_geometry.chunk_geometry). The output tensor is
//   the level store: level l-1 is read back from it after __syncthreads(),
//   with L2-only loads (__ldcg), since the block wrote it in this launch.
//   Positions the reference fills with roll-fold garbage or zero pad are
//   never indexed and are left unwritten here.
//   Bound: operations. At 10k, 655,040 adds of 3,620 multiply-adds each
//   (2.37 G) against ~210 MB read and ~210 MB written: ~0.14 ms of IMAD
//   issue. The upper levels leave most of a block's threads idle (level 5 of
//   a 2048-lane chunk has 64 nodes for 128 threads), the known cost of this
//   simple form.
// - fenwick_reduce: one thread per (bucket, window) lane (8,192). It reads
//   its Kf node indices and sums acc = node[0], acc += node[k] for k = 1..Kf-1
//   in registers, identity slots included, in the reference's order. The
//   gather is part of the kernel: a global index selects one of the storage
//   map's three segments (level-0 lanes, chunk trees, top tree with its
//   identity lane), so the (buckets x windows x Kf) node tensor is never
//   materialised. Output is v-major (lane v * T + t).
//   Bound: operations (8,192 x 15 adds, 0.44 G multiply-adds) on 42 MB of
//   gathered nodes; each node's limbs are 80 scattered 4-byte reads, so
//   sector traffic, not the add, is what later work should cut.
// - bucket_fold: one block per window, 128 threads. Thread v forms
//   x[v] + x[v+128] from device memory with bucket 255 masked to the identity
//   (_bucket_block's mask), keeps it in shared memory (128 points = 40 KB),
//   and the block halves in place down to one point: the pairing v + h for
//   h = 128, 64, ..., 1 that the reference's row and lane folds make over the
//   v-major layout. It also copies the unmasked P_255 of its window.
//   Bound: a chain of 8 dependent adds on at most 128 lanes per window:
//   latency, far from both the byte and the operation bound.
//
// Later work (not done here): fuse the perm gather of level 0 into uptree so
// the 210 MB level-0 copy disappears; keep a chunk's upper levels (256 nodes
// and fewer, 80 KB) in shared memory; store nodes row-major (80 contiguous
// words) so fenwick_reduce reads each node in 10 sectors instead of 80.
#include <cuda_runtime.h>
#include <stdint.h>

#include "fe25519.cuh"

#define UT_THREADS 128
#define FW_THREADS 64
#define BF_THREADS 128  // NB / 2 buckets paired per window

struct pt_t {
  fe_t c[4];
};

// Limb rows of lane `lane`, loaded through L2 only: coherent with stores this
// block made earlier in the same launch.
__device__ __forceinline__ fe_t fe_load_cg(const int32_t *base, int64_t n, int64_t lane) {
  fe_t r;
#pragma unroll
  for (int i = 0; i < FE_NL; i++) r.v[i] = __ldcg(base + (int64_t)i * n + lane);
  return r;
}

// Coordinate accessors: pt_add asks for one coordinate at a time, just before
// its product, so at most two operand coordinates are live with the
// accumulators (the register schedule of point_kernels.cu's padd_kernel).
struct MemPt {  // read-only input
  const int32_t *base;
  int64_t n, lane;
  __device__ __forceinline__ fe_t operator()(int c) const {
    return fe_load(base + (int64_t)c * FE_NL * n, n, lane);
  }
};

struct StorePt {  // the level store this block is writing
  const int32_t *base;
  int64_t n, lane;
  __device__ __forceinline__ fe_t operator()(int c) const {
    return fe_load_cg(base + (int64_t)c * FE_NL * n, n, lane);
  }
};

struct RegPt {
  const pt_t &p;
  __device__ __forceinline__ fe_t operator()(int c) const { return p.c[c]; }
};

struct SharedPt {  // sh[(c * 20 + i) * BF_THREADS + v]
  const int32_t *sh;
  int v;
  __device__ __forceinline__ fe_t operator()(int c) const {
    fe_t r;
#pragma unroll
    for (int i = 0; i < FE_NL; i++) r.v[i] = sh[(c * FE_NL + i) * BF_THREADS + v];
    return r;
  }
};

struct MaskedPt {  // a prefix point, or the identity (0, 1, 1, 0) when masked
  MemPt m;
  bool ident;
  __device__ __forceinline__ fe_t operator()(int c) const {
    if (!ident) return m(c);
    fe_t r;
#pragma unroll
    for (int i = 0; i < FE_NL; i++) r.v[i] = 0;
    r.v[0] = (c == 1 || c == 2) ? 1 : 0;
    return r;
  }
};

// Unified a=-1 extended add, add-2008-hwcd-3 (point_kernels.cu padd_kernel).
template <class P, class Q>
__device__ __forceinline__ pt_t pt_add(const P &p, const Q &q) {
  fe_t a, b, c, d;
  {
    const fe_t px = p(0), py = p(1), qx = q(0), qy = q(1);
    a = fe_mul(fe_sub(py, px), fe_sub(qy, qx));
    b = fe_mul(fe_add(py, px), fe_add(qy, qx));
  }
  {
    const fe_t pt = p(3), qt = q(3);
    c = fe_mul_const(fe_mul(pt, qt), FE_D2);
  }
  {
    const fe_t pz = p(2), qz = q(2);
    d = fe_mul_small(fe_mul(pz, qz), 2);
  }
  const fe_t e = fe_sub(b, a);
  const fe_t f = fe_sub(d, c);
  const fe_t g = fe_add(d, c);
  const fe_t h = fe_add(b, a);
  pt_t r;
  r.c[0] = fe_mul(e, f);
  r.c[1] = fe_mul(g, h);
  r.c[2] = fe_mul(f, g);
  r.c[3] = fe_mul(e, h);
  return r;
}

__device__ __forceinline__ void pt_store(int32_t *base, int64_t n, int64_t lane, const pt_t &p) {
#pragma unroll
  for (int c = 0; c < 4; c++) fe_store(base + (int64_t)c * FE_NL * n, n, lane, p.c[c]);
}

// in (4, 20, nchunks * ch): bit-reversed level-0 lanes, chunk-major.
// out (4, 20, nchunks * rows_out * 128): levels 1..lc of each chunk.
__global__ void __launch_bounds__(UT_THREADS)
uptree_kernel(const int32_t *__restrict__ in, int32_t *out, int ch, int rows_out,
              int64_t n_in, int64_t n_out) {
  const int64_t in0 = (int64_t)blockIdx.x * ch;
  const int64_t out0 = (int64_t)blockIdx.x * rows_out * 128;
  int width = ch >> 1;
  int row = 0;  // row_off of the level being written
  for (int q = threadIdx.x; q < width; q += blockDim.x) {
    const pt_t s = pt_add(MemPt{in, n_in, in0 + q}, MemPt{in, n_in, in0 + q + width});
    pt_store(out, n_out, out0 + q, s);
  }
  while (width > 1) {
    const int prev = row;
    row += width >= 128 ? width / 128 : 1;
    width >>= 1;
    __syncthreads();  // level l-1 complete and visible to the block
    const int64_t src = out0 + (int64_t)prev * 128, dst = out0 + (int64_t)row * 128;
    for (int q = threadIdx.x; q < width; q += blockDim.x) {
      const pt_t s = pt_add(StorePt{out, n_out, src + q}, StorePt{out, n_out, src + q + width});
      pt_store(out, n_out, dst + q, s);
    }
  }
}

// Three segments of one global node index space (msm_torch's storage map):
// [0, n0) level-0 lanes, [n0, n0 + n1) chunk trees, then the top tree.
__global__ void __launch_bounds__(FW_THREADS)
fenwick_kernel(const int32_t *__restrict__ lvl0, int64_t n0, const int32_t *__restrict__ ctree,
               int64_t n1, const int32_t *__restrict__ top, int64_t n2,
               const int32_t *__restrict__ idx, int kf, int32_t *__restrict__ out, int64_t m) {
  const int64_t lane = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= m) return;
  auto node = [&](int k) {
    int64_t g = __ldg(idx + lane * kf + k);
    if (g < n0) return MemPt{lvl0, n0, g};
    g -= n0;
    if (g < n1) return MemPt{ctree, n1, g};
    return MemPt{top, n2, g - n1};
  };
  pt_t acc;
  {
    const MemPt p0 = node(0);
#pragma unroll
    for (int c = 0; c < 4; c++) acc.c[c] = p0(c);
  }
  for (int k = 1; k < kf; k++) acc = pt_add(RegPt{acc}, node(k));
  pt_store(out, m, lane, acc);
}

// prefix (4, 20, 256 * T) v-major; s_out, p255_out (4, 20, T).
__global__ void __launch_bounds__(BF_THREADS)
bucket_fold_kernel(const int32_t *__restrict__ prefix, int t_windows, int32_t *__restrict__ s_out,
                   int32_t *__restrict__ p255_out) {
  __shared__ int32_t sh[4 * FE_NL * BF_THREADS];
  const int t = blockIdx.x, v = threadIdx.x;
  const int64_t n = (int64_t)2 * BF_THREADS * t_windows;
  {
    const MemPt lo{prefix, n, (int64_t)v * t_windows + t};
    const MaskedPt hi{MemPt{prefix, n, (int64_t)(v + BF_THREADS) * t_windows + t},
                      v + BF_THREADS == 2 * BF_THREADS - 1};
    const pt_t s = pt_add(lo, hi);
#pragma unroll
    for (int c = 0; c < 4; c++)
#pragma unroll
      for (int i = 0; i < FE_NL; i++) sh[(c * FE_NL + i) * BF_THREADS + v] = s.c[c].v[i];
  }
  for (int h = BF_THREADS / 2; h >= 1; h >>= 1) {
    __syncthreads();
    if (v < h) {  // writes [0, h); other threads read only their own slot and [h, 2h)
      const pt_t s = pt_add(SharedPt{sh, v}, SharedPt{sh, v + h});
#pragma unroll
      for (int c = 0; c < 4; c++)
#pragma unroll
        for (int i = 0; i < FE_NL; i++) sh[(c * FE_NL + i) * BF_THREADS + v] = s.c[c].v[i];
    }
  }
  __syncthreads();
  if (v < 4 * FE_NL) {  // one limb row per thread: sum and unmasked P_255
    s_out[(int64_t)v * t_windows + t] = sh[v * BF_THREADS];
    p255_out[(int64_t)v * t_windows + t] =
        prefix[(int64_t)v * n + (int64_t)(2 * BF_THREADS - 1) * t_windows + t];
  }
}

// C interface (ctypes): launch on `stream`, return cudaGetLastError().
extern "C" int tm_uptree(const int32_t *in, int32_t *out, int64_t nchunks, int ch, int rows_out,
                         void *stream) {
  uptree_kernel<<<(unsigned)nchunks, UT_THREADS, 0, (cudaStream_t)stream>>>(
      in, out, ch, rows_out, nchunks * ch, nchunks * rows_out * 128);
  return (int)cudaGetLastError();
}

extern "C" int tm_fenwick_reduce(const int32_t *lvl0, int64_t n0, const int32_t *ctree, int64_t n1,
                                 const int32_t *top, int64_t n2, const int32_t *idx, int kf,
                                 int32_t *out, int64_t m, void *stream) {
  const unsigned blocks = (unsigned)((m + FW_THREADS - 1) / FW_THREADS);
  fenwick_kernel<<<blocks, FW_THREADS, 0, (cudaStream_t)stream>>>(lvl0, n0, ctree, n1, top, n2,
                                                                  idx, kf, out, m);
  return (int)cudaGetLastError();
}

extern "C" int tm_bucket_fold(const int32_t *prefix, int t_windows, int32_t *s_out,
                              int32_t *p255_out, void *stream) {
  bucket_fold_kernel<<<(unsigned)t_windows, BF_THREADS, 0, (cudaStream_t)stream>>>(
      prefix, t_windows, s_out, p255_out);
  return (int)cudaGetLastError();
}
