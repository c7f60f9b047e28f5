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
// - uptree: the level-0 gather, in-chunk bit reversal and all chunk-tree
//   levels in one launch. Node rule: level l position q < width = ch >> l
//   gets prev[q] + prev[q + width], prev being level l-1; position q of
//   level l goes to chunk-local offset row_off[l] * 128 + q
//   (msm_geometry.chunk_geometry). Level 0 position p holds sorted lane
//   rev(p) of the chunk, read through the natural permutation from a
//   row-major (N, 80) copy of the point table (320 contiguous bytes per
//   point; the table is 6.5 MB at a 10k commit and stays in L2), and is
//   written to lvl0 once.
//   Bound: operations. At 10k, 655,040 adds of 3,620 multiply-adds each
//   (2.37 G, ~0.142 ms at the IMAD rate) against ~420 MB written (lvl0 and
//   the chunk trees, ~0.125 ms). Design:
//   * Four warps per 32 adds: warp w computes a, b, c or d, then e, f, g
//     or h, then output coordinate w (shared memory between the steps), so
//     a thread holds two operands and one accumulator, not two points:
//     128 registers give 4 blocks, 16 warps, an SM (168 and 3 warps a
//     scheduler before). Every product of the kernel runs through one
//     fe_mul in a loop, and every add through one block_add call with a
//     runtime operand descriptor, so the code is one copy of each.
//   * Wide levels across the card: a work item is 32 level-2 nodes (3 adds
//     of 32 from 128 leaves, 75% of the tree; 5,120 items at 10k) with no
//     barrier across blocks; persistent blocks, as many as fit, take items
//     from an atomic queue, so no partial last wave idles most SMs.
//   * Upper levels climb: a per-group arrival counter after __threadfence
//     (the threadFenceReduction pattern) lets the second child's block
//     compute each 32-node group of levels 3.., so a chunk's upper levels
//     run on several blocks, and only the levels narrower than 32 (5 adds)
//     run in one block. A level store in shared memory would cost every
//     block 80 KB and cap the SM at 2 blocks.
//   Positions that hold no node are never indexed and stay unwritten.
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
// Later work (not done here): store nodes row-major (80 contiguous words)
// so fenwick_reduce reads each node in 10 sectors instead of 80.
#include <cuda_runtime.h>
#include <stdint.h>

#include "fe25519.cuh"

#define UT_THREADS 128
#define UT_MIN_BLOCKS 4  // up to 128 registers a thread: 4 blocks (16 warps) an SM
#define UT_MAX_DEVICES 64

// UT_PROBE_NO_BARRIER is set only by tools/uptree_probe.py (python3 -m
// tendermint_tpu_torch.tools.uptree_probe): block_add then
// runs without its three barriers, so its warps never wait for each other.
// Its nodes are wrong (a warp reads shared slots before they are written);
// the probe times it beside the real kernel to read what the barriers cost.
#ifdef UT_PROBE_NO_BARRIER
#define UT_BARRIER() ((void)0)
#else
#define UT_BARRIER() __syncthreads()
#endif
#define FW_THREADS 64
#define BF_THREADS 128  // NB / 2 buckets paired per window

struct pt_t {
  fe_t c[4];
};

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

// One operand point of a block add: coordinate c, limb i at
// base[c * cs + i * ls]. Leaves are rows of the (N, 80) table, read through
// the read-only path and, where `copy` is set, stored to level 0 as they
// are read (copy[c * ccs + i * cls]); nodes written earlier in this launch
// are read with volatile loads, so from memory after the stores that made
// them. A runtime descriptor, not a type: every add of the kernel is one
// instance of the same code.
struct Opnd {
  const int32_t *base;
  int64_t cs, ls;
  int32_t *copy;
  int64_t ccs, cls;
  bool written;
  __device__ __forceinline__ fe_t get(int c) const {
    fe_t r;
    if (written) {
      const volatile int32_t *p = base + c * cs;
#pragma unroll
      for (int i = 0; i < FE_NL; i++) r.v[i] = p[i * ls];
    } else {
      const int32_t *p = base + c * cs;
#pragma unroll
      for (int i = 0; i < FE_NL; i++) r.v[i] = __ldg(p + i * ls);
    }
    if (copy != nullptr) {
#pragma unroll
      for (int i = 0; i < FE_NL; i++) copy[c * ccs + i * cls] = r.v[i];
    }
    return r;
  }
};

__device__ __forceinline__ Opnd node_opnd(const int32_t *out, int64_t n_out, int64_t pos) {
  return Opnd{out + pos, (int64_t)FE_NL * n_out, n_out, nullptr, 0, 0, true};
}

// sh[(slot * 20 + limb) * 32 + lane]: slots 0-3 hold a, b, c, d, slots 4-7
// e, f, g, h of the block's 32 adds.
__device__ __forceinline__ void sh_put(int32_t *sh, int slot, int lane, const fe_t &x) {
#pragma unroll
  for (int i = 0; i < FE_NL; i++) sh[(slot * FE_NL + i) * 32 + lane] = x.v[i];
}

__device__ __forceinline__ fe_t sh_get(const int32_t *sh, int slot, int lane) {
  fe_t r;
#pragma unroll
  for (int i = 0; i < FE_NL; i++) r.v[i] = sh[(slot * FE_NL + i) * 32 + lane];
  return r;
}

// 32 unified adds p + q (add-2008-hwcd-3, pt_add's operations) by the
// block's 4 warps: lane l of every warp works on add l (l < nact); warp w
// computes a, b, c or d (w = 0..3), then e, f, g or h, then output
// coordinate w, which it stores at `dst + l` of the limb-major batch `out`.
// The warp's role is uniform, so no warp diverges; a thread holds two
// operands and one accumulator. All products of the add run through one
// fe_mul in a loop, so the kernel holds one copy of the product code.
__device__ __forceinline__ void block_add(const Opnd &p, const Opnd &q, int nact, int32_t *sh,
                                          int32_t *out, int64_t n_out, int64_t dst) {
  const int lane = threadIdx.x & 31, role = threadIdx.x >> 5;
  const bool act = lane < nact;
  fe_t a, b, m;
  if (act) {
    if (role < 2) {  // (py -/+ px), (qy -/+ qx)
      const fe_t py = p.get(1), px = p.get(0);
      a = role == 0 ? fe_sub(py, px) : fe_add(py, px);
      const fe_t qy = q.get(1), qx = q.get(0);
      b = role == 0 ? fe_sub(qy, qx) : fe_add(qy, qx);
    } else {  // pt qt, pz qz
      a = p.get(role == 2 ? 3 : 2);
      b = q.get(role == 2 ? 3 : 2);
    }
  }
#pragma unroll 1
  for (int step = 0; step < 3; step++) {
    if (act && (step != 1 || role == 2)) m = fe_mul(a, b);
    if (step == 0) {
      if (act && role == 2) {  // c = (pt qt) 2d
        a = m;
#pragma unroll
        for (int i = 0; i < FE_NL; i++) b.v[i] = FE_D2[i];
      } else if (act && role == 3) {  // d = 2 (pz qz)
        m = fe_mul_small(m, 2);
      }
    } else if (step == 1) {
      if (act) sh_put(sh, role, lane, m);
      UT_BARRIER();
      if (act) {  // e = b - a, f = d - c, g = d + c, h = b + a
        const int su = role == 0 || role == 3 ? 1 : 3;
        const fe_t u = sh_get(sh, su, lane), v = sh_get(sh, su - 1, lane);
        sh_put(sh, 4 + role, lane, role < 2 ? fe_sub(u, v) : fe_add(u, v));
      }
      UT_BARRIER();
      if (act) {  // x = e f, y = g h, z = f g, t = e h
        a = sh_get(sh, role == 1 ? 6 : role == 2 ? 5 : 4, lane);
        b = sh_get(sh, role == 0 ? 5 : role == 2 ? 6 : 7, lane);
      }
    } else if (act) {
      fe_store(out + (int64_t)role * FE_NL * n_out, n_out, dst + lane, m);
    }
  }
  UT_BARRIER();  // the outputs are visible to the block; sh is free again
}

// rev_lc(x): the low lc bits of x reversed.
__device__ __forceinline__ int brev_bits(int x, int lc) {
  return (int)(__brev((unsigned)x) >> (32 - lc));
}

// rows (N, 80): the decompressed point table, one point per row.
// perm (T, N): each window's lanes in natural sorted order.
// lvl0 (4, 20, T * N): out, sorted lane j of a chunk at position rev(j).
// out (4, 20, nchunks * rows_out * 128): levels 1..lc of each chunk.
// counters (nchunks * ch / 128 + 1): zero on entry; per chunk, one arrival
// count per 32-node group of each level >= 3 that is 32 nodes or wider;
// last, the work queue's head.
// A group is 32 consecutive positions of one level; a level-l group g
// (width w = ch >> l >= 32) needs groups g and g + w / 32 of level l-1.
// Work item i is level-2 group i % ipc of chunk i / ipc. Its add l folds
// the level-0 positions q + k ch/4, k = 0..3 (q = 32 g + l: sorted lanes
// 4m, 4m+2, 4m+1, 4m+3 with m = rev(q) / 4), into level-1 nodes q and
// q + ch/4 and those into level-2 node q, writing the leaves to lvl0 as it
// reads them. Then the block climbs: the second of a group's two children to
// arrive computes the group, up to the chunk's 32-node level, whose block
// adds the narrower levels one after another. Blocks are persistent: each
// takes the next item from the queue. Every add is one block_add call in
// the job loop below.
__global__ void __launch_bounds__(UT_THREADS, UT_MIN_BLOCKS)
uptree_kernel(const int32_t *__restrict__ rows, const int32_t *__restrict__ perm, int ch,
              int lc, int rows_out, int ipc, int items, int32_t *lvl0, int32_t *out,
              int *counters, int64_t n0, int64_t n_out) {
  __shared__ int32_t sh[8 * FE_NL * 32];
  __shared__ int item, last;
  const int lane = threadIdx.x & 31, role = threadIdx.x >> 5;
  const int quarter = ch >> 2;
  int *head = counters + (int64_t)(items / ipc) * (ch >> 7);
  for (;;) {
    if (threadIdx.x == 0) item = atomicAdd(head, 1);
    __syncthreads();
    const int it = item;
    if (it >= items) return;
    const int chunk = it / ipc;
    const int q0 = (it % ipc) * 32, q = q0 + lane;
    const int64_t p0 = (int64_t)chunk * ch;  // chunk start in lvl0 and in perm
    const int64_t out0 = (int64_t)chunk * rows_out * 128;
    const int j0 = brev_bits(q, lc);  // a multiple of 4: q < ch / 4
    const int4 lanes = __ldg(reinterpret_cast<const int4 *>(perm + p0 + j0));
    // position q + k ch/4 holds sorted lane j0 + rev_2(k): leaf k is row
    // lanes.{x, z, y, w}[k]; warp 0 copies x and y of each leaf to level 0,
    // warp 2 t, warp 3 z (the coordinates each reads)
    auto leaf = [&](int lane_id, int k) {
      return Opnd{rows + (int64_t)lane_id * 4 * FE_NL, FE_NL, 1,
                  role == 1 ? nullptr : lvl0 + p0 + q + k * quarter, (int64_t)FE_NL * n0, n0,
                  false};
    };
    // jobs 0-2: level-1 nodes q and q + ch/4, level-2 node q; job 3: a
    // 32-node group of a level >= 3; job 4: a level narrower than 32
    int *cnt = counters + (int64_t)chunk * (ch >> 7);
    int job = 0, g = q0 / 32, width = quarter, row = ch >> 8, prev = 0, coff = 0;
    for (;;) {
      Opnd pa, pb;
      int nact = 32;
      int64_t dst;
      if (job == 0) {
        pa = leaf(lanes.x, 0), pb = leaf(lanes.y, 2), dst = out0 + q0;
      } else if (job == 1) {
        pa = leaf(lanes.z, 1), pb = leaf(lanes.w, 3), dst = out0 + q0 + quarter;
      } else if (job == 2) {  // row_off[2] = ch / 256
        pa = node_opnd(out, n_out, out0 + q), pb = node_opnd(out, n_out, out0 + q + quarter);
        dst = out0 + (ch >> 8) * 128 + q0;
      } else {
        const int64_t src = out0 + (int64_t)prev * 128 + (job == 3 ? g * 32 : 0);
        pa = node_opnd(out, n_out, src + lane), pb = node_opnd(out, n_out, src + lane + width);
        nact = job == 3 ? 32 : width;
        dst = out0 + (int64_t)row * 128 + (job == 3 ? g * 32 : 0);
      }
      block_add(pa, pb, nact, sh, out, n_out, dst);
      if (job < 2) {
        job++;
        continue;
      }
      if (width <= 32) {  // the chunk's 32-node level or narrower: this block's own
        if (width == 1) break;
        prev = row, row += 1, width >>= 1, job = 4;
        continue;
      }
      const int half = width >> 1, pg = g % (half >> 5);
      __threadfence();  // this group visible to the block that computes its parent
      __syncthreads();
      if (threadIdx.x == 0) last = atomicAdd(cnt + coff + pg, 1) == 1;
      __syncthreads();
      if (!last) break;
      __threadfence();
      prev = row, row += width >= 128 ? width / 128 : 1;
      coff += half >> 5, width = half, g = pg, job = 3;
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
extern "C" int tm_uptree(const int32_t *rows, const int32_t *perm, int64_t n_lanes,
                         int64_t t_windows, int ch, int rows_out, int32_t *lvl0, int32_t *out,
                         int *counters, void *stream) {
  const int64_t nchunks = t_windows * n_lanes / ch;
  const int ipc = (ch / 4) / 32;  // items per chunk: 32 level-2 nodes each
  const int lc = 31 - __builtin_clz((unsigned)ch);
  const int items = (int)(nchunks * ipc);
  // resident blocks the card holds, read once per device (a race writes the same value)
  static int resident[UT_MAX_DEVICES];
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 0 || dev >= UT_MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  if (resident[dev] == 0) {
    int sms = 0, per_sm = 0;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, uptree_kernel, UT_THREADS, 0);
    resident[dev] = sms * per_sm;
  }
  const int blocks = items < resident[dev] ? items : resident[dev];
  if (blocks < 1) return (int)cudaErrorInvalidConfiguration;
  uptree_kernel<<<(unsigned)blocks, UT_THREADS, 0, (cudaStream_t)stream>>>(
      rows, perm, ch, lc, rows_out, ipc, items, lvl0, out, counters, t_windows * n_lanes,
      nchunks * rows_out * 128);
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
