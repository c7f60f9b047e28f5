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
// - fenwick_reduce: per (bucket, window) lane, acc = node[0], acc += node[k]
//   for k = 1..Kf-1, identity slots included, in the reference's order. A
//   global index selects one of the storage map's three segments (level-0
//   lanes, chunk trees, top tree with its identity lane), so the (buckets x
//   windows x Kf) node tensor is never materialised. Output is v-major (lane
//   v * T + t). Work: 8,192 x 15 adds at 10k (0.44 G multiply-adds); bytes:
//   each gathered node is 80 limb rows of the (4, 20, n) storage, 80
//   scattered 4-byte reads. Design:
//   * A block of 4 warps runs 32 lanes' adds with block_add (uptree's add,
//     split over the warps), the 32 sums in shared memory: at 8,192 lanes
//     256 blocks, 1,024 warps, ~2 a sub-partition (one thread a lane left
//     272 of the 528 sub-partitions idle, and no warp to hide a chain's
//     latency).
//   * A block's lanes are neighbouring buckets of one window: their prefix
//     ends are neighbours, so they share the Fenwick nodes of the high bits,
//     and a warp's gather of one limb row hits few sectors. The output store
//     is scattered (stride T): 320 B a lane, once.
//   * The gather is off the add chain: node k+1 of the block's lanes is
//     copied into the second of two shared buffers with cp.async
//     (__pipeline_memcpy_async) while add k runs. The node indices are read
//     once per block.
//   Measured by chip_smoke.py on an H100 SXM (700 W): ~0.15 ms at 8,192
//   lanes, Kf = 16 (one thread a lane: 0.33 ms), 128 registers, 44 B spill;
//   the gather touches ~1.4 M sectors (45 MB), so operations bound it.
// - bucket_fold: per window, the sum of 255 prefix points in the reference's
//   pairing tree (v + 128, then v + 64, ..., v + 1, bucket 255 masked to the
//   identity) and the unmasked P_255. Bound: a chain of 8 dependent levels,
//   255 adds a window (0.92 M multiply-adds; the bytes are 2.6 MB at T = 32):
//   latency, far from both the byte and the operation bound. One thread per
//   add made the chain 8 one-thread adds (~0.17 ms). Design: every add is
//   one warp's w_padd (fe25519_warp.cuh), ~1/8 of a one-thread add's
//   latency, but a warp add issues several times a thread add's
//   instructions (20 of 32 lanes work; two shared loads per multiply-add),
//   so 128 warp adds on one SM are bound by its issue rate, not by latency.
//   So a window runs on BF_BLOCKS = 4 blocks of 32 warps (T = 32 windows
//   take 128 of the 132 SMs), one add per warp at every level: each block
//   computes 16 of the 64 level-2 nodes (32 level-1 adds, then 16); two of
//   the four compute the 32 level-3 nodes, 16 each, and one computes levels
//   4-8. Nodes pass between a window's blocks through device memory and an
//   arrival counter: 8 levels of warp adds and two hand-offs in a row. A thread block
//   cluster (distributed shared memory) would save the round trips, but
//   clusters of 4 one-SM blocks do not all fit on the card at once at T =
//   32, and the rest ran in a second wave.
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "fe25519.cuh"
#include "fe25519_warp.cuh"

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
#define FW_THREADS 128  // 4 warps per 32 lanes
#define FW_PT (4 * FE_NL * 32)  // words of 32 points in shared memory

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

// Where block_add stores output coordinate `role` of add `lane`: lane
// dst + lane of the limb-major batch `out` (n_out lanes).
struct RowsOut {
  int32_t *out;
  int64_t n_out, dst;
  __device__ __forceinline__ void put(int role, int lane, const fe_t &m) const {
    fe_store(out + (int64_t)role * FE_NL * n_out, n_out, dst + lane, m);
  }
};

// 32 unified adds p + q (add-2008-hwcd-3, padd_kernel's operations) by the
// block's 4 warps: lane l of every warp works on add l (l < nact); warp w
// computes a, b, c or d (w = 0..3), then e, f, g or h, then output
// coordinate w, which it hands to `o.put`. Operands are read (p.get, q.get)
// before the first barrier, outputs stored after the second, so an output
// may overwrite an operand. The warp's role is uniform, so no warp diverges;
// a thread holds two operands and one accumulator. All products of the add
// run through one fe_mul in a loop, so a kernel holds one copy of the
// product code for each operand and output type it uses.
template <class P, class Q, class Out>
__device__ __forceinline__ void block_add(const P &p, const Q &q, int nact, int32_t *sh,
                                          const Out &o) {
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
      o.put(role, lane, m);
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
      block_add(pa, pb, nact, sh, RowsOut{out, n_out, dst});
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

// 32 points in shared memory, point l's coordinate c, limb i at
// base[(c * 20 + i) * 32] (base = buffer + l).
struct ShPt {
  const int32_t *base;
  __device__ __forceinline__ fe_t get(int c) const {
    fe_t r;
#pragma unroll
    for (int i = 0; i < FE_NL; i++) r.v[i] = base[(c * FE_NL + i) * 32];
    return r;
  }
};

// A fenwick add's output: coordinate c, limb i at base[(c * 20 + i) * rs +
// off], the block's sums in shared memory (rs = 32, off = l) or, on the last
// add, the lane's v-major row of the output.
struct FwOut {
  int32_t *base;
  int64_t rs, off;
  __device__ __forceinline__ void put(int role, int, const fe_t &m) const {
#pragma unroll
    for (int i = 0; i < FE_NL; i++) base[((int64_t)role * FE_NL + i) * rs + off] = m.v[i];
  }
};

// Three segments of one global node index space (msm_torch's storage map):
// [0, n0) level-0 lanes, [n0, n0 + n1) chunk trees, then the top tree.
// idx (m, kf), row v * T + t; block b takes buckets 32 (b / T) + 0..31 of
// window b % T. Dynamic shared memory: block_add's 8 slots, the 32 sums,
// two node buffers (node k >= 1 in buffer k & 1), the 32 x kf indices.
__global__ void __launch_bounds__(FW_THREADS, UT_MIN_BLOCKS)
fenwick_kernel(const int32_t *__restrict__ lvl0, int64_t n0, const int32_t *__restrict__ ctree,
               int64_t n1, const int32_t *__restrict__ top, int64_t n2,
               const int32_t *__restrict__ idx, int kf, int32_t *__restrict__ out, int64_t m,
               int t_windows) {
  extern __shared__ int32_t fw_sh[];
  int32_t *sh = fw_sh, *acc = sh + 8 * FE_NL * 32, *buf = acc + FW_PT;
  int *nidx = buf + 2 * FW_PT;
  const int lane = threadIdx.x & 31, role = threadIdx.x >> 5;
  const int t = (int)(blockIdx.x % t_windows);
  const int64_t v0 = (int64_t)(blockIdx.x / t_windows) * 32, nb = m / t_windows;
  const int nact = nb - v0 < 32 ? (int)(nb - v0) : 32;
  for (int e = threadIdx.x; e < 32 * kf; e += FW_THREADS)
    if (e / kf < nact) nidx[e] = __ldg(idx + ((v0 + e / kf) * t_windows + t) * kf + e % kf);
  __syncthreads();
  // node k of the block's lanes into dst, one commit group: warp w copies
  // coordinate w, thread l lane l's 20 limbs
  auto fetch = [&](int k, int32_t *dst) {
    if (lane < nact) {
      int64_t g = nidx[lane * kf + k], ns = n0;
      const int32_t *src = lvl0;
      if (g >= n0) {
        g -= n0;
        src = ctree, ns = n1;
        if (g >= n1) g -= n1, src = top, ns = n2;
      }
      src += (int64_t)role * FE_NL * ns + g;
#pragma unroll
      for (int i = 0; i < FE_NL; i++)
        __pipeline_memcpy_async(dst + (role * FE_NL + i) * 32 + lane, src + (int64_t)i * ns, 4);
    }
    __pipeline_commit();
  };
  const int64_t row = (v0 + lane) * t_windows + t;
  fetch(0, acc);
  if (kf > 1) fetch(1, buf + FW_PT);
  for (int k = 1; k < kf; k++) {
    if (k + 1 < kf) {  // node k+1 into the buffer add k-1 read
      fetch(k + 1, buf + ((k + 1) & 1) * FW_PT);
      __pipeline_wait_prior(1);
    } else {
      __pipeline_wait_prior(0);
    }
    __syncthreads();  // node k (and the sums) visible to every warp
    const FwOut o = k + 1 < kf ? FwOut{acc, 32, lane} : FwOut{out, m, row};
    block_add(ShPt{acc + lane}, ShPt{buf + (k & 1) * FW_PT + lane}, nact, sh, o);
  }
  if (kf == 1) {  // the sum is node 0: each thread stores the limbs it copied
    __pipeline_wait_prior(0);
    if (lane < nact)
#pragma unroll
      for (int i = 0; i < FE_NL; i++)
        out[(int64_t)(role * FE_NL + i) * m + row] = acc[(role * FE_NL + i) * 32 + lane];
  }
}

// bucket_fold: BF_BLOCKS = 4 blocks per window. Block s computes the
// level-2 nodes at positions p in [16 s, 16 s + 16): first the 32 level-1
// sums x[v] + x[v + 128] that they need (v = p and p + 64; x[255] read as the
// identity), into shared slots j (v = 16 s + j) and 16 + j (v = 64 + 16 s +
// j), then slot j += slot 16 + j. Level 3 pairs position p with p + 32, so
// blocks s and s + 2 hand their nodes to whichever of them arrives last
// (bf_handoff), which computes level-3 positions [16 q, 16 q + 16), q = s & 1;
// the last of those two computes levels 4-8: slot j += slot j + h for h =
// 16, ..., 1, and resets the window's counters for the next launch. Each add
// is one warp's w_padd, one add per warp at every level. A warp writes only
// the slot it adds into, which no other warp reads at that level, so a
// level needs one __syncthreads before the next.
#define BF_BLOCKS 4
#define BF_WARPS 32
#define BF_THREADS (32 * BF_WARPS)
#define BF_PT (4 * FE_NL)  // words of one point: coordinate c, limb i at c * 20 + i
#define BF_NODES 96        // a window's handed-over nodes: 64 of level 2, then 32 of level 3

// This lane's limb of the four coordinates of prefix point `col` (lane v T + t).
__device__ __forceinline__ void bf_load(const int32_t *__restrict__ prefix, int64_t n, int64_t col,
                                        int k, int32_t (&x)[4]) {
#pragma unroll
  for (int c = 0; c < 4; c++) x[c] = __ldg(prefix + (int64_t)(c * FE_NL + k) * n + col);
}

// Slot j += slot j + h for the block's h adds, one per warp.
__device__ __forceinline__ void bf_level(int32_t *pts, int h, int32_t *buf) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5, k = lane % FE_NL;
  if (w < h) {
    int32_t x[4], y[4], r[4];
#pragma unroll
    for (int c = 0; c < 4; c++) {
      x[c] = pts[w * BF_PT + c * FE_NL + k];
      y[c] = pts[(w + h) * BF_PT + c * FE_NL + k];
    }
    w_padd(x, y, r, buf);
    if (lane < FE_NL) {
#pragma unroll
      for (int c = 0; c < 4; c++) pts[w * BF_PT + c * FE_NL + k] = r[c];
    }
  }
  __syncthreads();
}

// Write slots 0..15 to `dst` and count the block in `*counter`; true in the
// second block to arrive, which then finds both blocks' nodes in device
// memory (the threadFenceReduction pattern: __threadfence before the count).
__device__ __forceinline__ bool bf_handoff(const int32_t *pts, int32_t *dst, int *counter,
                                           int *last) {
  for (int e = threadIdx.x; e < 16 * BF_PT; e += BF_THREADS) dst[e] = pts[e];
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) *last = atomicAdd(counter, 1) == 1;
  __syncthreads();
  if (*last) __threadfence();
  return *last;
}

// Slots 0..31 from nodes a (16 of them) and b (16), written in this launch by
// other blocks: volatile reads, not through L1.
__device__ __forceinline__ void bf_gather(int32_t *pts, const volatile int32_t *a,
                                          const volatile int32_t *b) {
  for (int e = threadIdx.x; e < 16 * BF_PT; e += BF_THREADS) {
    pts[e] = a[e];
    pts[16 * BF_PT + e] = b[e];
  }
  __syncthreads();
}

static size_t bucket_fold_smem_bytes() {
  return (size_t)(32 * BF_PT + BF_WARPS * WP_WORDS) * sizeof(int32_t);
}

// prefix (4, 20, 256 * T) v-major; nodes (T, 96, 80) scratch; arrived (3 T)
// zero on entry; s_out, p255_out (4, 20, T).
__global__ void __launch_bounds__(BF_THREADS, 1)
bucket_fold_kernel(const int32_t *__restrict__ prefix, int t_windows, int32_t *nodes, int *arrived,
                   int32_t *__restrict__ s_out, int32_t *__restrict__ p255_out) {
  extern __shared__ __align__(16) int32_t bf_sh[];
  __shared__ int last;
  int32_t *pts = bf_sh;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5, k = lane % FE_NL;
  int32_t *buf = bf_sh + 32 * BF_PT + w * WP_WORDS;
  const int s = blockIdx.x % BF_BLOCKS, t = blockIdx.x / BF_BLOCKS, q = s & 1;
  const int64_t n = (int64_t)256 * t_windows;
  {  // level 1: warp w adds bucket v + 128 to bucket v
    const int v = (w < 16 ? 0 : 48) + 16 * s + w;
    int32_t x[4], y[4], r[4];
    bf_load(prefix, n, (int64_t)v * t_windows + t, k, x);
    if (v + 128 == 255) {  // bucket 255 masked: the identity (0, 1, 1, 0)
#pragma unroll
      for (int c = 0; c < 4; c++) y[c] = (c == 1 || c == 2) && k == 0 ? 1 : 0;
    } else {
      bf_load(prefix, n, (int64_t)(v + 128) * t_windows + t, k, y);
    }
    w_padd(x, y, r, buf);
    if (lane < FE_NL) {
#pragma unroll
      for (int c = 0; c < 4; c++) pts[w * BF_PT + c * FE_NL + k] = r[c];
    }
    __syncthreads();
  }
  bf_level(pts, 16, buf);  // level 2: positions 16 s + j
  int32_t *win = nodes + (int64_t)t * BF_NODES * BF_PT;  // level 2 at 0..63, level 3 at 64..95
  if (!bf_handoff(pts, win + 16 * s * BF_PT, arrived + 3 * t + q, &last)) return;
  bf_gather(pts, win + 16 * q * BF_PT, win + (32 + 16 * q) * BF_PT);
  bf_level(pts, 16, buf);  // level 3: positions 16 q + j
  if (!bf_handoff(pts, win + (64 + 16 * q) * BF_PT, arrived + 3 * t + 2, &last)) return;
  bf_gather(pts, win + 64 * BF_PT, win + 80 * BF_PT);
  for (int h = 16; h >= 1; h >>= 1) bf_level(pts, h, buf);  // levels 4-8
  if (threadIdx.x < BF_PT) {  // one limb row per thread: the sum and unmasked P_255
    s_out[(int64_t)threadIdx.x * t_windows + t] = pts[threadIdx.x];
    p255_out[(int64_t)threadIdx.x * t_windows + t] =
        prefix[(int64_t)threadIdx.x * n + (int64_t)255 * t_windows + t];
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

static size_t fenwick_smem_bytes(int kf) {
  return (size_t)(8 * FE_NL * 32 + 3 * FW_PT + 32 * kf) * sizeof(int32_t);
}

extern "C" int tm_fenwick_reduce(const int32_t *lvl0, int64_t n0, const int32_t *ctree, int64_t n1,
                                 const int32_t *top, int64_t n2, const int32_t *idx, int kf,
                                 int32_t *out, int64_t m, int t_windows, void *stream) {
  if (t_windows < 1 || m % t_windows) return (int)cudaErrorInvalidValue;
  const size_t smem = fenwick_smem_bytes(kf);
  // the dynamic shared memory the kernel may take, raised once per device and size
  static size_t allowed[UT_MAX_DEVICES];
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 0 || dev >= UT_MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  if (smem > allowed[dev]) {
    const cudaError_t err =
        cudaFuncSetAttribute(fenwick_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    allowed[dev] = smem;
  }
  const int64_t groups = (m / t_windows + 31) / 32;
  fenwick_kernel<<<(unsigned)(groups * t_windows), FW_THREADS, smem, (cudaStream_t)stream>>>(
      lvl0, n0, ctree, n1, top, n2, idx, kf, out, m, t_windows);
  return (int)cudaGetLastError();
}

extern "C" int tm_bucket_fold(const int32_t *prefix, int t_windows, int32_t *nodes, int *arrived,
                              int32_t *s_out, int32_t *p255_out, void *stream) {
  if (t_windows < 1) return (int)cudaErrorInvalidValue;
  const size_t smem = bucket_fold_smem_bytes();
  // the dynamic shared memory the kernel takes, raised once per device
  static bool allowed[UT_MAX_DEVICES];
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 0 || dev >= UT_MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  if (!allowed[dev]) {
    const cudaError_t err = cudaFuncSetAttribute(
        bucket_fold_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    allowed[dev] = true;
  }
  bucket_fold_kernel<<<(unsigned)(t_windows * BF_BLOCKS), BF_THREADS, smem,
                       (cudaStream_t)stream>>>(prefix, t_windows, nodes, arrived, s_out, p255_out);
  return (int)cudaGetLastError();
}
