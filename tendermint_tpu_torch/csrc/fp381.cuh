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

// ---------------------------------------------------------------------------
// The same product split over a warp: lane t owns limb positions 2t, 2t + 1
// (FPG_L positions a lane, FPG_N = 64 a warp; positions 33..63 hold zeros).
//
// The interleaved schedule's digits m_i are exactly the 12-bit digits of
// M = -a b p^-1 mod 2^396, whatever order the sums run in, and its limbs
// before the 3 carry passes are the columns 33..65 of a b + M p, with
// (sum_{k<33} col_k 2^12k) / 2^396 added to limb 33. So the warp computes
//   1. the columns of a b; T = its low 33 columns after 2 carry passes
//      (limbs <= 4,161; the carry out of limb 32 dropped: T = a b mod 2^396);
//   2. M = the low 33 columns of T * N' (N' = -p^-1 mod 2^396, FP_NPRIME),
//      carried until every digit is below 2^12 (the carry out of limb 32
//      dropped): 3 passes leave every digit <= 4096; a digit of 4096 (a
//      carry rippling through digits of 4095, on rare inputs) takes one
//      more pass each while a warp vote sees one. The digits must be exact:
//      a top digit left at 4096 makes M 2^396 too large and the result p
//      too large (tests/test_torch_kernel_schedules.py holds such inputs);
//   3. the columns of M p added to those of a b;
//   4. C = the carry into column 33, from columns 30..32 alone (their low
//      columns sum to a multiple of 2^396, so the rest cannot change it);
//   5. columns 33..65 (+ C on column 33) and fp_carry<3>'s passes, where
//      the columns lie, so the limbs come out rotated (fpg_out_limb).
// Every term is non-negative and every column of a b + M p stays below
// 1.11e9 < 2^31 (the reference's bound), so no order of the sums overflows.
//
// Columns: lane t owns positions 2t, 2t + 1 of the low half (columns 2t + j)
// and of the high half (columns 64 + 2t + j). It reads the first factor
// rotated by 2t from a doubled shared buffer, rot[m] = X[(2t + m) mod 64],
// and the second factor Y un-rotated, so term m of column j pairs rot[m]
// with Y[(j - m) mod 64]: one instruction stream with compile-time indices
// for every lane (a cyclic product over a rotated buffer). A term lands in the
// low column when m <= j inside block 0 (m < 2), or when its block d = m / 2
// wrapped (d >= 32 - t): so the running sum of blocks 1..d, kept at
// d = 31 - t by one AND-OR a block, is the high part, and the rest of the
// sum the low part. Terms whose Y index is >= 33 are zero and not issued.
// A run of K carry passes fetches the K limbs before a lane's first slot by
// __shfl_sync once and repeats their passes.

#define FPG_G 32                  // lanes a product: a warp
#define FPG_L 2                   // limb positions a lane
#define FPG_N (FPG_G * FPG_L)     // positions a product
#define FPG_FULL 0xffffffffu

// N' = -p^-1 mod 2^396.
__device__ __constant__ int32_t FP_NPRIME[FP_NL] = {
    4093, 4047, 3327, 4095, 2547, 3720, 275,  3485, 2962, 1709, 2088,
    180,  2275, 3852, 3886, 366,  2892, 2861, 3726, 3232, 2540, 1409,
    2255, 3622, 1790, 2865, 1128, 4041, 3754, 111,  97,   3307, 1952};

// A warp's shared memory: the second factor (16-byte aligned for int4
// reads) and the doubled first factor.
struct fp_group_smem {
  int4 un[9];
  int32_t dbl[2 * FPG_N];
};

// The limb of the product that slot s of lane t holds on return from
// fp_mul_group: limb k sits at position (33 + k) mod 64 (the high columns'
// place), so -1 where that is no limb.
__device__ __forceinline__ int fpg_out_limb(int t, int s) {
  const int k = (FPG_L * t + s + FPG_N - FP_NL) % FPG_N;
  return k < FP_NL ? k : -1;
}

// K carry passes over a value whose limb k0 + s (mod 64) slot s of lane t
// holds (k0 = (2t - off) mod 64; limb numbers >= 33 hold 0 and stay 0), in
// one exchange: the lane fetches the raw limbs k0 - K .. k0 - 1 from the
// lanes before it (cyclically, by __shfl_sync) and runs the K passes over
// them and its own slots; after K passes its slots are exact. No carry
// enters limb 0; the carry out of limb 32 is dropped.
template <int K>
__device__ __forceinline__ void fpg_passes(int32_t (&x)[FPG_L], int t, int off) {
  constexpr int L = FPG_L, N = FPG_N;
  const int k0 = (L * t - off + N) % N;
  int32_t e[K + L];
#pragma unroll
  for (int i = 1; i <= K; i++) {
    const int src = (t - 1 - (i - 1) / L + FPG_G) % FPG_G;
    const int32_t v = __shfl_sync(FPG_FULL, x[L - 1 - (i - 1) % L], src);
    e[K - i] = k0 - i >= 0 && (k0 - i) % N < FP_NL ? v : 0;
  }
#pragma unroll
  for (int s = 0; s < L; s++) e[K + s] = x[s];
#pragma unroll
  for (int pass = 0; pass < K; pass++) {
    int32_t c[K + L];
#pragma unroll
    for (int q = 0; q < K + L; q++) c[q] = e[q] >> FP_RADIX;
    e[0] &= FP_MASK;
#pragma unroll
    for (int q = 1; q < K + L; q++) e[q] = (e[q] & FP_MASK) + c[q - 1];
#pragma unroll
    for (int q = 0; q < K + L; q++) {
      const int u = k0 - K + q;
      if (u < 0 || u % N >= FP_NL) e[q] = 0;
    }
  }
#pragma unroll
  for (int s = 0; s < L; s++) x[s] = e[K + s];
}

// Low (and high) columns 2t + j, 64 + 2t + j of X * Y: X in `dbl` (doubled,
// zero padded), Y(x) for x < 33; e[d] = -[d == 31 - t], so that the pick of
// the running sum is an AND-OR (ALU pipe) beside the multiply-adds (FMA
// pipe).
template <bool HIGH, typename Y>
__device__ __forceinline__ void fpg_product(const int32_t *dbl, int t,
                                            const int32_t (&e)[FPG_G], Y y,
                                            int32_t (&lo)[FPG_L], int32_t (&hi)[FPG_L]) {
  constexpr int G = FPG_G, L = FPG_L, N = FPG_N;
  int32_t rot[N];
#pragma unroll
  for (int m = 0; m < N; m++) {
    bool used = false;
#pragma unroll
    for (int j = 0; j < L; j++) used |= (j - m + N) % N < FP_NL;
    if (used) rot[m] = dbl[L * t + m];
  }
#pragma unroll
  for (int j = 0; j < L; j++) {
    int32_t p0 = 0, q0 = 0, s = 0, snap = 0;
#pragma unroll
    for (int m = 0; m < L; m++) {
      if (m <= j)
        p0 += rot[m] * y(j - m);
      else if (HIGH && j - m + N < FP_NL)
        q0 += rot[m] * y(j - m + N);
    }
#pragma unroll
    for (int d = 1; d < G; d++) {
      bool any = false;
#pragma unroll
      for (int mp = 0; mp < L; mp++) {
        const int x = j - L * d - mp + N;
        if (x < FP_NL) {
          s += rot[L * d + mp] * y(x);
          any = true;
        }
      }
      if (any) snap |= s & e[d];  // a prefix of empty blocks leaves s = 0
    }
    lo[j] = p0 + s - snap;
    if (HIGH) hi[j] = q0 + snap;
  }
}

// r = a * b * 2^-396 (fp_mul_stream's limbs) for the warp's product: lane t
// passes positions 2t, 2t + 1 of a and b (limb i at position i, 0 at
// positions >= 33) and gets in r[s] the limb fpg_out_limb(t, s). All 32
// lanes call it.
__device__ __forceinline__ void fp_mul_group(const int32_t (&a)[FPG_L], const int32_t (&b)[FPG_L],
                                             int32_t (&r)[FPG_L], fp_group_smem &sm, int t) {
  constexpr int G = FPG_G, L = FPG_L, N = FPG_N;
  int32_t e[G];
#pragma unroll
  for (int d = 0; d < G; d++) e[d] = d == G - 1 - t ? -1 : 0;
  int32_t x[L], lo[L], hi[L], ml[L], mh[L];

  // 1. a b, then T
#pragma unroll
  for (int s = 0; s < L; s++) {
    const int p = L * t + s;
    sm.dbl[p] = a[s];
    sm.dbl[p + N] = a[s];
    if (p < FP_NL) reinterpret_cast<int32_t *>(sm.un)[p] = b[s];
  }
  __syncwarp();
  int32_t bv[36];
#pragma unroll
  for (int q = 0; q < 9; q++) {
    const int4 v = sm.un[q];
    bv[4 * q] = v.x;
    bv[4 * q + 1] = v.y;
    bv[4 * q + 2] = v.z;
    bv[4 * q + 3] = v.w;
  }
  fpg_product<true>(sm.dbl, t, e, [&](int i) { return bv[i]; }, lo, hi);
#pragma unroll
  for (int s = 0; s < L; s++) x[s] = L * t + s < FP_NL ? lo[s] : 0;
  fpg_passes<2>(x, t, 0);

  // 2. M = low(T N'), exact digits
  __syncwarp();
#pragma unroll
  for (int s = 0; s < L; s++) {
    sm.dbl[L * t + s] = x[s];
    sm.dbl[L * t + s + N] = x[s];
  }
  __syncwarp();
  fpg_product<false>(sm.dbl, t, e, [](int i) { return FP_NPRIME[i]; }, ml, mh);
#pragma unroll
  for (int s = 0; s < L; s++) x[s] = L * t + s < FP_NL ? ml[s] : 0;
  fpg_passes<3>(x, t, 0);
  for (;;) {
    bool over = false;
#pragma unroll
    for (int s = 0; s < L; s++) over |= x[s] > FP_MASK;
    if (!__any_sync(FPG_FULL, over)) break;
    fpg_passes<1>(x, t, 0);
  }

  // 3. + M p
  __syncwarp();
#pragma unroll
  for (int s = 0; s < L; s++) {
    sm.dbl[L * t + s] = x[s];
    sm.dbl[L * t + s + N] = x[s];
  }
  __syncwarp();
  fpg_product<true>(sm.dbl, t, e, [](int i) { return FP_P[i]; }, ml, mh);
#pragma unroll
  for (int s = 0; s < L; s++) {
    lo[s] += ml[s];
    hi[s] += mh[s];
  }

  // 4. C, the carry into column 33: the low columns sum to a multiple S of
  //    2^396, and columns 0..29 add less than 2^-17 to S / 2^396, so
  //    C = ceil((col32 2^24 + col31 2^12 + col30) / 2^36).
  const int64_t c32 = __shfl_sync(FPG_FULL, lo[32 % L], 32 / L);
  const int64_t c31 = __shfl_sync(FPG_FULL, lo[31 % L], 31 / L);
  const int64_t c30 = __shfl_sync(FPG_FULL, lo[30 % L], 30 / L);
  const int32_t C = (int32_t)(((c32 << 24) + (c31 << 12) + c30 + ((1ll << 36) - 1)) >> 36);

  // 5. columns 33..65 where they lie (low positions >= 33, then the high
  //    ones), C on column 33, fp_carry<3>'s passes
#pragma unroll
  for (int s = 0; s < L; s++) {
    const int p = L * t + s;
    x[s] = fpg_out_limb(t, s) < 0 ? 0 : p >= FP_NL ? lo[s] : hi[s];
  }
  if (t == FP_NL / L) x[FP_NL % L] += C;
  fpg_passes<3>(x, t, FP_NL);
#pragma unroll
  for (int s = 0; s < L; s++) r[s] = x[s];
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
