// GF(2^255-19) in 8 x 32-bit words, for one lane in registers: the
// arithmetic of fsquare_chain_kernel (point_kernels.cu).
//
// A value is w[0..7], W = sum w_i 2^(32 i) < 2^256, standing for W mod p: the
// squarings reduce lazily (2^256 = 38 and 2^255 = 19 mod p, never to [0, p)),
// and w32_freeze gives the canonical representative once, at the end.
// Sums and products run on PTX carry chains (add.cc / addc, mad.lo.cc /
// madc.hi.cc). The compiler does not promise that the carry flag survives
// from one asm statement to the next, so each chain is one asm block; ptxas
// holds the flag in a predicate register and schedules independent chains
// side by side. Constants enter as register operands, and every word a
// chain writes is a "+r" operand, so no output shares a register with an
// input.
//
// tests/test_torch_fsquare_words.py reads each asm block from this file,
// runs it on an interpreter with one carry flag, and models the C++ between
// the blocks (pack, first rows, funnel shifts, folds, unpack) with Python
// integers: a new block needs a place in its EXPECTED_BLOCKS and its model.
#pragma once
#include <stdint.h>

// W + 19 top on one carry chain from word 0; the caller bounds the sum below
// 2^256 (top is the value's bits from 2^255 up, already cleared from w).
__device__ __forceinline__ void w32_add19(uint32_t (&w)[8], uint32_t top) {
  asm volatile(
      "mad.lo.cc.u32 %0, %8, %9, %0;\n\t"
      "addc.cc.u32 %1, %1, 0;\n\t"
      "addc.cc.u32 %2, %2, 0;\n\t"
      "addc.cc.u32 %3, %3, 0;\n\t"
      "addc.cc.u32 %4, %4, 0;\n\t"
      "addc.cc.u32 %5, %5, 0;\n\t"
      "addc.cc.u32 %6, %6, 0;\n\t"
      "addc.u32 %7, %7, 0;"
      : "+r"(w[0]), "+r"(w[1]), "+r"(w[2]), "+r"(w[3]), "+r"(w[4]), "+r"(w[5]), "+r"(w[6]),
        "+r"(w[7])
      : "r"(top), "r"(19u));
}

// Carried radix-2^13 limbs (limb 0 <= 2^13 + 607, the others <= 2^13, so the
// value is < 2^261) -> words: limb i is added at bit 13 i of a 64-bit window
// that emits a word once no later limb reaches below its top; then the bits
// from 2^255 up fold back as 19 x top (W < 2^255 + 19 x 63).
__device__ __forceinline__ void w32_pack(const int32_t (&limb)[20], uint32_t (&w)[8]) {
  uint64_t acc = 0;
#pragma unroll
  for (int i = 0; i < 20; i++) {
    acc += (uint64_t)(uint32_t)limb[i] << ((13 * i) % 32);
    if ((13 * (i + 1)) / 32 > (13 * i) / 32) {  // word 13 i / 32 is complete
      w[(13 * i) / 32] = (uint32_t)acc;
      acc >>= 32;
    }
  }
  const uint32_t top = ((uint32_t)acc << 1) | (w[7] >> 31);
  w[7] &= 0x7fffffffu;
  w32_add19(w, top);
}

// acc[B .. B + 2N] += sum_m a b_m 2^(32 (B + 2m)) on one carry chain:
// lo(a b_m) at word B + 2m, hi at B + 2m + 1, the carry into word B + 2N.
template <int N, int B>
__device__ __forceinline__ void w32_mac(uint32_t (&acc)[16], uint32_t a, uint32_t b0,
                                        uint32_t b1, uint32_t b2) {
  static_assert(N >= 1 && N <= 3, "w32_mac: 1 to 3 products");
  if constexpr (N == 1) {
    asm volatile(
        "mad.lo.cc.u32 %0, %3, %4, %0;\n\t"
        "madc.hi.cc.u32 %1, %3, %4, %1;\n\t"
        "addc.u32 %2, %2, 0;"
        : "+r"(acc[B + 0]), "+r"(acc[B + 1]), "+r"(acc[B + 2])
        : "r"(a), "r"(b0));
  } else if constexpr (N == 2) {
    asm volatile(
        "mad.lo.cc.u32 %0, %5, %6, %0;\n\t"
        "madc.hi.cc.u32 %1, %5, %6, %1;\n\t"
        "madc.lo.cc.u32 %2, %5, %7, %2;\n\t"
        "madc.hi.cc.u32 %3, %5, %7, %3;\n\t"
        "addc.u32 %4, %4, 0;"
        : "+r"(acc[B + 0]), "+r"(acc[B + 1]), "+r"(acc[B + 2]), "+r"(acc[B + 3]), "+r"(acc[B + 4])
        : "r"(a), "r"(b0), "r"(b1));
  } else {
    asm volatile(
        "mad.lo.cc.u32 %0, %7, %8, %0;\n\t"
        "madc.hi.cc.u32 %1, %7, %8, %1;\n\t"
        "madc.lo.cc.u32 %2, %7, %9, %2;\n\t"
        "madc.hi.cc.u32 %3, %7, %9, %3;\n\t"
        "madc.lo.cc.u32 %4, %7, %10, %4;\n\t"
        "madc.hi.cc.u32 %5, %7, %10, %5;\n\t"
        "addc.u32 %6, %6, 0;"
        : "+r"(acc[B + 0]), "+r"(acc[B + 1]), "+r"(acc[B + 2]), "+r"(acc[B + 3]),
          "+r"(acc[B + 4]), "+r"(acc[B + 5]), "+r"(acc[B + 6])
        : "r"(a), "r"(b0), "r"(b1), "r"(b2));
  }
}

// Row I of the cross products a_I a_j, j = J, J + 2, ... <= 7: their 64-bit
// products tile the words from I + J up without overlap (lo(a_I a_j) at
// I + j, hi at I + j + 1). The first row of an accumulator writes its
// words; a later one adds into them on one carry chain (w32_mac), carrying
// into the word above its last (test_torch_fsquare_words.py checks at the
// all-ones input, the largest partial sums, that the carry stops there).
template <int I, int J, bool FIRST>
__device__ __forceinline__ void w32_row(uint32_t (&acc)[16], const uint32_t (&a)[8]) {
  constexpr int N = (7 - J) / 2 + 1;  // products in the row
  if constexpr (FIRST) {
#pragma unroll
    for (int j = J; j < 8; j += 2) {
      acc[I + j] = a[I] * a[j];
      acc[I + j + 1] = __umulhi(a[I], a[j]);
    }
  } else {
    w32_mac<N, I + J>(acc, a[I], a[J], a[J + 2 < 8 ? J + 2 : J], a[J + 4 < 8 ? J + 4 : J]);
  }
}

// a <- a^2 (mod p), lazily: in W < 2^256, out W < 2^255 + 19 x 77.
//  1. Cross products C = sum_{i<j} a_i a_j 2^(32(i+j)) in two accumulators,
//     e (the rows' factors j = i+1, i+3, ...) and o (j = i+2, i+4, ...),
//     each a wavefront of row chains, then C = e + o on one chain.
//  2. T = 2 C + sum a_i^2 2^(64 i): 2 C by funnel shifts (independent), the
//     squares added on one chain (lo at word 2i, hi at 2i + 1).
//  3. R = T_lo + 38 T_hi (2^256 = 38): the lo products on one chain, the hi
//     products on a second (R < 39 x 2^256, 9 words).
//  4. The bits from 2^255 up fold back as 19 x top (w32_add19).
// 28 + 8 + 16 32-bit products as 56 + 16 + 16 multiply instructions.
__device__ __forceinline__ void w32_square(uint32_t (&a)[8]) {
  uint32_t e[16], o[16];
#pragma unroll
  for (int k = 0; k < 16; k++) {
    e[k] = 0;
    o[k] = 0;
  }
  w32_row<0, 1, true>(e, a);
  w32_row<0, 2, true>(o, a);
  w32_row<1, 2, false>(e, a);
  w32_row<1, 3, false>(o, a);
  w32_row<2, 3, false>(e, a);
  w32_row<2, 4, false>(o, a);
  w32_row<3, 4, false>(e, a);
  w32_row<3, 5, false>(o, a);
  w32_row<4, 5, false>(e, a);
  w32_row<4, 6, false>(o, a);
  w32_row<5, 6, false>(e, a);
  w32_row<5, 7, false>(o, a);
  w32_row<6, 7, false>(e, a);
  // C = e + o: e holds words 1..15, o words 2..14
  asm volatile(
      "add.cc.u32 %0, %0, %14;\n\t"
      "addc.cc.u32 %1, %1, %15;\n\t"
      "addc.cc.u32 %2, %2, %16;\n\t"
      "addc.cc.u32 %3, %3, %17;\n\t"
      "addc.cc.u32 %4, %4, %18;\n\t"
      "addc.cc.u32 %5, %5, %19;\n\t"
      "addc.cc.u32 %6, %6, %20;\n\t"
      "addc.cc.u32 %7, %7, %21;\n\t"
      "addc.cc.u32 %8, %8, %22;\n\t"
      "addc.cc.u32 %9, %9, %23;\n\t"
      "addc.cc.u32 %10, %10, %24;\n\t"
      "addc.cc.u32 %11, %11, %25;\n\t"
      "addc.cc.u32 %12, %12, %26;\n\t"
      "addc.u32 %13, %13, 0;"
      : "+r"(e[2]), "+r"(e[3]), "+r"(e[4]), "+r"(e[5]), "+r"(e[6]), "+r"(e[7]), "+r"(e[8]),
        "+r"(e[9]), "+r"(e[10]), "+r"(e[11]), "+r"(e[12]), "+r"(e[13]), "+r"(e[14]),
        "+r"(e[15])
      : "r"(o[2]), "r"(o[3]), "r"(o[4]), "r"(o[5]), "r"(o[6]), "r"(o[7]), "r"(o[8]), "r"(o[9]),
        "r"(o[10]), "r"(o[11]), "r"(o[12]), "r"(o[13]), "r"(o[14]));
  // T = 2 C + the squares: t starts as 2 C (funnel shifts, independent), the
  // squares' lo and hi words go in on one chain from word 1
  uint32_t t[16];
  t[0] = a[0] * a[0];
  t[1] = e[1] << 1;
#pragma unroll
  for (int k = 2; k < 16; k++) t[k] = __funnelshift_l(e[k - 1], e[k], 1);
  asm volatile(
      "mad.hi.cc.u32 %0, %15, %15, %0;\n\t"
      "madc.lo.cc.u32 %1, %16, %16, %1;\n\t"
      "madc.hi.cc.u32 %2, %16, %16, %2;\n\t"
      "madc.lo.cc.u32 %3, %17, %17, %3;\n\t"
      "madc.hi.cc.u32 %4, %17, %17, %4;\n\t"
      "madc.lo.cc.u32 %5, %18, %18, %5;\n\t"
      "madc.hi.cc.u32 %6, %18, %18, %6;\n\t"
      "madc.lo.cc.u32 %7, %19, %19, %7;\n\t"
      "madc.hi.cc.u32 %8, %19, %19, %8;\n\t"
      "madc.lo.cc.u32 %9, %20, %20, %9;\n\t"
      "madc.hi.cc.u32 %10, %20, %20, %10;\n\t"
      "madc.lo.cc.u32 %11, %21, %21, %11;\n\t"
      "madc.hi.cc.u32 %12, %21, %21, %12;\n\t"
      "madc.lo.cc.u32 %13, %22, %22, %13;\n\t"
      "madc.hi.u32 %14, %22, %22, %14;"
      : "+r"(t[1]), "+r"(t[2]), "+r"(t[3]), "+r"(t[4]), "+r"(t[5]), "+r"(t[6]), "+r"(t[7]),
        "+r"(t[8]), "+r"(t[9]), "+r"(t[10]), "+r"(t[11]), "+r"(t[12]), "+r"(t[13]),
        "+r"(t[14]), "+r"(t[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(a[4]), "r"(a[5]), "r"(a[6]),
        "r"(a[7]));
  // R = T_lo + 38 T_hi: the lo products on one chain, then the hi products
  uint32_t r[9];
#pragma unroll
  for (int k = 0; k < 8; k++) r[k] = t[k];
  r[8] = 0;
  asm volatile(
      "mad.lo.cc.u32 %0, %9, %17, %0;\n\t"
      "madc.lo.cc.u32 %1, %10, %17, %1;\n\t"
      "madc.lo.cc.u32 %2, %11, %17, %2;\n\t"
      "madc.lo.cc.u32 %3, %12, %17, %3;\n\t"
      "madc.lo.cc.u32 %4, %13, %17, %4;\n\t"
      "madc.lo.cc.u32 %5, %14, %17, %5;\n\t"
      "madc.lo.cc.u32 %6, %15, %17, %6;\n\t"
      "madc.lo.cc.u32 %7, %16, %17, %7;\n\t"
      "addc.u32 %8, %8, 0;"
      : "+r"(r[0]), "+r"(r[1]), "+r"(r[2]), "+r"(r[3]), "+r"(r[4]), "+r"(r[5]), "+r"(r[6]),
        "+r"(r[7]), "+r"(r[8])
      : "r"(t[8]), "r"(t[9]), "r"(t[10]), "r"(t[11]), "r"(t[12]), "r"(t[13]), "r"(t[14]),
        "r"(t[15]), "r"(38u));
  asm volatile(
      "mad.hi.cc.u32 %0, %8, %16, %0;\n\t"
      "madc.hi.cc.u32 %1, %9, %16, %1;\n\t"
      "madc.hi.cc.u32 %2, %10, %16, %2;\n\t"
      "madc.hi.cc.u32 %3, %11, %16, %3;\n\t"
      "madc.hi.cc.u32 %4, %12, %16, %4;\n\t"
      "madc.hi.cc.u32 %5, %13, %16, %5;\n\t"
      "madc.hi.cc.u32 %6, %14, %16, %6;\n\t"
      "madc.hi.u32 %7, %15, %16, %7;"
      : "+r"(r[1]), "+r"(r[2]), "+r"(r[3]), "+r"(r[4]), "+r"(r[5]), "+r"(r[6]), "+r"(r[7]),
        "+r"(r[8])
      : "r"(t[8]), "r"(t[9]), "r"(t[10]), "r"(t[11]), "r"(t[12]), "r"(t[13]), "r"(t[14]),
        "r"(t[15]), "r"(38u));
  const uint32_t top = (r[8] << 1) | (r[7] >> 31);
#pragma unroll
  for (int k = 0; k < 7; k++) a[k] = r[k];
  a[7] = r[7] & 0x7fffffffu;
  w32_add19(a, top);
}

// The canonical representative of W < 2^256: fold bit 255 (W < 2^255 + 19),
// then W - p = W + 19 - 2^255 where W + 19 reaches 2^255.
__device__ __forceinline__ void w32_freeze(uint32_t (&w)[8]) {
  const uint32_t top = w[7] >> 31;
  w[7] &= 0x7fffffffu;
  w32_add19(w, top);
  uint32_t u[8];
#pragma unroll
  for (int i = 0; i < 8; i++) u[i] = w[i];
  asm volatile(
      "add.cc.u32 %0, %0, %8;\n\t"
      "addc.cc.u32 %1, %1, 0;\n\t"
      "addc.cc.u32 %2, %2, 0;\n\t"
      "addc.cc.u32 %3, %3, 0;\n\t"
      "addc.cc.u32 %4, %4, 0;\n\t"
      "addc.cc.u32 %5, %5, 0;\n\t"
      "addc.cc.u32 %6, %6, 0;\n\t"
      "addc.u32 %7, %7, 0;"
      : "+r"(u[0]), "+r"(u[1]), "+r"(u[2]), "+r"(u[3]), "+r"(u[4]), "+r"(u[5]), "+r"(u[6]),
        "+r"(u[7])
      : "r"(19u));
  const bool ge = (u[7] >> 31) != 0;
#pragma unroll
  for (int i = 0; i < 8; i++) w[i] = ge ? u[i] : w[i];
  w[7] &= 0x7fffffffu;
}

// Canonical words (W < p) -> canonical radix-2^13 limbs (each < 2^13).
__device__ __forceinline__ void w32_unpack(const uint32_t (&w)[8], int32_t (&limb)[20]) {
#pragma unroll
  for (int i = 0; i < 20; i++) {
    const int q = (13 * i) / 32, s = (13 * i) % 32;
    uint32_t v = w[q] >> s;
    if (s > 19 && q < 7) v |= w[q + 1] << (32 - s);
    limb[i] = (int32_t)(v & 0x1fffu);
  }
}
