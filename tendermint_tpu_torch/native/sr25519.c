/* Native sr25519 (schnorrkel) verification: Schnorr over ristretto255 with
 * merlin transcript binding (reference: crypto/sr25519/pubkey.go:34 verifies
 * via go-schnorrkel).
 *
 * The port's own copy of tendermint_tpu/native/sr25519.c. It mirrors the
 * pure-Python verifier of crypto/sr25519.py and crypto/merlin.py (both
 * written from the public ristretto255 / Merlin / STROBE specifications)
 * bit for bit, and is tested against it and against the reference package
 * (tests/test_torch_sr25519.py). The Python verifier works on bigints
 * (point_mul) and is far slower, so the sr25519 rows of a mixed validator
 * set run here, on the host, while the card takes the Ed25519 rows.
 *
 * Field arithmetic: 4x64-bit limbs, __uint128_t products, loose (< 2^256)
 * representation with 2^256 === 38 (mod p) folding; canonical freeze only at
 * encode/compare boundaries. Curve constants are generated at build time
 * from their definitions (native/__init__.py, ed25519_constants_header), not
 * copied from any implementation. Verification is variable-time: public
 * inputs only.
 */

#include <pthread.h>
#include <stdint.h>
#include <string.h>

#include "ed25519_constants.h" /* generated: FE_D, FE_D2, FE_SQRT_M1, ... */

typedef unsigned __int128 u128;

/* from batchhost.c (same shared object): X (8 limbs) mod L -> 4 limbs */
void tm_mod_l_512(const uint64_t *x, uint64_t *r);

/* ------------------------------------------------------------------ */
/* fe25519: arithmetic mod p = 2^255 - 19, 4x64 limbs, loose < 2^256   */

typedef struct {
  uint64_t v[4];
} fe;

static void fe_copy(fe *r, const fe *a) { memcpy(r->v, a->v, 32); }

static void fe_from_limbs(fe *r, const uint64_t *l) { memcpy(r->v, l, 32); }

static void fe_from_bytes(fe *r, const uint8_t b[32]) {
  for (int i = 0; i < 4; i++) {
    uint64_t w = 0;
    for (int j = 7; j >= 0; j--) w = (w << 8) | b[8 * i + j];
    r->v[i] = w;
  }
}

/* fold a 1-limb carry c: value += c * 38 (2^256 === 38 mod p) */
static void fe_fold(fe *r, uint64_t c) {
  u128 t = (u128)r->v[0] + (u128)c * 38;
  r->v[0] = (uint64_t)t;
  uint64_t carry = (uint64_t)(t >> 64);
  for (int i = 1; i < 4 && carry; i++) {
    t = (u128)r->v[i] + carry;
    r->v[i] = (uint64_t)t;
    carry = (uint64_t)(t >> 64);
  }
  /* carry can only be nonzero again if the value was ~2^256; one more
   * 38-fold is bounded and terminates */
  if (carry) fe_fold(r, carry);
}

static void fe_add(fe *r, const fe *a, const fe *b) {
  uint64_t carry = 0;
  for (int i = 0; i < 4; i++) {
    u128 t = (u128)a->v[i] + b->v[i] + carry;
    r->v[i] = (uint64_t)t;
    carry = (uint64_t)(t >> 64);
  }
  fe_fold(r, carry);
}

/* r = a - b (mod p), computed as a + 4p - b to stay non-negative */
static void fe_sub(fe *r, const fe *a, const fe *b) {
  uint64_t t[5];
  uint64_t carry = 0;
  for (int i = 0; i < 4; i++) {
    u128 s = (u128)a->v[i] + FE_4P[i] + carry;
    t[i] = (uint64_t)s;
    carry = (uint64_t)(s >> 64);
  }
  t[4] = FE_4P[4] + carry;
  uint64_t borrow = 0;
  for (int i = 0; i < 4; i++) {
    uint64_t bi = b->v[i] + borrow;
    uint64_t nb = (bi < borrow) || (t[i] < bi);
    t[i] -= bi;
    borrow = nb;
  }
  t[4] -= borrow;
  memcpy(r->v, t, 32);
  fe_fold(r, t[4]);
}

static void fe_mul(fe *r, const fe *a, const fe *b) {
  uint64_t lo[4] = {0, 0, 0, 0}, hi[4] = {0, 0, 0, 0};
  uint64_t w[8] = {0};
  for (int i = 0; i < 4; i++) {
    uint64_t carry = 0;
    for (int j = 0; j < 4; j++) {
      u128 t = (u128)a->v[i] * b->v[j] + w[i + j] + carry;
      w[i + j] = (uint64_t)t;
      carry = (uint64_t)(t >> 64);
    }
    w[i + 4] += carry;
  }
  memcpy(lo, w, 32);
  memcpy(hi, w + 4, 32);
  /* r = lo + 38*hi */
  uint64_t carry = 0;
  for (int i = 0; i < 4; i++) {
    u128 t = (u128)hi[i] * 38 + lo[i] + carry;
    r->v[i] = (uint64_t)t;
    carry = (uint64_t)(t >> 64);
  }
  fe_fold(r, carry);
}

static void fe_sqr(fe *r, const fe *a) { fe_mul(r, a, a); }

static void fe_zero(fe *r) { memset(r->v, 0, 32); }

static void fe_one(fe *r) {
  fe_zero(r);
  r->v[0] = 1;
}

static void fe_neg(fe *r, const fe *a) {
  fe z;
  fe_zero(&z);
  fe_sub(r, &z, a);
}

/* canonical reduce into [0, p) */
static void fe_freeze(fe *r) {
  /* value < 2^256: subtract p at most a few times */
  for (int k = 0; k < 3; k++) {
    int ge = 0;
    for (int i = 3; i >= 0; i--) {
      if (r->v[i] != FE_P[i]) {
        ge = r->v[i] > FE_P[i];
        goto decided;
      }
    }
    ge = 1;
  decided:
    if (!ge) break;
    uint64_t borrow = 0;
    for (int i = 0; i < 4; i++) {
      uint64_t bi = FE_P[i] + borrow;
      uint64_t nb = (bi < borrow) || (r->v[i] < bi);
      r->v[i] -= bi;
      borrow = nb;
    }
  }
}

static void fe_to_bytes(uint8_t b[32], const fe *a) {
  fe t;
  fe_copy(&t, a);
  fe_freeze(&t);
  for (int i = 0; i < 4; i++)
    for (int j = 0; j < 8; j++) b[8 * i + j] = (uint8_t)(t.v[i] >> (8 * j));
}

static int fe_is_negative(const fe *a) {
  fe t;
  fe_copy(&t, a);
  fe_freeze(&t);
  return (int)(t.v[0] & 1);
}

static int fe_eq(const fe *a, const fe *b) {
  uint8_t ba[32], bb[32];
  fe_to_bytes(ba, a);
  fe_to_bytes(bb, b);
  return memcmp(ba, bb, 32) == 0;
}

static void fe_cond_neg(fe *r, int neg) {
  if (neg) {
    fe t;
    fe_neg(&t, r);
    fe_copy(r, &t);
  }
}

static void fe_abs(fe *r) { fe_cond_neg(r, fe_is_negative(r)); }

/* r = a^((p-5)/8), square-and-multiply over the generated exponent */
static void fe_pow_p58(fe *r, const fe *a) {
  fe acc;
  fe_one(&acc);
  for (int bit = 252; bit >= 0; bit--) {
    fe_sqr(&acc, &acc);
    if ((FE_EXP_P58[bit >> 3] >> (bit & 7)) & 1) fe_mul(&acc, &acc, a);
  }
  fe_copy(r, &acc);
}

/* (was_square, sqrt(u/v) or sqrt(i*u/v)), non-negative
 * (ristretto255 spec SQRT_RATIO_M1; mirrors crypto/sr25519.py) */
static int fe_sqrt_ratio_m1(fe *out, const fe *u, const fe *v) {
  fe v3, v7, p, r, check, i, u_neg, u_neg_i;
  fe_sqr(&v3, v);
  fe_mul(&v3, &v3, v); /* v^3 */
  fe_sqr(&v7, &v3);
  fe_mul(&v7, &v7, v); /* v^7 */
  fe_mul(&p, u, &v7);
  fe_pow_p58(&p, &p);
  fe_mul(&r, u, &v3);
  fe_mul(&r, &r, &p); /* r = u * v^3 * (u*v^7)^((p-5)/8) */
  fe_sqr(&check, &r);
  fe_mul(&check, &check, v); /* check = v * r^2 */
  fe_from_limbs(&i, FE_SQRT_M1);
  fe_neg(&u_neg, u);
  fe_mul(&u_neg_i, &u_neg, &i);
  int correct = fe_eq(&check, u);
  int flipped = fe_eq(&check, &u_neg);
  int flipped_i = fe_eq(&check, &u_neg_i);
  if (flipped || flipped_i) fe_mul(&r, &r, &i);
  fe_abs(&r);
  fe_copy(out, &r);
  return correct || flipped;
}

/* ------------------------------------------------------------------ */
/* Edwards points, extended coordinates (a = -1)                       */

typedef struct {
  fe x, y, z, t;
} pt;

/* unified add-2008-hwcd-3 (mirrors crypto/ed25519_ref.point_add) */
static void pt_add(pt *r, const pt *p, const pt *q) {
  fe a, b, c, d, e, f, g, h, t1, t2;
  fe_sub(&t1, &p->y, &p->x);
  fe_sub(&t2, &q->y, &q->x);
  fe_mul(&a, &t1, &t2);
  fe_add(&t1, &p->y, &p->x);
  fe_add(&t2, &q->y, &q->x);
  fe_mul(&b, &t1, &t2);
  fe_from_limbs(&c, FE_D2);
  fe_mul(&c, &c, &p->t);
  fe_mul(&c, &c, &q->t);
  fe_mul(&d, &p->z, &q->z);
  fe_add(&d, &d, &d);
  fe_sub(&e, &b, &a);
  fe_sub(&f, &d, &c);
  fe_add(&g, &d, &c);
  fe_add(&h, &b, &a);
  fe_mul(&r->x, &e, &f);
  fe_mul(&r->y, &g, &h);
  fe_mul(&r->z, &f, &g);
  fe_mul(&r->t, &e, &h);
}

/* dble-2008-hwcd (mirrors crypto/ed25519_ref.point_double) */
static void pt_double(pt *r, const pt *p) {
  fe a, b, c, e, f, g, h, t1;
  fe_sqr(&a, &p->x);
  fe_sqr(&b, &p->y);
  fe_sqr(&c, &p->z);
  fe_add(&c, &c, &c);
  fe_add(&h, &a, &b);
  fe_add(&t1, &p->x, &p->y);
  fe_sqr(&t1, &t1);
  fe_sub(&e, &h, &t1);
  fe_sub(&g, &a, &b);
  fe_add(&f, &c, &g);
  fe_mul(&r->x, &e, &f);
  fe_mul(&r->y, &g, &h);
  fe_mul(&r->z, &f, &g);
  fe_mul(&r->t, &e, &h);
}

static void pt_identity(pt *r) {
  fe_zero(&r->x);
  fe_one(&r->y);
  fe_one(&r->z);
  fe_zero(&r->t);
}

static void pt_neg(pt *r, const pt *p) {
  fe_neg(&r->x, &p->x);
  fe_copy(&r->y, &p->y);
  fe_copy(&r->z, &p->z);
  fe_neg(&r->t, &p->t);
}

/* r = s*B + k*Q, vartime Strauss–Shamir; s, k: 32-byte LE scalars */
static void pt_double_scalar_mul_base(pt *r, const uint8_t s[32], const pt *q,
                                      const uint8_t k[32]) {
  pt base, table[3];
  fe_from_limbs(&base.x, FE_BASE_X);
  fe_from_limbs(&base.y, FE_BASE_Y);
  fe_one(&base.z);
  fe_from_limbs(&base.t, FE_BASE_T);
  table[0] = base; /* 01: B */
  table[1] = *q;   /* 10: Q */
  pt_add(&table[2], &base, q); /* 11 */
  pt acc;
  pt_identity(&acc);
  int started = 0;
  for (int bit = 255; bit >= 0; bit--) {
    if (started) pt_double(&acc, &acc);
    int sb = (s[bit >> 3] >> (bit & 7)) & 1;
    int kb = (k[bit >> 3] >> (bit & 7)) & 1;
    int idx = sb | (kb << 1);
    if (idx) {
      if (!started) {
        acc = table[idx - 1];
        started = 1;
      } else {
        pt_add(&acc, &acc, &table[idx - 1]);
      }
    }
  }
  if (!started) pt_identity(&acc);
  *r = acc;
}

/* ------------------------------------------------------------------ */
/* ristretto255 decode / encode (mirror crypto/sr25519.py)             */

static int ristretto_decode(pt *out, const uint8_t data[32]) {
  fe s;
  fe_from_bytes(&s, data);
  /* reject non-canonical or negative s (via canonical re-encode compare) */
  {
    uint8_t canon[32];
    fe_to_bytes(canon, &s);
    if (memcmp(canon, data, 32) != 0) return 0;
    if (canon[0] & 1) return 0;
  }
  fe ss, u1, u2, u2s, v, one, d, t1, invsqrt, den_x, den_y, x, y, t;
  fe_one(&one);
  fe_sqr(&ss, &s);
  fe_sub(&u1, &one, &ss);
  fe_add(&u2, &one, &ss);
  fe_sqr(&u2s, &u2);
  fe_from_limbs(&d, FE_D);
  fe_sqr(&t1, &u1);
  fe_mul(&t1, &t1, &d);
  fe_neg(&t1, &t1);
  fe_sub(&v, &t1, &u2s); /* a*d*u1^2 - u2^2, a = -1 */
  fe vu;
  fe_mul(&vu, &v, &u2s);
  int was_square = fe_sqrt_ratio_m1(&invsqrt, &one, &vu);
  fe_mul(&den_x, &invsqrt, &u2);
  fe_mul(&den_y, &invsqrt, &den_x);
  fe_mul(&den_y, &den_y, &v);
  fe_add(&x, &s, &s);
  fe_mul(&x, &x, &den_x);
  fe_abs(&x);
  fe_mul(&y, &u1, &den_y);
  fe_mul(&t, &x, &y);
  if (!was_square || fe_is_negative(&t)) return 0;
  {
    uint8_t yb[32];
    fe_to_bytes(yb, &y);
    int zero = 1;
    for (int i = 0; i < 32; i++) zero &= yb[i] == 0;
    if (zero) return 0;
  }
  fe_copy(&out->x, &x);
  fe_copy(&out->y, &y);
  fe_one(&out->z);
  fe_copy(&out->t, &t);
  return 1;
}

static void ristretto_encode(uint8_t out[32], const pt *p) {
  fe u1, u2, t1, t2, invsqrt, den1, den2, z_inv, one, ix, iy, den_inv, x, y, s;
  fe_copy(&x, &p->x);
  fe_copy(&y, &p->y);
  fe_add(&t1, &p->z, &y);
  fe_sub(&t2, &p->z, &y);
  fe_mul(&u1, &t1, &t2);
  fe_mul(&u2, &x, &y);
  fe_one(&one);
  fe_sqr(&t1, &u2);
  fe_mul(&t1, &t1, &u1);
  fe_sqrt_ratio_m1(&invsqrt, &one, &t1);
  fe_mul(&den1, &invsqrt, &u1);
  fe_mul(&den2, &invsqrt, &u2);
  fe_mul(&z_inv, &den1, &den2);
  fe_mul(&z_inv, &z_inv, &p->t);
  fe_mul(&t1, &p->t, &z_inv);
  if (fe_is_negative(&t1)) {
    fe sqrt_m1, iad;
    fe_from_limbs(&sqrt_m1, FE_SQRT_M1);
    fe_mul(&ix, &x, &sqrt_m1);
    fe_mul(&iy, &y, &sqrt_m1);
    fe_copy(&x, &iy);
    fe_copy(&y, &ix);
    fe_from_limbs(&iad, FE_INVSQRT_A_MINUS_D);
    fe_mul(&den_inv, &den1, &iad);
  } else {
    fe_copy(&den_inv, &den2);
  }
  fe_mul(&t1, &x, &z_inv);
  if (fe_is_negative(&t1)) fe_neg(&y, &y);
  fe_sub(&t1, &p->z, &y);
  fe_mul(&s, &den_inv, &t1);
  fe_abs(&s);
  fe_to_bytes(out, &s);
}

/* ------------------------------------------------------------------ */
/* keccak-f[1600] + STROBE-128 + merlin (mirror crypto/merlin.py)      */

static const uint64_t KECCAK_RC[24] = {
    0x0000000000000001ULL, 0x0000000000008082ULL, 0x800000000000808AULL,
    0x8000000080008000ULL, 0x000000000000808BULL, 0x0000000080000001ULL,
    0x8000000080008081ULL, 0x8000000000008009ULL, 0x000000000000008AULL,
    0x0000000000000088ULL, 0x0000000080008009ULL, 0x000000008000000AULL,
    0x000000008000808BULL, 0x800000000000008BULL, 0x8000000000008089ULL,
    0x8000000000008003ULL, 0x8000000000008002ULL, 0x8000000000000080ULL,
    0x000000000000800AULL, 0x800000008000000AULL, 0x8000000080008081ULL,
    0x8000000000008080ULL, 0x0000000080000001ULL, 0x8000000080008008ULL,
};
static const int KECCAK_ROT[5][5] = {{0, 36, 3, 41, 18},
                                     {1, 44, 10, 45, 2},
                                     {62, 6, 43, 15, 61},
                                     {28, 55, 25, 21, 56},
                                     {27, 20, 39, 8, 14}};

static inline uint64_t rotl64(uint64_t v, int n) {
  return n ? (v << n) | (v >> (64 - n)) : v;
}

static void keccak_f1600(uint8_t st8[200]) {
  uint64_t a[5][5];
  for (int x = 0; x < 5; x++)
    for (int y = 0; y < 5; y++) {
      uint64_t w = 0;
      const uint8_t *p = st8 + 8 * (x + 5 * y);
      for (int j = 7; j >= 0; j--) w = (w << 8) | p[j];
      a[x][y] = w;
    }
  for (int rnd = 0; rnd < 24; rnd++) {
    uint64_t c[5], d[5], b[5][5];
    for (int x = 0; x < 5; x++)
      c[x] = a[x][0] ^ a[x][1] ^ a[x][2] ^ a[x][3] ^ a[x][4];
    for (int x = 0; x < 5; x++)
      d[x] = c[(x + 4) % 5] ^ rotl64(c[(x + 1) % 5], 1);
    for (int x = 0; x < 5; x++)
      for (int y = 0; y < 5; y++) a[x][y] ^= d[x];
    for (int x = 0; x < 5; x++)
      for (int y = 0; y < 5; y++)
        b[y][(2 * x + 3 * y) % 5] = rotl64(a[x][y], KECCAK_ROT[x][y]);
    for (int x = 0; x < 5; x++)
      for (int y = 0; y < 5; y++)
        a[x][y] = b[x][y] ^ (~b[(x + 1) % 5][y] & b[(x + 2) % 5][y]);
    a[0][0] ^= KECCAK_RC[rnd];
  }
  for (int x = 0; x < 5; x++)
    for (int y = 0; y < 5; y++) {
      uint8_t *p = st8 + 8 * (x + 5 * y);
      uint64_t w = a[x][y];
      for (int j = 0; j < 8; j++) p[j] = (uint8_t)(w >> (8 * j));
    }
}

#define STROBE_R 166
#define FLAG_I 1
#define FLAG_A 2
#define FLAG_C 4
#define FLAG_M 16
#define FLAG_K 32

typedef struct {
  uint8_t st[200];
  int pos, pos_begin;
} strobe;

static void strobe_run_f(strobe *s) {
  s->st[s->pos] ^= (uint8_t)s->pos_begin;
  s->st[s->pos + 1] ^= 0x04;
  s->st[STROBE_R + 1] ^= 0x80;
  keccak_f1600(s->st);
  s->pos = 0;
  s->pos_begin = 0;
}

static void strobe_absorb(strobe *s, const uint8_t *data, size_t n) {
  for (size_t i = 0; i < n; i++) {
    s->st[s->pos] ^= data[i];
    if (++s->pos == STROBE_R) strobe_run_f(s);
  }
}

static void strobe_squeeze(strobe *s, uint8_t *out, size_t n) {
  for (size_t i = 0; i < n; i++) {
    out[i] = s->st[s->pos];
    s->st[s->pos] = 0;
    if (++s->pos == STROBE_R) strobe_run_f(s);
  }
}

static void strobe_begin_op(strobe *s, uint8_t flags) {
  uint8_t hdr[2] = {(uint8_t)s->pos_begin, flags};
  s->pos_begin = s->pos + 1;
  strobe_absorb(s, hdr, 2);
  if ((flags & (FLAG_C | FLAG_K)) && s->pos != 0) strobe_run_f(s);
}

static void strobe_meta_ad(strobe *s, const uint8_t *d, size_t n, int more) {
  if (!more) strobe_begin_op(s, FLAG_M | FLAG_A);
  strobe_absorb(s, d, n);
}

static void strobe_ad(strobe *s, const uint8_t *d, size_t n) {
  strobe_begin_op(s, FLAG_A);
  strobe_absorb(s, d, n);
}

static void strobe_prf(strobe *s, uint8_t *out, size_t n) {
  strobe_begin_op(s, FLAG_I | FLAG_A | FLAG_C);
  strobe_squeeze(s, out, n);
}

static void strobe_init(strobe *s, const uint8_t *label, size_t n) {
  memset(s->st, 0, 200);
  const uint8_t hdr[6] = {1, STROBE_R + 2, 1, 0, 1, 96};
  memcpy(s->st, hdr, 6);
  memcpy(s->st + 6, "STROBEv1.0.2", 12);
  keccak_f1600(s->st);
  s->pos = 0;
  s->pos_begin = 0;
  strobe_meta_ad(s, label, n, 0);
}

/* merlin transcript append_message / challenge_bytes */
static void merlin_append(strobe *s, const char *label, const uint8_t *msg,
                          size_t n) {
  uint8_t len4[4] = {(uint8_t)n, (uint8_t)(n >> 8), (uint8_t)(n >> 16),
                     (uint8_t)(n >> 24)};
  strobe_meta_ad(s, (const uint8_t *)label, strlen(label), 0);
  strobe_meta_ad(s, len4, 4, 1);
  strobe_ad(s, msg, n);
}

static void merlin_challenge(strobe *s, const char *label, uint8_t *out,
                             size_t n) {
  uint8_t len4[4] = {(uint8_t)n, (uint8_t)(n >> 8), (uint8_t)(n >> 16),
                     (uint8_t)(n >> 24)};
  strobe_meta_ad(s, (const uint8_t *)label, strlen(label), 0);
  strobe_meta_ad(s, len4, 4, 1);
  strobe_prf(s, out, n);
}

/* ------------------------------------------------------------------ */
/* schnorrkel verification                                             */

/* 1 if ok, 0 otherwise (mirrors crypto/sr25519._sr25519_verify_py) */
int tm_sr25519_verify_one(const uint8_t pk[32], const uint8_t *msg,
                          int64_t msg_len, const uint8_t sig[64]) {
  if (!(sig[63] & 0x80)) return 0; /* schnorrkel marker bit */
  uint8_t s_bytes[32];
  memcpy(s_bytes, sig + 32, 32);
  s_bytes[31] &= 0x7F;
  /* s < L (little-endian compare) */
  for (int i = 31; i >= 0; i--) {
    if (s_bytes[i] != SC_L_BYTES[i]) {
      if (s_bytes[i] > SC_L_BYTES[i]) return 0;
      break;
    }
    if (i == 0) return 0; /* s == L */
  }
  pt A, R;
  if (!ristretto_decode(&A, pk)) return 0;
  if (!ristretto_decode(&R, sig)) return 0;
  /* transcript: SigningContext("substrate") -> Schnorr-sig protocol */
  strobe t;
  strobe_init(&t, (const uint8_t *)"Merlin v1.0", 11);
  merlin_append(&t, "dom-sep", (const uint8_t *)"SigningContext", 14);
  merlin_append(&t, "", (const uint8_t *)"substrate", 9);
  merlin_append(&t, "sign-bytes", msg, (size_t)msg_len);
  merlin_append(&t, "proto-name", (const uint8_t *)"Schnorr-sig", 11);
  merlin_append(&t, "sign:pk", pk, 32);
  merlin_append(&t, "sign:R", sig, 32);
  uint8_t wide[64];
  merlin_challenge(&t, "sign:c", wide, 64);
  uint64_t w8[8], k4[4];
  for (int i = 0; i < 8; i++) {
    uint64_t w = 0;
    for (int j = 7; j >= 0; j--) w = (w << 8) | wide[8 * i + j];
    w8[i] = w;
  }
  tm_mod_l_512(w8, k4);
  uint8_t k_bytes[32];
  for (int i = 0; i < 4; i++)
    for (int j = 0; j < 8; j++) k_bytes[8 * i + j] = (uint8_t)(k4[i] >> (8 * j));
  /* R == s*B - k*A */
  pt negA, rhs;
  pt_neg(&negA, &A);
  pt_double_scalar_mul_base(&rhs, s_bytes, &negA, k_bytes);
  uint8_t enc[32];
  ristretto_encode(enc, &rhs);
  return memcmp(enc, sig, 32) == 0;
}

typedef struct {
  const uint8_t *pks, *msgs, *sigs;
  const int64_t *moffs;
  int64_t lo, hi;
  uint8_t *out;
} sr_job;

static void *sr_worker(void *arg) {
  sr_job *j = (sr_job *)arg;
  for (int64_t i = j->lo; i < j->hi; i++) {
    j->out[i] = (uint8_t)tm_sr25519_verify_one(
        j->pks + 32 * i, j->msgs + j->moffs[i], j->moffs[i + 1] - j->moffs[i],
        j->sigs + 64 * i);
  }
  return 0;
}

void tm_sr25519_verify_batch(const uint8_t *pks, const uint8_t *msgs,
                             const int64_t *moffs, const uint8_t *sigs,
                             int64_t n, uint8_t *out, int nthreads) {
  if (nthreads < 1) nthreads = 1;
  if (nthreads > 16) nthreads = 16;
  if ((int64_t)nthreads > n) nthreads = (int)(n ? n : 1);
  sr_job jobs[16];
  pthread_t tids[16];
  int64_t per = (n + nthreads - 1) / nthreads;
  int used = 0;
  for (int t = 0; t < nthreads; t++) {
    int64_t lo = t * per, hi = lo + per > n ? n : lo + per;
    if (lo >= hi) break;
    jobs[t] = (sr_job){pks, msgs, sigs, moffs, lo, hi, out};
    used = t + 1;
  }
  for (int t = 0; t + 1 < used; t++) pthread_create(&tids[t], 0, sr_worker, &jobs[t]);
  if (used) sr_worker(&jobs[used - 1]);
  for (int t = 0; t + 1 < used; t++) pthread_join(tids[t], 0);
}
