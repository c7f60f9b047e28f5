/* Native host-prep kernels for the RLC batch-verification path.
 *
 * The port's own copy of tendermint_tpu/native/batchhost.c. It is built into
 * one shared object with sr25519.c, which calls tm_mod_l_512.
 *
 * The reference implementation's hot loop is a serial per-validator
 * VerifySignature (reference: types/validator_set.go:680-702); this
 * framework moves the curve math to the GPU (ops/msm_torch.py) but the
 * HOST side of each batch still has O(N) work:
 *   1. the Ed25519 challenge hash  h_i = SHA-512(R_i || A_i || M_i) mod L
 *   2. the RLC scalar math         w_i = z_i h_i mod 8L,  u = sum z_i s_i mod L
 *   3. per-window counting sort of the scalar digits (Pippenger prep)
 * In Python these cost ~60 + ~50 + ~48 ms at 10k validators (PERF.md) —
 * more than the device kernel itself. This file implements all three as
 * multithreaded C (pthreads), driven via ctypes (native/__init__.py).
 *
 * SHA-512 per FIPS 180-4; round/IV constants are generated at build time
 * (native/__init__.py) from their definitions (fractional parts of cube/square
 * roots of the first primes), not copied from any implementation.
 *
 * Scalar arithmetic: 64-bit limbs with __uint128_t products. The curve
 * order is L = 2^252 + C (C ~ 2^124.4); reductions use the standard fold
 *   2^252 === -C (mod L)      and      2^255 === -8C (mod 8L)
 * with non-negative fix-up by adding known multiples of the modulus.
 */

#include <pthread.h>
#include <stdint.h>
#include <string.h>

#include "sha512_constants.h" /* generated: SHA512_K[80], SHA512_IV[8] */

/* ------------------------------------------------------------------ */
/* SHA-512 core                                                        */

typedef struct {
  uint64_t h[8];
} sha512_state;

static inline uint64_t rotr64(uint64_t x, int n) {
  return (x >> n) | (x << (64 - n));
}

static void sha512_block(sha512_state *st, const uint8_t *p) {
  uint64_t w[80];
  for (int t = 0; t < 16; t++) {
    w[t] = ((uint64_t)p[t * 8] << 56) | ((uint64_t)p[t * 8 + 1] << 48) |
           ((uint64_t)p[t * 8 + 2] << 40) | ((uint64_t)p[t * 8 + 3] << 32) |
           ((uint64_t)p[t * 8 + 4] << 24) | ((uint64_t)p[t * 8 + 5] << 16) |
           ((uint64_t)p[t * 8 + 6] << 8) | (uint64_t)p[t * 8 + 7];
  }
  for (int t = 16; t < 80; t++) {
    uint64_t s0 = rotr64(w[t - 15], 1) ^ rotr64(w[t - 15], 8) ^ (w[t - 15] >> 7);
    uint64_t s1 = rotr64(w[t - 2], 19) ^ rotr64(w[t - 2], 61) ^ (w[t - 2] >> 6);
    w[t] = w[t - 16] + s0 + w[t - 7] + s1;
  }
  uint64_t a = st->h[0], b = st->h[1], c = st->h[2], d = st->h[3];
  uint64_t e = st->h[4], f = st->h[5], g = st->h[6], h = st->h[7];
  for (int t = 0; t < 80; t++) {
    uint64_t S1 = rotr64(e, 14) ^ rotr64(e, 18) ^ rotr64(e, 41);
    uint64_t ch = (e & f) ^ (~e & g);
    uint64_t t1 = h + S1 + ch + SHA512_K[t] + w[t];
    uint64_t S0 = rotr64(a, 28) ^ rotr64(a, 34) ^ rotr64(a, 39);
    uint64_t maj = (a & b) ^ (a & c) ^ (b & c);
    uint64_t t2 = S0 + maj;
    h = g; g = f; f = e; e = d + t1;
    d = c; c = b; b = a; a = t1 + t2;
  }
  st->h[0] += a; st->h[1] += b; st->h[2] += c; st->h[3] += d;
  st->h[4] += e; st->h[5] += f; st->h[6] += g; st->h[7] += h;
}

/* SHA-512 of (part1 || part2 || part3); out = 64 bytes big-endian digest. */
static void sha512_3(const uint8_t *p1, size_t n1, const uint8_t *p2, size_t n2,
                     const uint8_t *p3, size_t n3, uint8_t *out) {
  sha512_state st;
  for (int i = 0; i < 8; i++) st.h[i] = SHA512_IV[i];
  uint8_t buf[128];
  size_t fill = 0;
  uint64_t total = 0;
  const uint8_t *parts[3] = {p1, p2, p3};
  size_t lens[3] = {n1, n2, n3};
  for (int k = 0; k < 3; k++) {
    const uint8_t *p = parts[k];
    size_t n = lens[k];
    total += n;
    while (n) {
      if (fill == 0 && n >= 128) {
        sha512_block(&st, p);
        p += 128;
        n -= 128;
        continue;
      }
      size_t take = 128 - fill;
      if (take > n) take = n;
      memcpy(buf + fill, p, take);
      fill += take;
      p += take;
      n -= take;
      if (fill == 128) {
        sha512_block(&st, buf);
        fill = 0;
      }
    }
  }
  /* padding: 0x80, zeros, 128-bit big-endian bit length */
  buf[fill++] = 0x80;
  if (fill > 112) {
    memset(buf + fill, 0, 128 - fill);
    sha512_block(&st, buf);
    fill = 0;
  }
  memset(buf + fill, 0, 112 - fill);
  uint64_t bits = total * 8; /* < 2^64: messages here are tiny */
  memset(buf + 112, 0, 8);
  for (int i = 0; i < 8; i++) buf[120 + i] = (uint8_t)(bits >> (56 - 8 * i));
  sha512_block(&st, buf);
  for (int i = 0; i < 8; i++)
    for (int j = 0; j < 8; j++) out[i * 8 + j] = (uint8_t)(st.h[i] >> (56 - 8 * j));
}

/* ------------------------------------------------------------------ */
/* 64-bit-limb scalar arithmetic mod L and mod 8L                      */

/* L = 2^252 + C, C = 0x14DEF9DEA2F79CD6_5812631A5CF5D3ED */
static const uint64_t C_LO = 0x5812631A5CF5D3EDULL;
static const uint64_t C_HI = 0x14DEF9DEA2F79CD6ULL;
static const uint64_t L_LIMBS[4] = {0x5812631A5CF5D3EDULL, 0x14DEF9DEA2F79CD6ULL,
                                    0ULL, 0x1000000000000000ULL};
/* 8C = C << 3 (fits 128 bits: C < 2^125) */
static const uint64_t C8_LO = 0x5812631A5CF5D3EDULL << 3;
static const uint64_t C8_HI = (0x14DEF9DEA2F79CD6ULL << 3) | (0x5812631A5CF5D3EDULL >> 61);
/* 8L = 2^255 + 8C */
static const uint64_t L8_LIMBS[4] = {(0x5812631A5CF5D3EDULL << 3),
                                     (0x14DEF9DEA2F79CD6ULL << 3) |
                                         (0x5812631A5CF5D3EDULL >> 61),
                                     0ULL, 0x8000000000000000ULL};
/* 4L (for non-negative fold fix-up), 5 limbs */
static const uint64_t L4_LIMBS[5] = {0x5812631A5CF5D3EDULL << 2,
                                     (0x14DEF9DEA2F79CD6ULL << 2) |
                                         (0x5812631A5CF5D3EDULL >> 62),
                                     0ULL, 0x4000000000000000ULL, 0ULL};

typedef unsigned __int128 u128;

/* r[0..na+1] = a[0..na-1] * (hi:lo)   (128-bit multiplier, schoolbook) */
static void mul_by_c128(const uint64_t *a, int na, uint64_t chi, uint64_t clo,
                        uint64_t *r, int nr) {
  for (int i = 0; i < nr; i++) r[i] = 0;
  u128 carry = 0;
  for (int i = 0; i < na; i++) {
    u128 t = (u128)a[i] * clo + r[i] + carry;
    r[i] = (uint64_t)t;
    carry = t >> 64;
  }
  if (na < nr) r[na] = (uint64_t)carry;
  carry = 0;
  for (int i = 0; i < na && i + 1 < nr; i++) {
    u128 t = (u128)a[i] * chi + r[i + 1] + carry;
    r[i + 1] = (uint64_t)t;
    carry = t >> 64;
  }
  if (na + 2 <= nr) r[na + 1] += (uint64_t)carry;
}

/* x >>= k (k < 64), n limbs */
static void shr_limbs(const uint64_t *x, int n, int k, uint64_t *r) {
  for (int i = 0; i < n; i++) {
    uint64_t lo = x[i] >> k;
    uint64_t hi = (k && i + 1 < n) ? (x[i + 1] << (64 - k)) : 0;
    r[i] = lo | hi;
  }
}

static int geq(const uint64_t *a, const uint64_t *b, int n) {
  for (int i = n - 1; i >= 0; i--) {
    if (a[i] != b[i]) return a[i] > b[i];
  }
  return 1;
}

static void sub_limbs(uint64_t *a, const uint64_t *b, int n) {
  uint64_t borrow = 0;
  for (int i = 0; i < n; i++) {
    uint64_t bi = b[i] + borrow;
    uint64_t nb = (bi < borrow) || (a[i] < bi);
    a[i] = a[i] - bi;
    borrow = nb;
  }
}

static void add_limbs(uint64_t *a, const uint64_t *b, int n) {
  uint64_t carry = 0;
  for (int i = 0; i < n; i++) {
    uint64_t s = a[i] + carry;
    carry = s < carry;
    uint64_t t = s + b[i];
    carry += t < s;
    a[i] = t;
  }
}

/* X (8 limbs, < 2^512) mod L -> r (4 limbs).
 * Fold 2^252 === -C three times, then fix up with +2*4L and subtract L. */
void tm_mod_l_512(const uint64_t *x, uint64_t *r) {
  /* hi2 needs 4 limbs: shr_limbs(a1+3, 4, ...) writes 4 (the top one is
   * always 0 since a1 < 2^385, but the WRITE happens regardless). */
  uint64_t hi1[5], lo1[4], a1[7], hi2[4], lo2[4], a2[5], lo3[4], a3[3];
  /* hi1 = x >> 252: shift right 3 limbs then 60 bits -> 5 limbs */
  shr_limbs(x + 3, 5, 60, hi1);
  for (int i = 0; i < 4; i++) lo1[i] = x[i];
  lo1[3] &= 0x0FFFFFFFFFFFFFFFULL;
  mul_by_c128(hi1, 5, C_HI, C_LO, a1, 7); /* a1 < 2^385 */
  shr_limbs(a1 + 3, 4, 60, hi2);          /* hi2 = a1 >> 252, < 2^133 */
  uint64_t hi2_3[3] = {hi2[0], hi2[1], hi2[2]};
  for (int i = 0; i < 4; i++) lo2[i] = a1[i];
  lo2[3] &= 0x0FFFFFFFFFFFFFFFULL;
  mul_by_c128(hi2_3, 3, C_HI, C_LO, a2, 5); /* a2 < 2^258 */
  uint64_t hi3 = (a2[3] >> 60) | (a2[4] << 4); /* a2 >> 252, < 2^6 */
  for (int i = 0; i < 4; i++) lo3[i] = a2[i];
  lo3[3] &= 0x0FFFFFFFFFFFFFFFULL;
  uint64_t hi3_1[1] = {hi3};
  mul_by_c128(hi3_1, 1, C_HI, C_LO, a3, 3); /* a3 < 2^131 */
  /* S = lo1 + lo3 + 2*4L - lo2 - a3  (all non-negative, < 2^257) */
  uint64_t s[5] = {lo1[0], lo1[1], lo1[2], lo1[3], 0};
  uint64_t lo3_5[5] = {lo3[0], lo3[1], lo3[2], lo3[3], 0};
  add_limbs(s, lo3_5, 5);
  add_limbs(s, L4_LIMBS, 5);
  add_limbs(s, L4_LIMBS, 5);
  uint64_t lo2_5[5] = {lo2[0], lo2[1], lo2[2], lo2[3], 0};
  sub_limbs(s, lo2_5, 5);
  uint64_t a3_5[5] = {a3[0], a3[1], a3[2], 0, 0};
  sub_limbs(s, a3_5, 5);
  uint64_t l5[5] = {L_LIMBS[0], L_LIMBS[1], L_LIMBS[2], L_LIMBS[3], 0};
  while (geq(s, l5, 5)) sub_limbs(s, l5, 5);
  for (int i = 0; i < 4; i++) r[i] = s[i];
}

/* X (6 limbs, < 2^380) mod 8L -> r (4 limbs). One fold of 2^255 === -8C. */
static void mod_8l_384(const uint64_t *x, uint64_t *r) {
  uint64_t hi1[3], lo1[4], a1[5];
  shr_limbs(x + 3, 3, 63, hi1); /* x >> 255, < 2^125 */
  for (int i = 0; i < 4; i++) lo1[i] = x[i];
  lo1[3] &= 0x7FFFFFFFFFFFFFFFULL;
  mul_by_c128(hi1, 3, C8_HI, C8_LO, a1, 5); /* < 2^253 */
  /* S = lo1 + 8L - a1 */
  uint64_t s[5] = {lo1[0], lo1[1], lo1[2], lo1[3], 0};
  uint64_t l8_5[5] = {L8_LIMBS[0], L8_LIMBS[1], L8_LIMBS[2], L8_LIMBS[3], 0};
  add_limbs(s, l8_5, 5);
  uint64_t a1_5[5] = {a1[0], a1[1], a1[2], a1[3], a1[4]};
  sub_limbs(s, a1_5, 5);
  while (geq(s, l8_5, 5)) sub_limbs(s, l8_5, 5);
  for (int i = 0; i < 4; i++) r[i] = s[i];
}

static void load_le(const uint8_t *p, int nbytes, uint64_t *limbs, int nlimbs) {
  for (int i = 0; i < nlimbs; i++) limbs[i] = 0;
  for (int i = 0; i < nbytes; i++) limbs[i / 8] |= (uint64_t)p[i] << (8 * (i % 8));
}

static void store_le(const uint64_t *limbs, int nlimbs, uint8_t *p, int nbytes) {
  for (int i = 0; i < nbytes; i++) p[i] = (uint8_t)(limbs[i / 8] >> (8 * (i % 8)));
}

/* ------------------------------------------------------------------ */
/* Persistent prep pool (ISSUE 18)                                     */
/*
 * Per-call pthread_create/join costs ~50-100 us per thread — noise on a
 * 10k-row hash pass but real on the striped pipeline where prep runs as
 * many small slices per flush. The pool keeps `target - 1` workers parked
 * on a condvar; a driver hands them the SAME job array the per-call path
 * would have spawned threads for, so outputs are byte-identical by
 * construction (jobs are fixed row/window slices; the only cross-thread
 * accumulation, the scalar acc, is summed in job order by the caller).
 *
 * pool_run is non-reentrant by design: a second concurrent driver call
 * (the Python prep pool hashing while the dispatch thread sorts) sees the
 * pool busy and falls back to per-call threads. Nothing blocks, nothing
 * wedges.
 */

typedef void *(*pool_fn)(void *);

static pthread_mutex_t pool_mu = PTHREAD_MUTEX_INITIALIZER;
static pthread_cond_t pool_go = PTHREAD_COND_INITIALIZER;
static pthread_cond_t pool_done = PTHREAD_COND_INITIALIZER;
static pthread_t pool_tids[64];
static int pool_workers = 0; /* spawned workers; pool size = this + 1 */
static int pool_shutdown = 0;
static uint64_t pool_gen = 0;
static pool_fn pool_job_fn = 0;
static char *pool_jobs = 0;
static size_t pool_job_size = 0;
static int pool_njobs = 0;
static int pool_next = 0;
static int pool_remaining = 0;

/* claim-and-run loop shared by workers and the submitting caller;
 * pool_mu held on entry and exit. */
static void pool_drain(pool_fn fn, char *jobs, size_t job_size) {
  while (pool_next < pool_njobs) {
    int idx = pool_next++;
    pthread_mutex_unlock(&pool_mu);
    fn(jobs + (size_t)idx * job_size);
    pthread_mutex_lock(&pool_mu);
    if (--pool_remaining == 0) pthread_cond_broadcast(&pool_done);
  }
}

static void *pool_worker_main(void *arg) {
  (void)arg;
  uint64_t seen = 0;
  pthread_mutex_lock(&pool_mu);
  for (;;) {
    while (!pool_shutdown && pool_gen == seen)
      pthread_cond_wait(&pool_go, &pool_mu);
    if (pool_shutdown) break;
    seen = pool_gen;
    pool_drain(pool_job_fn, pool_jobs, pool_job_size);
  }
  pthread_mutex_unlock(&pool_mu);
  return 0;
}

/* Run njobs jobs on the pool (caller participates). Returns 1 when the
 * pool ran them, 0 when the pool is absent/busy (caller must fall back
 * to per-call threads). */
static int pool_run(pool_fn fn, void *jobs, size_t job_size, int njobs) {
  pthread_mutex_lock(&pool_mu);
  if (pool_workers == 0 || pool_job_fn != 0) {
    pthread_mutex_unlock(&pool_mu);
    return 0;
  }
  pool_job_fn = fn;
  pool_jobs = (char *)jobs;
  pool_job_size = job_size;
  pool_njobs = njobs;
  pool_next = 0;
  pool_remaining = njobs;
  pool_gen++;
  pthread_cond_broadcast(&pool_go);
  pool_drain(fn, (char *)jobs, job_size);
  while (pool_remaining > 0) pthread_cond_wait(&pool_done, &pool_mu);
  pool_job_fn = 0;
  pthread_mutex_unlock(&pool_mu);
  return 1;
}

/* (Re)size the pool to `nthreads` total participants (caller included):
 * spawns nthreads-1 parked workers. nthreads <= 1 tears the pool down
 * (drivers go back to per-call threads / inline serial). Returns the
 * effective pool size, or -1 when a resize raced a running job. */
int tm_prep_pool_configure(int nthreads) {
  if (nthreads < 1) nthreads = 1;
  if (nthreads > 64) nthreads = 64;
  int want = nthreads - 1;
  pthread_mutex_lock(&pool_mu);
  if (pool_job_fn != 0) {
    pthread_mutex_unlock(&pool_mu);
    return -1;
  }
  if (want == pool_workers) {
    pthread_mutex_unlock(&pool_mu);
    return pool_workers + 1;
  }
  if (pool_workers > 0) {
    int old = pool_workers;
    pool_shutdown = 1;
    pthread_cond_broadcast(&pool_go);
    pthread_mutex_unlock(&pool_mu);
    for (int t = 0; t < old; t++) pthread_join(pool_tids[t], 0);
    pthread_mutex_lock(&pool_mu);
    pool_shutdown = 0;
    pool_workers = 0;
  }
  for (int t = 0; t < want; t++) {
    if (pthread_create(&pool_tids[t], 0, pool_worker_main, 0) != 0) break;
    pool_workers = t + 1;
  }
  int got = pool_workers + 1;
  pthread_mutex_unlock(&pool_mu);
  return got;
}

int tm_prep_pool_size(void) {
  pthread_mutex_lock(&pool_mu);
  int s = pool_workers + 1;
  pthread_mutex_unlock(&pool_mu);
  return s;
}

/* Dispatch `used` jobs: pool when available, else per-call threads with
 * the last chunk inline (the pre-pool path, kept as fallback). */
static void run_jobs(pool_fn fn, void *jobs, size_t job_size, int used,
                     pthread_t *tids) {
  if (used <= 0) return;
  if (used > 1 && pool_run(fn, jobs, job_size, used)) return;
  char *base = (char *)jobs;
  for (int t = 0; t + 1 < used; t++)
    pthread_create(&tids[t], 0, fn, base + (size_t)t * job_size);
  fn(base + (size_t)(used - 1) * job_size); /* run the last chunk inline */
  for (int t = 0; t + 1 < used; t++) pthread_join(tids[t], 0);
}

/* ------------------------------------------------------------------ */
/* Threaded drivers                                                    */

typedef struct {
  const uint8_t *sigs;   /* n*64 */
  const uint8_t *pks;    /* n*32 */
  const uint8_t *msgs;   /* concatenated */
  const int64_t *moffs;  /* n+1 */
  uint8_t *out;          /* n*32: h mod L, little-endian */
  int64_t lo, hi;
} hash_job;

static void *hash_worker(void *arg) {
  hash_job *j = (hash_job *)arg;
  uint8_t digest[64];
  uint64_t x[8], r[4];
  for (int64_t i = j->lo; i < j->hi; i++) {
    sha512_3(j->sigs + 64 * i, 32, j->pks + 32 * i, 32, j->msgs + j->moffs[i],
             (size_t)(j->moffs[i + 1] - j->moffs[i]), digest);
    load_le(digest, 64, x, 8);
    tm_mod_l_512(x, r);
    store_le(r, 4, j->out + 32 * i, 32);
  }
  return 0;
}

/* h_i = SHA-512(R_i || A_i || M_i) mod L, little-endian 32 bytes per row. */
void tm_ed25519_h_batch(const uint8_t *sigs, const uint8_t *pks,
                        const uint8_t *msgs, const int64_t *moffs, int64_t n,
                        uint8_t *out, int nthreads) {
  if (nthreads < 1) nthreads = 1;
  if (nthreads > 64) nthreads = 64;
  if (n < 512) nthreads = 1;
  pthread_t tids[64];
  hash_job jobs[64];
  int64_t chunk = (n + nthreads - 1) / nthreads;
  int used = 0;
  for (int t = 0; t < nthreads; t++) {
    int64_t lo = t * chunk, hi = lo + chunk;
    if (lo >= n) break;
    if (hi > n) hi = n;
    jobs[t] = (hash_job){sigs, pks, msgs, moffs, out, lo, hi};
    used = t + 1;
    if (hi == n) break;
  }
  run_jobs(hash_worker, jobs, sizeof(hash_job), used, tids);
}

typedef struct {
  const uint8_t *z;  /* n*16 LE (0 => excluded row) */
  const uint8_t *h;  /* n*32 LE */
  const uint8_t *s;  /* n*32 LE */
  uint8_t *w;        /* n*32 LE out */
  uint64_t acc[8];   /* per-thread partial sum of z*s */
  int64_t lo, hi;
} scalar_job;

static void *scalar_worker(void *arg) {
  scalar_job *j = (scalar_job *)arg;
  uint64_t z[2], h[4], s[4], prod[6], w[4];
  for (int i = 0; i < 8; i++) j->acc[i] = 0;
  for (int64_t i = j->lo; i < j->hi; i++) {
    load_le(j->z + 16 * i, 16, z, 2);
    if ((z[0] | z[1]) == 0) {
      memset(j->w + 32 * i, 0, 32);
      continue;
    }
    load_le(j->h + 32 * i, 32, h, 4);
    load_le(j->s + 32 * i, 32, s, 4);
    /* prod = z * h  (128 x 253 -> < 2^380, 6 limbs) */
    mul_by_c128(h, 4, z[1], z[0], prod, 6);
    mod_8l_384(prod, w);
    store_le(w, 4, j->w + 32 * i, 32);
    /* acc += z * s  (< 2^380 each; n <= 2^17 keeps acc < 2^398) */
    mul_by_c128(s, 4, z[1], z[0], prod, 6);
    uint64_t p8[8] = {prod[0], prod[1], prod[2], prod[3], prod[4], prod[5], 0, 0};
    add_limbs(j->acc, p8, 8);
  }
  return 0;
}

/* w_i = z_i * h_i mod 8L; u = sum_i z_i * s_i mod L (32-byte LE out). */
void tm_rlc_scalars(const uint8_t *z, const uint8_t *h, const uint8_t *s,
                    int64_t n, uint8_t *w_out, uint8_t *u_out, int nthreads) {
  if (nthreads < 1) nthreads = 1;
  if (nthreads > 64) nthreads = 64;
  if (n < 512) nthreads = 1;
  pthread_t tids[64];
  scalar_job jobs[64];
  int64_t chunk = (n + nthreads - 1) / nthreads;
  int used = 0;
  for (int t = 0; t < nthreads; t++) {
    int64_t lo = t * chunk, hi = lo + chunk;
    if (lo >= n) break;
    if (hi > n) hi = n;
    jobs[t] = (scalar_job){z, h, s, w_out, {0}, lo, hi};
    used = t + 1;
    if (hi == n) break;
  }
  run_jobs(scalar_worker, jobs, sizeof(scalar_job), used, tids);
  uint64_t total[8] = {0};
  for (int t = 0; t < used; t++) add_limbs(total, jobs[t].acc, 8);
  uint64_t u[4];
  tm_mod_l_512(total, u);
  store_le(u, 4, u_out, 32);
}

/* ------------------------------------------------------------------ */
/* Per-window counting sort (Pippenger prep)                           */

typedef struct {
  const uint8_t *digits; /* n rows x 32 windows, row-major */
  int64_t n;
  int32_t *perm;  /* 32 x n, window-major */
  int32_t *ends;  /* 32 x 256 */
  int w_lo, w_hi;
  int64_t zero16_from; /* rows >= this have digit 0 in windows 16-31
                          (RLC layout: the z-lane scalars are 128-bit);
                          0 disables the shortcut */
} sort_job;

static void *sort_worker(void *arg) {
  sort_job *j = (sort_job *)arg;
  int64_t n = j->n;
  for (int w = j->w_lo; w < j->w_hi; w++) {
    /* rows >= zlim are known-zero for this window: skip their count pass
     * and digit lookups; in the stable order they form the TAIL of bucket
     * 0 (prefix zero-digit rows come first — lower row index), so they
     * are appended sequentially after the prefix placement. */
    int64_t zlim =
        (j->zero16_from > 0 && w >= 16 && j->zero16_from < n) ? j->zero16_from
                                                              : n;
    int32_t counts[256];
    memset(counts, 0, sizeof(counts));
    const uint8_t *col = j->digits + w;
    for (int64_t i = 0; i < zlim; i++) counts[col[i * 32]]++;
    counts[0] += (int32_t)(n - zlim);
    int32_t start[256];
    int32_t acc = 0;
    for (int v = 0; v < 256; v++) {
      start[v] = acc;
      acc += counts[v];
      j->ends[w * 256 + v] = acc;
    }
    int32_t *p = j->perm + (int64_t)w * n;
    /* bucket 0's suffix region: reserve it BEHIND the prefix zeros */
    int64_t n_suffix = n - zlim;
    int32_t suffix_at = start[0] + (int32_t)(counts[0] - (int32_t)n_suffix);
    for (int64_t i = 0; i < zlim; i++) p[start[col[i * 32]]++] = (int32_t)i;
    for (int64_t i = zlim; i < n; i++) p[suffix_at++] = (int32_t)i;
  }
  return 0;
}

/* digits: (n, 32) uint8 row-major -> perm (32, n) int32 (stable order),
 * ends (32, 256) int32 inclusive bucket boundaries. zero16_from > 0
 * promises rows >= it are zero in windows 16-31 (RLC z-lane layout). */
void tm_sort_windows(const uint8_t *digits, int64_t n, int32_t *perm,
                     int32_t *ends, int nthreads, int64_t zero16_from) {
  if (nthreads < 1) nthreads = 1;
  if (nthreads > 32) nthreads = 32;
  pthread_t tids[32];
  sort_job jobs[32];
  int per = (32 + nthreads - 1) / nthreads;
  int used = 0;
  for (int t = 0; t < nthreads; t++) {
    int lo = t * per, hi = lo + per;
    if (lo >= 32) break;
    if (hi > 32) hi = 32;
    jobs[t] = (sort_job){digits, n, perm, ends, lo, hi, zero16_from};
    used = t + 1;
    if (hi == 32) break;
  }
  run_jobs(sort_worker, jobs, sizeof(sort_job), used, tids);
}

