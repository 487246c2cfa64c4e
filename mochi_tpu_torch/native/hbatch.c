/* Batched Ed25519 host engine: challenge scalars AND full verification.
 *
 * 1. h_batch — h_i = SHA-512(R_i || A_i || M_i) mod L, the per-item
 *    half of the device verifier's host prepare
 *    (crypto/batch_verify.prepare_packed): one C call over the whole batch
 *    in place of a per-item hashlib call, Python-bignum mod-L and
 *    to_bytes.
 *
 * 2. verify_batch — the full cofactorless check [S]B == R + [h]A on the
 *    host, evaluated as [S]B + [h](-A) == R with a shared-doubling Straus
 *    ladder over 4-bit windows.  This is the native-C engine behind
 *    crypto/keys.verify on hosts without the `cryptography` (OpenSSL)
 *    wheel, verdict-identical to the pure-Python engine
 *    (crypto/hostfallback.py) and to the device kernels: forgeries,
 *    non-canonical encodings, low-order points and x = 0 with the sign
 *    bit all agree (tests/test_torch_native.py).
 *
 * 3. sign_prepared — deterministic RFC 8032 signing, byte-identical to the
 *    pure-Python signer; x25519 — RFC 7748 X25519.
 *
 * Field arithmetic: GF(2^255-19) on 4x64-bit limbs with unsigned
 * __int128 products, values kept mod 2^256 (2^256 = 2p + 38, so a
 * lazy representation folds overflow as +38) and fully reduced only at
 * fe_tobytes.  Group law: the SAME complete unified addition
 * (add-2008-hwcd-3, a=-1) the device kernels and the pure-Python
 * fallback use — doubling runs through it too, so the C verdict can
 * never diverge on an exceptional point pair.
 *
 * Self-contained: SHA-512 per FIPS 180-4 (differentially tested against
 * hashlib) and a Barrett reduction mod the Ed25519 group order
 * L = 2^252 + 27742317777372353535851937790883648493.  No libcrypto
 * dependency.
 *
 * Build: mochi_tpu_torch/native/__init__.py compiles this at first use
 * (same model as mcode.c); the pure-Python paths are the fallback.
 */

#define PY_SSIZE_T_CLEAN
#include <Python.h>
#include <stdint.h>
#include <string.h>

/* ------------------------------------------------------------- SHA-512 */

static const uint64_t K[80] = {
    0x428a2f98d728ae22ULL, 0x7137449123ef65cdULL, 0xb5c0fbcfec4d3b2fULL, 0xe9b5dba58189dbbcULL,
    0x3956c25bf348b538ULL, 0x59f111f1b605d019ULL, 0x923f82a4af194f9bULL, 0xab1c5ed5da6d8118ULL,
    0xd807aa98a3030242ULL, 0x12835b0145706fbeULL, 0x243185be4ee4b28cULL, 0x550c7dc3d5ffb4e2ULL,
    0x72be5d74f27b896fULL, 0x80deb1fe3b1696b1ULL, 0x9bdc06a725c71235ULL, 0xc19bf174cf692694ULL,
    0xe49b69c19ef14ad2ULL, 0xefbe4786384f25e3ULL, 0x0fc19dc68b8cd5b5ULL, 0x240ca1cc77ac9c65ULL,
    0x2de92c6f592b0275ULL, 0x4a7484aa6ea6e483ULL, 0x5cb0a9dcbd41fbd4ULL, 0x76f988da831153b5ULL,
    0x983e5152ee66dfabULL, 0xa831c66d2db43210ULL, 0xb00327c898fb213fULL, 0xbf597fc7beef0ee4ULL,
    0xc6e00bf33da88fc2ULL, 0xd5a79147930aa725ULL, 0x06ca6351e003826fULL, 0x142929670a0e6e70ULL,
    0x27b70a8546d22ffcULL, 0x2e1b21385c26c926ULL, 0x4d2c6dfc5ac42aedULL, 0x53380d139d95b3dfULL,
    0x650a73548baf63deULL, 0x766a0abb3c77b2a8ULL, 0x81c2c92e47edaee6ULL, 0x92722c851482353bULL,
    0xa2bfe8a14cf10364ULL, 0xa81a664bbc423001ULL, 0xc24b8b70d0f89791ULL, 0xc76c51a30654be30ULL,
    0xd192e819d6ef5218ULL, 0xd69906245565a910ULL, 0xf40e35855771202aULL, 0x106aa07032bbd1b8ULL,
    0x19a4c116b8d2d0c8ULL, 0x1e376c085141ab53ULL, 0x2748774cdf8eeb99ULL, 0x34b0bcb5e19b48a8ULL,
    0x391c0cb3c5c95a63ULL, 0x4ed8aa4ae3418acbULL, 0x5b9cca4f7763e373ULL, 0x682e6ff3d6b2b8a3ULL,
    0x748f82ee5defb2fcULL, 0x78a5636f43172f60ULL, 0x84c87814a1f0ab72ULL, 0x8cc702081a6439ecULL,
    0x90befffa23631e28ULL, 0xa4506cebde82bde9ULL, 0xbef9a3f7b2c67915ULL, 0xc67178f2e372532bULL,
    0xca273eceea26619cULL, 0xd186b8c721c0c207ULL, 0xeada7dd6cde0eb1eULL, 0xf57d4f7fee6ed178ULL,
    0x06f067aa72176fbaULL, 0x0a637dc5a2c898a6ULL, 0x113f9804bef90daeULL, 0x1b710b35131c471bULL,
    0x28db77f523047d84ULL, 0x32caab7b40c72493ULL, 0x3c9ebe0a15c9bebcULL, 0x431d67c49c100d4cULL,
    0x4cc5d4becb3e42b6ULL, 0x597f299cfc657e2aULL, 0x5fcb6fab3ad6faecULL, 0x6c44198c4a475817ULL,
};
static const uint64_t H0[8] = {
    0x6a09e667f3bcc908ULL, 0xbb67ae8584caa73bULL, 0x3c6ef372fe94f82bULL, 0xa54ff53a5f1d36f1ULL,
    0x510e527fade682d1ULL, 0x9b05688c2b3e6c1fULL, 0x1f83d9abfb41bd6bULL, 0x5be0cd19137e2179ULL,
};

#define ROTR(x, n) (((x) >> (n)) | ((x) << (64 - (n))))

static void sha512_compress(uint64_t st[8], const uint8_t block[128]) {
    uint64_t w[80];
    for (int t = 0; t < 16; t++) {
        const uint8_t *p = block + 8 * t;
        w[t] = ((uint64_t)p[0] << 56) | ((uint64_t)p[1] << 48) |
               ((uint64_t)p[2] << 40) | ((uint64_t)p[3] << 32) |
               ((uint64_t)p[4] << 24) | ((uint64_t)p[5] << 16) |
               ((uint64_t)p[6] << 8) | (uint64_t)p[7];
    }
    for (int t = 16; t < 80; t++) {
        uint64_t s0 = ROTR(w[t - 15], 1) ^ ROTR(w[t - 15], 8) ^ (w[t - 15] >> 7);
        uint64_t s1 = ROTR(w[t - 2], 19) ^ ROTR(w[t - 2], 61) ^ (w[t - 2] >> 6);
        w[t] = w[t - 16] + s0 + w[t - 7] + s1;
    }
    uint64_t a = st[0], b = st[1], c = st[2], d = st[3];
    uint64_t e = st[4], f = st[5], g = st[6], h = st[7];
    for (int t = 0; t < 80; t++) {
        uint64_t S1 = ROTR(e, 14) ^ ROTR(e, 18) ^ ROTR(e, 41);
        uint64_t ch = (e & f) ^ (~e & g);
        uint64_t t1 = h + S1 + ch + K[t] + w[t];
        uint64_t S0 = ROTR(a, 28) ^ ROTR(a, 34) ^ ROTR(a, 39);
        uint64_t maj = (a & b) ^ (a & c) ^ (b & c);
        uint64_t t2 = S0 + maj;
        h = g; g = f; f = e; e = d + t1;
        d = c; c = b; b = a; a = t1 + t2;
    }
    st[0] += a; st[1] += b; st[2] += c; st[3] += d;
    st[4] += e; st[5] += f; st[6] += g; st[7] += h;
}

/* Streaming SHA-512 over (R || A || M) without concatenating on the heap. */
typedef struct {
    uint64_t st[8];
    uint8_t buf[128];
    size_t buflen;
    uint64_t total;
} sha512_ctx;

static void sha512_init(sha512_ctx *c) {
    memcpy(c->st, H0, sizeof(H0));
    c->buflen = 0;
    c->total = 0;
}

static void sha512_update(sha512_ctx *c, const uint8_t *data, size_t len) {
    c->total += len;
    if (c->buflen) {
        size_t take = 128 - c->buflen;
        if (take > len) take = len;
        memcpy(c->buf + c->buflen, data, take);
        c->buflen += take;
        data += take;
        len -= take;
        if (c->buflen == 128) {
            sha512_compress(c->st, c->buf);
            c->buflen = 0;
        }
    }
    while (len >= 128) {
        sha512_compress(c->st, data);
        data += 128;
        len -= 128;
    }
    if (len) {
        memcpy(c->buf, data, len);
        c->buflen = len;
    }
}

static void sha512_final(sha512_ctx *c, uint8_t out[64]) {
    uint64_t bits = c->total * 8;
    c->buf[c->buflen++] = 0x80;
    if (c->buflen > 112) {
        memset(c->buf + c->buflen, 0, 128 - c->buflen);
        sha512_compress(c->st, c->buf);
        c->buflen = 0;
    }
    memset(c->buf + c->buflen, 0, 128 - c->buflen);
    /* 128-bit big-endian length; messages here are far below 2^64 bits */
    for (int i = 0; i < 8; i++)
        c->buf[120 + i] = (uint8_t)(bits >> (56 - 8 * i));
    sha512_compress(c->st, c->buf);
    for (int i = 0; i < 8; i++) {
        uint64_t v = c->st[i];
        for (int j = 0; j < 8; j++)
            out[8 * i + j] = (uint8_t)(v >> (56 - 8 * j));
    }
}

/* -------------------------------------------- Barrett reduction mod L */

/* L = 2^252 + 27742317777372353535851937790883648493 (4 LE 64-bit words)
 * mu = floor(2^512 / L) (5 words, 260 bits) — both computed with python
 * ints and embedded; tests cross-check against python '%' on random and
 * boundary inputs. */
static const uint64_t Lw[4] = {
    0x5812631a5cf5d3edULL, 0x14def9dea2f79cd6ULL, 0x0ULL, 0x1000000000000000ULL,
};
static const uint64_t MU[5] = {
    0xed9ce5a30a2c131bULL, 0x2106215d086329a7ULL, 0xffffffffffffffebULL,
    0xffffffffffffffffULL, 0xfULL,
};

/* out[0..4] = (x * y)[word 5 .. word 9] where x,y are 5-word LE values —
 * i.e. floor(x*y / 2^320), which is Barrett's q3 when x = q1, y = mu and
 * the shift is b^(k+1) with k=4.  Full 10-word product kept for clarity;
 * the compiler unrolls this fine. */
static void mul_5x5_hi(const uint64_t x[5], const uint64_t y[5], uint64_t out[5]) {
    uint64_t prod[10] = {0};
    for (int i = 0; i < 5; i++) {
        unsigned __int128 carry = 0;
        for (int j = 0; j < 5; j++) {
            unsigned __int128 cur = (unsigned __int128)x[i] * y[j] + prod[i + j] + carry;
            prod[i + j] = (uint64_t)cur;
            carry = cur >> 64;
        }
        prod[i + 5] = (uint64_t)carry;
    }
    memcpy(out, prod + 5, 5 * sizeof(uint64_t));
}

/* out[0..4] = (x * L) mod 2^320, x 5 words */
static void mul_5xL_lo(const uint64_t x[5], uint64_t out[5]) {
    uint64_t prod[5] = {0};
    for (int i = 0; i < 5; i++) {
        unsigned __int128 carry = 0;
        for (int j = 0; j < 4 && i + j < 5; j++) {
            unsigned __int128 cur = (unsigned __int128)x[i] * Lw[j] + prod[i + j] + carry;
            prod[i + j] = (uint64_t)cur;
            carry = cur >> 64;
        }
        if (i + 4 < 5) {
            unsigned __int128 cur = (unsigned __int128)prod[i + 4] + carry;
            prod[i + 4] = (uint64_t)cur;
        }
    }
    memcpy(out, prod, 5 * sizeof(uint64_t));
}

/* r -= s (5 words, mod 2^320); returns borrow */
static uint64_t sub_5(uint64_t r[5], const uint64_t s[5]) {
    unsigned __int128 borrow = 0;
    for (int i = 0; i < 5; i++) {
        unsigned __int128 cur = (unsigned __int128)r[i] - s[i] - (uint64_t)borrow;
        r[i] = (uint64_t)cur;
        borrow = (cur >> 64) ? 1 : 0;
    }
    return (uint64_t)borrow;
}

static int geq_5_L(const uint64_t r[5]) {
    if (r[4]) return 1;
    for (int i = 3; i >= 0; i--) {
        if (r[i] > Lw[i]) return 1;
        if (r[i] < Lw[i]) return 0;
    }
    return 1; /* equal */
}

/* digest (64 bytes, little-endian value) -> digest mod L as 32 LE bytes */
static void reduce512(const uint8_t digest[64], uint8_t out[32]) {
    uint64_t x[8];
    for (int i = 0; i < 8; i++) {
        uint64_t v = 0;
        for (int j = 7; j >= 0; j--) v = (v << 8) | digest[8 * i + j];
        x[i] = v;
    }
    /* q1 = floor(x / b^3): words 3..7 (5 words) */
    uint64_t q1[5] = {x[3], x[4], x[5], x[6], x[7]};
    uint64_t q3[5];
    mul_5x5_hi(q1, MU, q3);
    /* r = x mod b^5  -  (q3 * L mod b^5), then correct by subtracting L */
    uint64_t r[5] = {x[0], x[1], x[2], x[3], x[4]};
    uint64_t q3L[5];
    mul_5xL_lo(q3, q3L);
    sub_5(r, q3L); /* Barrett guarantees 0 <= true r < 3L < b^5: no wrap */
    while (geq_5_L(r)) {
        uint64_t Lx[5] = {Lw[0], Lw[1], Lw[2], Lw[3], 0};
        sub_5(r, Lx);
    }
    for (int i = 0; i < 4; i++)
        for (int j = 0; j < 8; j++)
            out[8 * i + j] = (uint8_t)(r[i] >> (8 * j));
}

/* --------------------------------------------- GF(2^255-19) field ops */

/* 5x51-bit little-endian limbs (the curve25519-donna-64 radix): a 51x51
 * product times 19 times 5 summands tops out near 2^111, so whole mul
 * columns accumulate in one unsigned __int128 with no serialized carry
 * chain — measured ~2x over a 4x64 schoolbook at -O2 on this host.
 * Discipline: every add/sub weak-carries its result, so all values
 * entering fe_mul have limbs < 2^52 and the 4p bias in fe_sub can never
 * underflow a limb. */
typedef struct { uint64_t v[5]; } fe;

#define M51 0x7ffffffffffffULL

static const uint64_t Pw[4] = {
    0xffffffffffffffedULL, 0xffffffffffffffffULL,
    0xffffffffffffffffULL, 0x7fffffffffffffffULL,
};
static const fe FE_ONE = {{1, 0, 0, 0, 0}};
/* d = -121665/121666 mod p */
static const fe FE_D = {{
    0x34dca135978a3ULL, 0x1a8283b156ebdULL, 0x5e7a26001c029ULL,
    0x739c663a03cbbULL, 0x52036cee2b6ffULL,
}};
/* 2d */
static const fe FE_D2 = {{
    0x69b9426b2f159ULL, 0x35050762add7aULL, 0x3cf44c0038052ULL,
    0x6738cc7407977ULL, 0x2406d9dc56dffULL,
}};
/* sqrt(-1) = 2^((p-1)/4) */
static const fe FE_SQRTM1 = {{
    0x61b274a0ea0b0ULL, 0x0d5a5fc8f189dULL, 0x7ef5e9cbd0c60ULL,
    0x78595a6804c9eULL, 0x2b8324804fc1dULL,
}};
/* 4p limbwise — the fe_sub bias: big enough that subtracting any
 * weak-carried value (limbs < 2^52) keeps every limb non-negative. */
static const uint64_t FOURP[5] = {
    0x1fffffffffffb4ULL, 0x1ffffffffffffcULL, 0x1ffffffffffffcULL,
    0x1ffffffffffffcULL, 0x1ffffffffffffcULL,
};
/* (p-5)/8 = 2^252 - 3, little-endian bytes (fe_pow exponent) */
static const uint8_t EXP_P58[32] = {
    0xfd, 0xff, 0xff, 0xff, 0xff, 0xff, 0xff, 0xff,
    0xff, 0xff, 0xff, 0xff, 0xff, 0xff, 0xff, 0xff,
    0xff, 0xff, 0xff, 0xff, 0xff, 0xff, 0xff, 0xff,
    0xff, 0xff, 0xff, 0xff, 0xff, 0xff, 0xff, 0x0f,
};
/* compressed base point: y = 4/5, x even */
static const uint8_t B_ENC[32] = {
    0x58, 0x66, 0x66, 0x66, 0x66, 0x66, 0x66, 0x66,
    0x66, 0x66, 0x66, 0x66, 0x66, 0x66, 0x66, 0x66,
    0x66, 0x66, 0x66, 0x66, 0x66, 0x66, 0x66, 0x66,
    0x66, 0x66, 0x66, 0x66, 0x66, 0x66, 0x66, 0x66,
};

static void fe_weak_carry(fe *r) {
    /* bring limbs back under ~2^51 (top limb's overflow folds as x19);
     * the final ripple leaves v[1] at most 2^51 + 1 — well under the
     * 2^52 bound every consumer assumes */
    uint64_t c;
    c = r->v[0] >> 51; r->v[0] &= M51; r->v[1] += c;
    c = r->v[1] >> 51; r->v[1] &= M51; r->v[2] += c;
    c = r->v[2] >> 51; r->v[2] &= M51; r->v[3] += c;
    c = r->v[3] >> 51; r->v[3] &= M51; r->v[4] += c;
    c = r->v[4] >> 51; r->v[4] &= M51; r->v[0] += c * 19;
    c = r->v[0] >> 51; r->v[0] &= M51; r->v[1] += c;
}

static void fe_add(fe *r, const fe *a, const fe *b) {
    for (int i = 0; i < 5; i++) r->v[i] = a->v[i] + b->v[i];
    fe_weak_carry(r);
}

static void fe_sub(fe *r, const fe *a, const fe *b) {
    /* a + 4p - b: with both inputs weak-carried (< 2^52 per limb) every
     * limb stays non-negative, so no borrows exist to track */
    for (int i = 0; i < 5; i++) r->v[i] = a->v[i] + FOURP[i] - b->v[i];
    fe_weak_carry(r);
}

static void fe_mul(fe *r, const fe *a, const fe *b) {
    typedef unsigned __int128 u128;
    const uint64_t a0 = a->v[0], a1 = a->v[1], a2 = a->v[2],
                   a3 = a->v[3], a4 = a->v[4];
    const uint64_t b0 = b->v[0], b1 = b->v[1], b2 = b->v[2],
                   b3 = b->v[3], b4 = b->v[4];
    const uint64_t a1_19 = 19 * a1, a2_19 = 19 * a2, a3_19 = 19 * a3,
                   a4_19 = 19 * a4;
    /* column sums: limbs < 2^52, so each column < 5*19*2^104 < 2^112 */
    u128 t0 = (u128)a0 * b0 + (u128)a1_19 * b4 + (u128)a2_19 * b3
            + (u128)a3_19 * b2 + (u128)a4_19 * b1;
    u128 t1 = (u128)a0 * b1 + (u128)a1 * b0 + (u128)a2_19 * b4
            + (u128)a3_19 * b3 + (u128)a4_19 * b2;
    u128 t2 = (u128)a0 * b2 + (u128)a1 * b1 + (u128)a2 * b0
            + (u128)a3_19 * b4 + (u128)a4_19 * b3;
    u128 t3 = (u128)a0 * b3 + (u128)a1 * b2 + (u128)a2 * b1
            + (u128)a3 * b0 + (u128)a4_19 * b4;
    u128 t4 = (u128)a0 * b4 + (u128)a1 * b3 + (u128)a2 * b2
            + (u128)a3 * b1 + (u128)a4 * b0;
    uint64_t r0, r1, r2, r3, r4, c;
    r0 = (uint64_t)t0 & M51; t1 += (uint64_t)(t0 >> 51);
    r1 = (uint64_t)t1 & M51; t2 += (uint64_t)(t1 >> 51);
    r2 = (uint64_t)t2 & M51; t3 += (uint64_t)(t2 >> 51);
    r3 = (uint64_t)t3 & M51; t4 += (uint64_t)(t3 >> 51);
    r4 = (uint64_t)t4 & M51;
    /* top carry < 2^61; x19 fits u128, folds into r0 with one ripple */
    u128 cc = (u128)r0 + (u128)(uint64_t)(t4 >> 51) * 19;
    r0 = (uint64_t)cc & M51;
    c = (uint64_t)(cc >> 51);
    r1 += c;
    r->v[0] = r0; r->v[1] = r1; r->v[2] = r2; r->v[3] = r3; r->v[4] = r4;
}

static void fe_sq(fe *r, const fe *a) { fe_mul(r, a, a); }

static void fe_neg(fe *r, const fe *a) {
    fe zero = {{0, 0, 0, 0, 0}};
    fe_sub(r, &zero, a);
}

static void fe_tobytes(uint8_t out[32], const fe *a) {
    /* canonical reduction (donna): weak-carry, then decide the final
     * conditional subtract of p by propagating (v + 19) >> 51 */
    fe t = *a;
    fe_weak_carry(&t);
    fe_weak_carry(&t);
    uint64_t q = (t.v[0] + 19) >> 51;
    q = (t.v[1] + q) >> 51;
    q = (t.v[2] + q) >> 51;
    q = (t.v[3] + q) >> 51;
    q = (t.v[4] + q) >> 51;
    t.v[0] += 19 * q;
    uint64_t c;
    c = t.v[0] >> 51; t.v[0] &= M51; t.v[1] += c;
    c = t.v[1] >> 51; t.v[1] &= M51; t.v[2] += c;
    c = t.v[2] >> 51; t.v[2] &= M51; t.v[3] += c;
    c = t.v[3] >> 51; t.v[3] &= M51; t.v[4] += c;
    t.v[4] &= M51; /* discard q * 2^255 */
    uint64_t w0 = t.v[0] | (t.v[1] << 51);
    uint64_t w1 = (t.v[1] >> 13) | (t.v[2] << 38);
    uint64_t w2 = (t.v[2] >> 26) | (t.v[3] << 25);
    uint64_t w3 = (t.v[3] >> 39) | (t.v[4] << 12);
    const uint64_t w[4] = {w0, w1, w2, w3};
    for (int i = 0; i < 4; i++)
        for (int j = 0; j < 8; j++)
            out[8 * i + j] = (uint8_t)(w[i] >> (8 * j));
}

static uint64_t load_le64(const uint8_t *s) {
    uint64_t v = 0;
    for (int j = 7; j >= 0; j--) v = (v << 8) | s[j];
    return v;
}

static void fe_frombytes(fe *r, const uint8_t s[32]) {
    r->v[0] = load_le64(s) & M51;
    r->v[1] = (load_le64(s + 6) >> 3) & M51;
    r->v[2] = (load_le64(s + 12) >> 6) & M51;
    r->v[3] = (load_le64(s + 19) >> 1) & M51;
    r->v[4] = (load_le64(s + 24) >> 12) & M51;
}

static int fe_iszero(const fe *a) {
    uint8_t b[32];
    fe_tobytes(b, a);
    uint8_t acc = 0;
    for (int i = 0; i < 32; i++) acc |= b[i];
    return acc == 0;
}

/* y-coordinate canonicality: masked 255-bit value must be < p */
static int bytes_lt_p(const uint8_t s[32]) {
    uint64_t w[4];
    for (int i = 0; i < 4; i++) {
        uint64_t v = 0;
        for (int j = 7; j >= 0; j--) v = (v << 8) | s[8 * i + j];
        w[i] = v;
    }
    w[3] &= 0x7fffffffffffffffULL;
    for (int i = 3; i >= 0; i--) {
        if (w[i] < Pw[i]) return 1;
        if (w[i] > Pw[i]) return 0;
    }
    return 0; /* equal to p */
}

static void fe_pow(fe *r, const fe *a, const uint8_t e[32]) {
    /* MSB-first square-and-multiply; exponents here are public values
     * ((p-5)/8), so variable time is fine — same posture as the
     * pure-Python engine. */
    fe acc = FE_ONE, base = *a, t;
    for (int bit = 254; bit >= 0; bit--) {
        fe_sq(&t, &acc);
        acc = t;
        if ((e[bit >> 3] >> (bit & 7)) & 1) {
            fe_mul(&t, &acc, &base);
            acc = t;
        }
    }
    *r = acc;
}

/* --------------------------------------------------------------- X25519 */

/* RFC 7748 §5 scalar multiplication on the Montgomery form — the session
 * handshake's DH (crypto/session.py).  Pure-Python X25519 costs ~1.4 ms
 * per operation on this host, which puts a cold fan-out's worth of
 * handshakes at several blocked-loop milliseconds; this ladder reuses the
 * 5x51 field ops above and lands in the tens of microseconds.  The
 * private scalar IS secret (unlike the fe_pow exponents): the ladder is
 * fixed-length with masked constant-time conditional swaps. */

static void fe_cswap(fe *a, fe *b, uint64_t swap) {
    uint64_t mask = 0 - swap; /* swap in {0,1} */
    for (int i = 0; i < 5; i++) {
        uint64_t t = mask & (a->v[i] ^ b->v[i]);
        a->v[i] ^= t;
        b->v[i] ^= t;
    }
}

/* p - 2 = 2^255 - 21, little-endian bytes (fe_pow inversion exponent —
 * public constant, so fe_pow's variable time is fine here too; shared
 * with the ge section's inverse below). */
static const uint8_t EXP_PM2[32] = {
    0xeb, 0xff, 0xff, 0xff, 0xff, 0xff, 0xff, 0xff,
    0xff, 0xff, 0xff, 0xff, 0xff, 0xff, 0xff, 0xff,
    0xff, 0xff, 0xff, 0xff, 0xff, 0xff, 0xff, 0xff,
    0xff, 0xff, 0xff, 0xff, 0xff, 0xff, 0xff, 0x7f,
};

/* (A - 2) / 4 = 121665 as a field element (z2 step of the ladder) */
static const fe FE_A24 = {{121665, 0, 0, 0, 0}};

static void x25519_scalarmult(uint8_t out[32], const uint8_t scalar[32],
                              const uint8_t point[32]) {
    uint8_t k[32];
    memcpy(k, scalar, 32);
    k[0] &= 248; /* RFC 7748 clamp, in C: callers pass the raw seed */
    k[31] &= 127;
    k[31] |= 64;
    /* fe_frombytes masks bit 255 of the peer point by construction */
    fe x1, x2, z2, x3, z3;
    fe a, aa, b, bb, e, c, d, da, cb, t;
    fe_frombytes(&x1, point);
    x2 = FE_ONE;
    memset(&z2, 0, sizeof z2);
    x3 = x1;
    z3 = FE_ONE;
    uint64_t swap = 0;
    for (int bit = 254; bit >= 0; bit--) {
        uint64_t k_t = (k[bit >> 3] >> (bit & 7)) & 1;
        swap ^= k_t;
        fe_cswap(&x2, &x3, swap);
        fe_cswap(&z2, &z3, swap);
        swap = k_t;
        fe_add(&a, &x2, &z2);
        fe_sq(&aa, &a);
        fe_sub(&b, &x2, &z2);
        fe_sq(&bb, &b);
        fe_sub(&e, &aa, &bb);
        fe_add(&c, &x3, &z3);
        fe_sub(&d, &x3, &z3);
        fe_mul(&da, &d, &a);
        fe_mul(&cb, &c, &b);
        fe_add(&t, &da, &cb);
        fe_sq(&x3, &t);
        fe_sub(&t, &da, &cb);
        fe_sq(&t, &t);
        fe_mul(&z3, &t, &x1);
        fe_mul(&x2, &aa, &bb);
        fe_mul(&t, &e, &FE_A24);
        fe_add(&t, &aa, &t);
        fe_mul(&z2, &e, &t);
    }
    fe_cswap(&x2, &x3, swap);
    fe_cswap(&z2, &z3, swap);
    fe_pow(&t, &z2, EXP_PM2);
    fe_mul(&x2, &x2, &t);
    fe_tobytes(out, &x2);
}

/* ---------------------------------------------------- group operations */

/* Extended twisted-Edwards coordinates (X, Y, Z, T), x = X/Z, y = Y/Z,
 * T = XY/Z — the exact layout of curve.Point / hostfallback._Pt. */
typedef struct { fe X, Y, Z, T; } ge;

static const ge GE_ID = {
    {{0, 0, 0, 0, 0}}, {{1, 0, 0, 0, 0}}, {{1, 0, 0, 0, 0}}, {{0, 0, 0, 0, 0}},
};

/* Complete unified addition (add-2008-hwcd-3, a=-1) — hostfallback._pt_add
 * on limbs.  Complete: also serves as doubling and handles the identity,
 * so no input pair can route the C engine onto a different formula than
 * the Python engine evaluates. */
static void ge_add(ge *r, const ge *p, const ge *q) {
    fe a, b, c, d, e, f, g, h, t1, t2;
    fe_sub(&t1, &p->Y, &p->X);
    fe_sub(&t2, &q->Y, &q->X);
    fe_mul(&a, &t1, &t2);
    fe_add(&t1, &p->Y, &p->X);
    fe_add(&t2, &q->Y, &q->X);
    fe_mul(&b, &t1, &t2);
    fe_mul(&t1, &p->T, &FE_D2);
    fe_mul(&c, &t1, &q->T);
    fe_mul(&t1, &p->Z, &q->Z);
    fe_add(&d, &t1, &t1);
    fe_sub(&e, &b, &a);
    fe_sub(&f, &d, &c);
    fe_add(&g, &d, &c);
    fe_add(&h, &b, &a);
    fe_mul(&r->X, &e, &f);
    fe_mul(&r->Y, &g, &h);
    fe_mul(&r->Z, &f, &g);
    fe_mul(&r->T, &e, &h);
}

/* RFC 8032 §5.1.3 point decoding — hostfallback._decompress on limbs.
 * Returns 0 on success, -1 for a non-point / non-canonical encoding. */
static int ge_decompress(ge *out, const uint8_t s[32]) {
    int sign = s[31] >> 7;
    if (!bytes_lt_p(s)) return -1;
    fe y, yy, u, v, v3, v7, t, x, vxx, chk;
    fe_frombytes(&y, s);
    fe_sq(&yy, &y);
    fe_sub(&u, &yy, &FE_ONE);
    fe_mul(&v, &FE_D, &yy);
    fe_add(&v, &v, &FE_ONE);
    /* candidate root x = u * v^3 * (u*v^7)^((p-5)/8) */
    fe_sq(&t, &v);
    fe_mul(&v3, &t, &v);
    fe_sq(&t, &v3);
    fe_mul(&v7, &t, &v);
    fe_mul(&t, &u, &v7);
    fe_pow(&t, &t, EXP_P58);
    fe_mul(&x, &u, &v3);
    fe_mul(&x, &x, &t);
    fe_sq(&t, &x);
    fe_mul(&vxx, &v, &t);
    fe_sub(&chk, &vxx, &u);
    if (!fe_iszero(&chk)) {
        fe_add(&chk, &vxx, &u);
        if (!fe_iszero(&chk)) return -1;
        fe_mul(&x, &x, &FE_SQRTM1);
    }
    uint8_t xb[32];
    fe_tobytes(xb, &x);
    int x_zero = 1;
    for (int i = 0; i < 32; i++)
        if (xb[i]) { x_zero = 0; break; }
    if (x_zero && sign) return -1;
    if ((xb[0] & 1) != sign) fe_neg(&x, &x);
    out->X = x;
    out->Y = y;
    out->Z = FE_ONE;
    fe_mul(&out->T, &x, &y);
    return 0;
}

/* --------------------------------------------------- Ed25519 verify */

/* Btab[d] = [d]B for d in 1..15 (index 0 unused; verify's Straus ladder)
 * and BCOMB[w][d] = [d * 16^w]B (hostfallback._window_table on limbs;
 * signing's doubling-free fixed-base walk).  Built once under the GIL on
 * first use (~1k additions). */
static ge Btab[16];
static ge BCOMB[64][16];
static int tables_ready = 0;

static int ensure_tables(void) {
    if (tables_ready) return 0;
    ge b;
    if (ge_decompress(&b, B_ENC) != 0) return -1; /* unreachable */
    Btab[1] = b;
    for (int i = 2; i < 16; i++) ge_add(&Btab[i], &Btab[i - 1], &b);
    ge step = b, t;
    for (int w = 0; w < 64; w++) {
        BCOMB[w][0] = GE_ID;
        for (int d = 1; d < 16; d++) ge_add(&BCOMB[w][d], &BCOMB[w][d - 1], &step);
        ge_add(&t, &BCOMB[w][8], &BCOMB[w][8]); /* 16 * step */
        step = t;
    }
    tables_ready = 1;
    return 0;
}

/* [k]B via the comb table: 64 unconditional additions, NO zero-digit
 * skip — the signing scalars (nonce r, private a) are SECRET, and a skip
 * would correlate per-signature timing with their zero-nibble counts
 * (hostfallback._mul_base documents the same choice; the engine is
 * variable-time at the limb level regardless, but no extra
 * branch-per-secret-nibble on top). */
/* mochi-ct: secret(k) */
static void ge_mul_base(ge *r, const uint8_t k[32]) {
    ge acc = GE_ID, t;
    for (int w = 0; w < 64; w++) {
        int d = (k[w >> 1] >> ((w & 1) * 4)) & 15;
        /* mochi-lint: disable=native-const-time -- reviewed: 16-entry row of a hot comb table (one cache line's reach, touched 64x/sign); the branch-free add above it is the channel that matters and is pinned clean */
        ge_add(&t, &acc, &BCOMB[w][d]);
        acc = t;
    }
    *r = acc;
}

/* compress: (X/Z, Y/Z) -> 32-byte encoding (hostfallback._compress) */
static void ge_tobytes(uint8_t out[32], const ge *p) {
    fe zinv, x, y;
    fe_pow(&zinv, &p->Z, EXP_PM2);
    fe_mul(&x, &p->X, &zinv);
    fe_mul(&y, &p->Y, &zinv);
    uint8_t xb[32];
    fe_tobytes(xb, &x);
    fe_tobytes(out, &y);
    out[31] |= (xb[0] & 1) << 7;
}

static int fe_eq_scaled(const fe *affine, const fe *proj, const fe *z) {
    /* affine * z == proj (both canonicalized) */
    fe t;
    uint8_t b1[32], b2[32];
    fe_mul(&t, affine, z);
    fe_tobytes(b1, &t);
    fe_tobytes(b2, proj);
    return memcmp(b1, b2, 32) == 0;
}

/* Cofactorless [S]B == R + [h]A, evaluated as [S]B + [h](-A) == R with a
 * Straus shared-doubling ladder (4-bit windows over the full 256-bit
 * scalars, so a non-canonical S >= L computes the true multiple — the
 * exact verdict hostfallback's table walk produces for the same bytes).
 * h is the already-reduced challenge scalar (32 LE bytes, from
 * h_batch/reduce512).  Variable-time on public data only. */
static int verify_one(const uint8_t pub[32], const uint8_t sig[64],
                      const uint8_t h[32]) {
    ge A, R, acc, t;
    if (ge_decompress(&R, sig) != 0) return 0;
    if (ge_decompress(&A, pub) != 0) return 0;
    fe_neg(&A.X, &A.X);
    fe_neg(&A.T, &A.T);
    ge Atab[16];
    Atab[1] = A;
    for (int i = 2; i < 16; i++) ge_add(&Atab[i], &Atab[i - 1], &A);
    const uint8_t *s = sig + 32;
    acc = GE_ID;
    for (int w = 63; w >= 0; w--) {
        for (int k = 0; k < 4; k++) {
            ge_add(&t, &acc, &acc);
            acc = t;
        }
        int ns = (s[w >> 1] >> ((w & 1) * 4)) & 15;
        if (ns) {
            ge_add(&t, &acc, &Btab[ns]);
            acc = t;
        }
        int nh = (h[w >> 1] >> ((w & 1) * 4)) & 15;
        if (nh) {
            ge_add(&t, &acc, &Atab[nh]);
            acc = t;
        }
    }
    /* acc == R, R affine (Z=1): cross-multiplied projective equality */
    return fe_eq_scaled(&R.X, &acc.X, &acc.Z)
        && fe_eq_scaled(&R.Y, &acc.Y, &acc.Z);
}

/* ------------------------------------------------------------ binding */

/* h_batch(r: n*32 bytes, a: n*32 bytes, msgs: concatenated messages,
 *         lens: n little-endian uint64 byte lengths) -> n*32 bytes */
static PyObject *py_h_batch(PyObject *self, PyObject *args) {
    Py_buffer rbuf, abuf, mbuf, lbuf;
    if (!PyArg_ParseTuple(args, "y*y*y*y*", &rbuf, &abuf, &mbuf, &lbuf))
        return NULL;
    PyObject *result = NULL;
    Py_ssize_t n = lbuf.len / 8;
    if (lbuf.len % 8 || rbuf.len != n * 32 || abuf.len != n * 32) {
        PyErr_SetString(PyExc_ValueError, "h_batch: inconsistent buffer sizes");
        goto done;
    }
    const uint64_t *lens = (const uint64_t *)lbuf.buf;
    uint64_t total = 0;
    for (Py_ssize_t i = 0; i < n; i++) {
        /* overflow-safe: each length must fit the REMAINING buffer, so the
         * sum can never wrap (a wrapped total could equal mbuf.len and
         * smuggle an out-of-bounds read past the check below) */
        if (lens[i] > (uint64_t)mbuf.len - total) {
            PyErr_SetString(PyExc_ValueError,
                            "h_batch: msg lengths exceed buffer");
            goto done;
        }
        total += lens[i];
    }
    if (total != (uint64_t)mbuf.len) {
        PyErr_SetString(PyExc_ValueError, "h_batch: msg lengths do not sum to buffer");
        goto done;
    }
    result = PyBytes_FromStringAndSize(NULL, n * 32);
    if (!result) goto done;
    uint8_t *out = (uint8_t *)PyBytes_AS_STRING(result);
    const uint8_t *rs = (const uint8_t *)rbuf.buf;
    const uint8_t *as = (const uint8_t *)abuf.buf;
    const uint8_t *ms = (const uint8_t *)mbuf.buf;
    Py_BEGIN_ALLOW_THREADS
    size_t off = 0;
    for (Py_ssize_t i = 0; i < n; i++) {
        sha512_ctx c;
        uint8_t digest[64];
        sha512_init(&c);
        sha512_update(&c, rs + 32 * i, 32);
        sha512_update(&c, as + 32 * i, 32);
        sha512_update(&c, ms + off, (size_t)lens[i]);
        off += (size_t)lens[i];
        sha512_final(&c, digest);
        reduce512(digest, out + 32 * i);
    }
    Py_END_ALLOW_THREADS
done:
    PyBuffer_Release(&rbuf);
    PyBuffer_Release(&abuf);
    PyBuffer_Release(&mbuf);
    PyBuffer_Release(&lbuf);
    return result;
}

/* verify_batch(pubs: n*32 bytes, sigs: n*64 bytes, hs: n*32 bytes of
 * already-reduced challenge scalars) -> n verdict bytes (0/1).  The h
 * scalars come from h_batch/reduce512, so the full host pipeline is
 * "h_batch then verify_batch" — two C calls for a whole certificate. */
static PyObject *py_verify_batch(PyObject *self, PyObject *args) {
    Py_buffer pbuf, sbuf, hbuf;
    if (!PyArg_ParseTuple(args, "y*y*y*", &pbuf, &sbuf, &hbuf))
        return NULL;
    PyObject *result = NULL;
    Py_ssize_t n = hbuf.len / 32;
    if (hbuf.len % 32 || pbuf.len != n * 32 || sbuf.len != n * 64) {
        PyErr_SetString(PyExc_ValueError,
                        "verify_batch: inconsistent buffer sizes");
        goto done;
    }
    if (ensure_tables() != 0) {
        PyErr_SetString(PyExc_RuntimeError,
                        "verify_batch: base point decode failed");
        goto done;
    }
    result = PyBytes_FromStringAndSize(NULL, n);
    if (!result) goto done;
    uint8_t *out = (uint8_t *)PyBytes_AS_STRING(result);
    const uint8_t *ps = (const uint8_t *)pbuf.buf;
    const uint8_t *ss = (const uint8_t *)sbuf.buf;
    const uint8_t *hs = (const uint8_t *)hbuf.buf;
    Py_BEGIN_ALLOW_THREADS
    for (Py_ssize_t i = 0; i < n; i++)
        out[i] = (uint8_t)verify_one(ps + 32 * i, ss + 64 * i, hs + 32 * i);
    Py_END_ALLOW_THREADS
done:
    PyBuffer_Release(&pbuf);
    PyBuffer_Release(&sbuf);
    PyBuffer_Release(&hbuf);
    return result;
}

/* out = k*a + r as a 512-bit little-endian value (k, r: 32-byte reduced
 * scalars < L; a: the clamped secret scalar < 2^255) — the caller feeds
 * it back through reduce512 for s = (r + k*a) mod L. */
static void sc_muladd_512(uint8_t out[64], const uint8_t k[32],
                          const uint8_t a[32], const uint8_t r[32]) {
    uint64_t kw[4], aw[4], rw[4], t[8] = {0};
    for (int i = 0; i < 4; i++) {
        kw[i] = load_le64(k + 8 * i);
        aw[i] = load_le64(a + 8 * i);
        rw[i] = load_le64(r + 8 * i);
    }
    for (int i = 0; i < 4; i++) {
        unsigned __int128 carry = 0;
        for (int j = 0; j < 4; j++) {
            unsigned __int128 cur =
                (unsigned __int128)kw[i] * aw[j] + t[i + j] + carry;
            t[i + j] = (uint64_t)cur;
            carry = cur >> 64;
        }
        t[i + 4] = (uint64_t)carry;
    }
    unsigned __int128 c = 0;
    for (int i = 0; i < 8; i++) {
        c += t[i];
        if (i < 4) c += rw[i];
        t[i] = (uint64_t)c;
        c >>= 64;
    } /* k*a + r < L*2^255 + L << 2^512: no final carry */
    for (int i = 0; i < 8; i++)
        for (int j = 0; j < 8; j++)
            out[8 * i + j] = (uint8_t)(t[i] >> (8 * j));
}

/* sign_prepared(a, prefix, pub, msg) -> 64-byte signature.  RFC 8032
 * §5.1.6 with the key already expanded (a = clamped scalar, prefix =
 * second hash half, pub = compressed A) — the Python side caches that
 * expansion per seed.  Deterministic and bit-identical to
 * hostfallback.sign / OpenSSL (the replica's own-grant re-sign-and-
 * compare depends on byte equality across engines). */
static PyObject *py_sign_prepared(PyObject *self, PyObject *args) {
    Py_buffer abuf, pbuf, qbuf, mbuf;
    if (!PyArg_ParseTuple(args, "y*y*y*y*", &abuf, &pbuf, &qbuf, &mbuf))
        return NULL;
    PyObject *result = NULL;
    if (abuf.len != 32 || pbuf.len != 32 || qbuf.len != 32) {
        PyErr_SetString(PyExc_ValueError,
                        "sign_prepared: a/prefix/pub must be 32 bytes");
        goto done;
    }
    if (ensure_tables() != 0) {
        PyErr_SetString(PyExc_RuntimeError,
                        "sign_prepared: base point decode failed");
        goto done;
    }
    uint8_t sig[64];
    Py_BEGIN_ALLOW_THREADS
    {
        sha512_ctx c;
        uint8_t digest[64], r_scalar[32], k_scalar[32], t512[64];
        sha512_init(&c);
        sha512_update(&c, (const uint8_t *)pbuf.buf, 32);
        sha512_update(&c, (const uint8_t *)mbuf.buf, (size_t)mbuf.len);
        sha512_final(&c, digest);
        reduce512(digest, r_scalar);
        ge R;
        ge_mul_base(&R, r_scalar);
        ge_tobytes(sig, &R);
        sha512_init(&c);
        sha512_update(&c, sig, 32);
        sha512_update(&c, (const uint8_t *)qbuf.buf, 32);
        sha512_update(&c, (const uint8_t *)mbuf.buf, (size_t)mbuf.len);
        sha512_final(&c, digest);
        reduce512(digest, k_scalar);
        sc_muladd_512(t512, k_scalar, (const uint8_t *)abuf.buf, r_scalar);
        reduce512(t512, sig + 32);
    }
    Py_END_ALLOW_THREADS
    result = PyBytes_FromStringAndSize((const char *)sig, 64);
done:
    PyBuffer_Release(&abuf);
    PyBuffer_Release(&pbuf);
    PyBuffer_Release(&qbuf);
    PyBuffer_Release(&mbuf);
    return result;
}

/* test hooks: sha512(data) and reduce512(digest) for directed differential
 * tests against hashlib / python ints */
static PyObject *py_sha512(PyObject *self, PyObject *args) {
    Py_buffer buf;
    if (!PyArg_ParseTuple(args, "y*", &buf)) return NULL;
    sha512_ctx c;
    uint8_t digest[64];
    sha512_init(&c);
    sha512_update(&c, (const uint8_t *)buf.buf, (size_t)buf.len);
    sha512_final(&c, digest);
    PyBuffer_Release(&buf);
    return PyBytes_FromStringAndSize((const char *)digest, 64);
}

static PyObject *py_reduce512(PyObject *self, PyObject *args) {
    Py_buffer buf;
    if (!PyArg_ParseTuple(args, "y*", &buf)) return NULL;
    if (buf.len != 64) {
        PyBuffer_Release(&buf);
        PyErr_SetString(PyExc_ValueError, "reduce512 wants 64 bytes");
        return NULL;
    }
    uint8_t out[32];
    reduce512((const uint8_t *)buf.buf, out);
    PyBuffer_Release(&buf);
    return PyBytes_FromStringAndSize((const char *)out, 32);
}

/* x25519(private, peer_public) -> 32-byte shared secret.  Clamping runs
 * in C (RFC 7748 §5); the all-zero-output small-order rejection stays in
 * the Python wrapper (crypto/hostfallback.x25519) so both engines share
 * ONE policy seam. */
static PyObject *py_x25519(PyObject *self, PyObject *args) {
    Py_buffer kbuf, ubuf;
    if (!PyArg_ParseTuple(args, "y*y*", &kbuf, &ubuf)) return NULL;
    PyObject *result = NULL;
    if (kbuf.len != 32 || ubuf.len != 32) {
        PyErr_SetString(PyExc_ValueError, "x25519: keys must be 32 bytes");
        goto done;
    }
    uint8_t out[32];
    Py_BEGIN_ALLOW_THREADS
    x25519_scalarmult(out, (const uint8_t *)kbuf.buf,
                      (const uint8_t *)ubuf.buf);
    Py_END_ALLOW_THREADS
    result = PyBytes_FromStringAndSize((const char *)out, 32);
done:
    PyBuffer_Release(&kbuf);
    PyBuffer_Release(&ubuf);
    return result;
}

static PyMethodDef methods[] = {
    {"h_batch", py_h_batch, METH_VARARGS,
     "h_batch(r, a, msgs, lens) -> concatenated 32-byte h scalars"},
    {"verify_batch", py_verify_batch, METH_VARARGS,
     "verify_batch(pubs, sigs, hs) -> one verdict byte (0/1) per item"},
    {"sign_prepared", py_sign_prepared, METH_VARARGS,
     "sign_prepared(a, prefix, pub, msg) -> 64-byte Ed25519 signature"},
    {"x25519", py_x25519, METH_VARARGS,
     "x25519(private, peer_public) -> 32-byte shared secret (RFC 7748)"},
    {"sha512", py_sha512, METH_VARARGS, "test hook: one-shot SHA-512"},
    {"reduce512", py_reduce512, METH_VARARGS,
     "test hook: 64-byte LE value mod L as 32 LE bytes"},
    {NULL, NULL, 0, NULL},
};

static struct PyModuleDef moduledef = {
    PyModuleDef_HEAD_INIT, "_hbatch", NULL, -1, methods,
};

PyMODINIT_FUNC PyInit__hbatch(void) { return PyModule_Create(&moduledef); }
