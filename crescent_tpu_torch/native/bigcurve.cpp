// Native host-side elliptic-curve backend for crescent-tpu.
//
// TPU-native framework layering (SURVEY.md §2c "TPU plan per fork"): the
// *device* compute path is JAX/XLA/Pallas (ops/msm.py, ops/ec.py); this file
// is the native *host runtime* — the role the reference fills with Rust +
// x86 asm (forks/halo2curves, e.g. derive/src/field/asm/limb4.rs and
// src/msm.rs:336-464).  It provides 4x64-bit Montgomery field arithmetic,
// Jacobian point ops over BN254 G1/G2, P-256 and T-256, windowed fixed-base
// batch multiplication (Groth16 SRS generation, generator.rs) and a signed
// -digit Pippenger MSM (msm.rs:336 serial / :432 parallel equivalents).
//
// ABI: plain C functions over little-endian 32-byte standard-form (non
// -Montgomery) field elements.  Affine points are (x, y); (0, 0) encodes the
// identity (not on any supported curve since b != 0).  G2 elements are
// (x.c0, x.c1, y.c0, y.c1).
//
// Build: g++ -O3 -std=c++17 -shared -fPIC bigcurve.cpp -o libbigcurve.so
// (driven by backend.py beside this file; the Python side binds with
// ctypes).

#include <atomic>
#include <cstdint>
#include <cstring>
#include <cstdlib>
#include <functional>
#include <thread>
#include <vector>

typedef unsigned __int128 u128;
typedef uint64_t u64;
typedef uint32_t u32;

// ---------------------------------------------------------------------------
// 4x64 helpers
// ---------------------------------------------------------------------------

struct U256 {
    u64 v[4];
};

static inline bool u256_is_zero(const u64 *a) {
    return (a[0] | a[1] | a[2] | a[3]) == 0;
}

static inline int u256_cmp(const u64 *a, const u64 *b) {
    for (int i = 3; i >= 0; --i) {
        if (a[i] < b[i]) return -1;
        if (a[i] > b[i]) return 1;
    }
    return 0;
}

// out = a + b, returns carry
static inline u64 u256_add(u64 *out, const u64 *a, const u64 *b) {
    u128 c = 0;
    for (int i = 0; i < 4; ++i) {
        c += (u128)a[i] + b[i];
        out[i] = (u64)c;
        c >>= 64;
    }
    return (u64)c;
}

// out = a - b, returns borrow
static inline u64 u256_sub(u64 *out, const u64 *a, const u64 *b) {
    u128 br = 0;
    for (int i = 0; i < 4; ++i) {
        u128 d = (u128)a[i] - b[i] - br;
        out[i] = (u64)d;
        br = (d >> 64) & 1;  // two's complement borrow
    }
    return (u64)br;
}

// ---------------------------------------------------------------------------
// Montgomery field context (runtime modulus; all supported moduli are 254-256
// bits and odd)
// ---------------------------------------------------------------------------

struct FieldCtx {
    u64 mod[4];
    u64 inv;    // -mod^{-1} mod 2^64
    u64 r1[4];  // R mod N   (Montgomery form of 1)
    u64 r2[4];  // R^2 mod N
};

static void field_init(FieldCtx &f, const u64 mod[4]) {
    memcpy(f.mod, mod, 32);
    // Newton iteration for inv = -mod^{-1} mod 2^64
    u64 x = 1;
    for (int i = 0; i < 6; ++i) x *= 2 - mod[0] * x;
    f.inv = (u64)(0 - x);
    // R mod N via (2^256 - N) reduced (N has its top limb nonzero for all
    // supported moduli, so 2^256 < 2N and one subtraction-from-zero suffices)
    u64 zero[4] = {0, 0, 0, 0};
    u256_sub(f.r1, zero, mod);  // 2^256 - N
    while (u256_cmp(f.r1, mod) >= 0) u256_sub(f.r1, f.r1, mod);
    // R^2 mod N by 256 modular doublings of R
    u64 t[4];
    memcpy(t, f.r1, 32);
    for (int i = 0; i < 256; ++i) {
        u64 carry = u256_add(t, t, t);
        if (carry || u256_cmp(t, mod) >= 0) u256_sub(t, t, mod);
    }
    memcpy(f.r2, t, 32);
}

// CIOS Montgomery multiply: out = a*b*R^{-1} mod N.
static inline void fmul(const FieldCtx &f, const u64 *a, const u64 *b, u64 *out) {
    u64 t[6] = {0, 0, 0, 0, 0, 0};
    for (int i = 0; i < 4; ++i) {
        u128 c = 0;
        u64 bi = b[i];
        for (int j = 0; j < 4; ++j) {
            c = (u128)a[j] * bi + t[j] + (u64)c;
            t[j] = (u64)c;
            c >>= 64;
        }
        u128 c2 = (u128)t[4] + (u64)c;
        t[4] = (u64)c2;
        t[5] += (u64)(c2 >> 64);

        u64 m = t[0] * f.inv;
        c = (u128)m * f.mod[0] + t[0];
        c >>= 64;
        for (int j = 1; j < 4; ++j) {
            c = (u128)m * f.mod[j] + t[j] + (u64)c;
            t[j - 1] = (u64)c;
            c >>= 64;
        }
        c2 = (u128)t[4] + (u64)c;
        t[3] = (u64)c2;
        t[4] = t[5] + (u64)(c2 >> 64);
        t[5] = 0;
    }
    if (t[4] || u256_cmp(t, f.mod) >= 0)
        u256_sub(out, t, f.mod);
    else
        memcpy(out, t, 32);
}

static inline void fsqr(const FieldCtx &f, const u64 *a, u64 *out) { fmul(f, a, a, out); }

static inline void fadd(const FieldCtx &f, const u64 *a, const u64 *b, u64 *out) {
    u64 carry = u256_add(out, a, b);
    if (carry || u256_cmp(out, f.mod) >= 0) u256_sub(out, out, f.mod);
}

static inline void fsub(const FieldCtx &f, const u64 *a, const u64 *b, u64 *out) {
    if (u256_sub(out, a, b)) u256_add(out, out, f.mod);
}

static inline void fneg(const FieldCtx &f, const u64 *a, u64 *out) {
    if (u256_is_zero(a)) {
        memset(out, 0, 32);
    } else {
        u256_sub(out, f.mod, a);
    }
}

static inline void fdbl(const FieldCtx &f, const u64 *a, u64 *out) { fadd(f, a, a, out); }

static inline void to_mont(const FieldCtx &f, const u64 *a, u64 *out) { fmul(f, a, f.r2, out); }
static inline void from_mont(const FieldCtx &f, const u64 *a, u64 *out) {
    u64 one[4] = {1, 0, 0, 0};
    fmul(f, a, one, out);
}

// Fermat inverse (exponent = N - 2); only used a handful of times per call
// via the batch-inversion trick, so square-and-multiply is fine.
static void finv(const FieldCtx &f, const u64 *a, u64 *out) {
    u64 e[4];
    u64 two[4] = {2, 0, 0, 0};
    u256_sub(e, f.mod, two);
    u64 acc[4], base[4];
    memcpy(acc, f.r1, 32);
    memcpy(base, a, 32);
    for (int limb = 0; limb < 4; ++limb) {
        u64 bits = e[limb];
        for (int i = 0; i < 64; ++i) {
            if ((bits >> i) & 1) fmul(f, acc, base, acc);
            fsqr(f, base, base);
        }
    }
    memcpy(out, acc, 32);
}

// ---------------------------------------------------------------------------
// Field-element abstraction so point formulas template over Fp and Fq2
// ---------------------------------------------------------------------------

// Prime-field element wrapper
struct FpOps {
    static const int WORDS = 4;
    const FieldCtx *f;
    explicit FpOps(const FieldCtx *f_) : f(f_) {}
    void mul(const u64 *a, const u64 *b, u64 *o) const { fmul(*f, a, b, o); }
    void sqr(const u64 *a, u64 *o) const { fsqr(*f, a, o); }
    void add(const u64 *a, const u64 *b, u64 *o) const { fadd(*f, a, b, o); }
    void sub(const u64 *a, const u64 *b, u64 *o) const { fsub(*f, a, b, o); }
    void neg(const u64 *a, u64 *o) const { fneg(*f, a, o); }
    void dbl(const u64 *a, u64 *o) const { fdbl(*f, a, o); }
    bool is_zero(const u64 *a) const { return u256_is_zero(a); }
    void one(u64 *o) const { memcpy(o, f->r1, 32); }  // Montgomery 1
    void inv(const u64 *a, u64 *o) const { finv(*f, a, o); }
    void set(u64 *o, const u64 *a) const { memcpy(o, a, 32); }
    void zero(u64 *o) const { memset(o, 0, 32); }
};

// Fq2 = Fq[u]/(u^2+1) for BN254 G2 (halo2curves bn256/fq2.rs layout: c0, c1)
struct Fq2Ops {
    static const int WORDS = 8;
    const FieldCtx *f;
    explicit Fq2Ops(const FieldCtx *f_) : f(f_) {}
    void mul(const u64 *a, const u64 *b, u64 *o) const {
        u64 m0[4], m1[4], s0[4], s1[4], m2[4];
        fmul(*f, a, b, m0);           // a0*b0
        fmul(*f, a + 4, b + 4, m1);   // a1*b1
        fadd(*f, a, a + 4, s0);
        fadd(*f, b, b + 4, s1);
        fmul(*f, s0, s1, m2);         // (a0+a1)(b0+b1)
        u64 re[4];
        fsub(*f, m0, m1, re);         // a0b0 - a1b1
        fsub(*f, m2, m0, m2);
        fsub(*f, m2, m1, o + 4);      // a0b1 + a1b0
        memcpy(o, re, 32);
    }
    void sqr(const u64 *a, u64 *o) const {
        // (a0+a1)(a0-a1), 2*a0*a1
        u64 s[4], d[4], re[4];
        fadd(*f, a, a + 4, s);
        fsub(*f, a, a + 4, d);
        u64 im[4];
        fmul(*f, a, a + 4, im);
        fmul(*f, s, d, re);
        fdbl(*f, im, o + 4);
        memcpy(o, re, 32);
    }
    void add(const u64 *a, const u64 *b, u64 *o) const {
        fadd(*f, a, b, o);
        fadd(*f, a + 4, b + 4, o + 4);
    }
    void sub(const u64 *a, const u64 *b, u64 *o) const {
        fsub(*f, a, b, o);
        fsub(*f, a + 4, b + 4, o + 4);
    }
    void neg(const u64 *a, u64 *o) const {
        fneg(*f, a, o);
        fneg(*f, a + 4, o + 4);
    }
    void dbl(const u64 *a, u64 *o) const {
        fdbl(*f, a, o);
        fdbl(*f, a + 4, o + 4);
    }
    bool is_zero(const u64 *a) const { return u256_is_zero(a) && u256_is_zero(a + 4); }
    void one(u64 *o) const {
        memcpy(o, f->r1, 32);
        memset(o + 4, 0, 32);
    }
    void inv(const u64 *a, u64 *o) const {
        // 1/(a0 + a1 u) = (a0 - a1 u) / (a0^2 + a1^2)
        u64 n0[4], n1[4], d[4], di[4];
        fsqr(*f, a, n0);
        fsqr(*f, a + 4, n1);
        fadd(*f, n0, n1, d);
        finv(*f, d, di);
        fmul(*f, a, di, o);
        u64 na1[4];
        fneg(*f, a + 4, na1);
        fmul(*f, na1, di, o + 4);
    }
    void set(u64 *o, const u64 *a) const { memcpy(o, a, 64); }
    void zero(u64 *o) const { memset(o, 0, 64); }
};

// ---------------------------------------------------------------------------
// Jacobian point ops, templated over the field (identity: Z == 0)
// ---------------------------------------------------------------------------

enum ACoeff { A_ZERO = 0, A_MINUS3 = 1 };

template <class F>
struct Point {
    u64 x[F::WORDS], y[F::WORDS], z[F::WORDS];
};

template <class F>
struct CurveOps {
    F f;
    int a_kind;
    CurveOps(const F &f_, int a_kind_) : f(f_), a_kind(a_kind_) {}

    typedef Point<F> P;

    void set_identity(P &p) const {
        f.zero(p.x);
        f.one(p.y);
        f.zero(p.z);
    }
    bool is_identity(const P &p) const { return f.is_zero(p.z); }

    void from_affine(P &p, const u64 *x, const u64 *y, bool is_inf) const {
        if (is_inf) {
            set_identity(p);
            return;
        }
        f.set(p.x, x);
        f.set(p.y, y);
        f.one(p.z);
    }

    // dbl-2007-bl; a = 0 or -3 specializations
    void dbl(const P &p, P &o) const {
        if (is_identity(p)) {
            o = p;
            return;
        }
        u64 XX[F::WORDS], YY[F::WORDS], YYYY[F::WORDS], ZZ[F::WORDS];
        u64 S[F::WORDS], M[F::WORDS], T[F::WORDS], t0[F::WORDS], t1[F::WORDS];
        f.sqr(p.x, XX);
        f.sqr(p.y, YY);
        f.sqr(YY, YYYY);
        f.sqr(p.z, ZZ);
        f.add(p.x, YY, t0);
        f.sqr(t0, S);
        f.sub(S, XX, S);
        f.sub(S, YYYY, S);
        f.dbl(S, S);
        f.dbl(XX, M);
        f.add(M, XX, M);  // 3*XX
        if (a_kind == A_MINUS3) {
            // M = 3XX - 3*ZZ^2
            u64 Z4[F::WORDS];
            f.sqr(ZZ, Z4);
            f.dbl(Z4, t0);
            f.add(t0, Z4, t0);  // 3*Z^4
            f.sub(M, t0, M);
        }
        f.sqr(M, T);
        f.dbl(S, t0);
        f.sub(T, t0, T);  // T = M^2 - 2S
        // Z3 = (Y+Z)^2 - YY - ZZ  (before writing o.y/o.x: o may alias p)
        u64 z3[F::WORDS];
        f.add(p.y, p.z, t0);
        f.sqr(t0, t0);
        f.sub(t0, YY, t0);
        f.sub(t0, ZZ, z3);
        // Y3 = M*(S-T) - 8*YYYY
        f.sub(S, T, t0);
        f.mul(M, t0, t1);
        u64 e8[F::WORDS];
        f.dbl(YYYY, e8);
        f.dbl(e8, e8);
        f.dbl(e8, e8);
        f.sub(t1, e8, o.y);
        f.set(o.z, z3);
        f.set(o.x, T);
    }

    // mixed add (q affine, never infinity), madd-2007-bl with branches
    void madd(const P &p, const u64 *qx, const u64 *qy, P &o) const {
        if (is_identity(p)) {
            from_affine(o, qx, qy, false);
            return;
        }
        u64 Z1Z1[F::WORDS], U2[F::WORDS], S2[F::WORDS], H[F::WORDS], r[F::WORDS];
        u64 t0[F::WORDS], t1[F::WORDS];
        f.sqr(p.z, Z1Z1);
        f.mul(qx, Z1Z1, U2);
        f.mul(qy, p.z, t0);
        f.mul(t0, Z1Z1, S2);
        f.sub(U2, p.x, H);
        f.sub(S2, p.y, r);
        if (f.is_zero(H)) {
            if (f.is_zero(r)) {
                dbl(p, o);
            } else {
                set_identity(o);
            }
            return;
        }
        u64 HH[F::WORDS], I[F::WORDS], J[F::WORDS], rr[F::WORDS], V[F::WORDS];
        f.sqr(H, HH);
        f.dbl(HH, I);
        f.dbl(I, I);  // 4*HH
        f.mul(H, I, J);
        f.dbl(r, rr);
        f.mul(p.x, I, V);
        // X3 = rr^2 - J - 2V
        f.sqr(rr, t0);
        f.sub(t0, J, t0);
        f.dbl(V, t1);
        f.sub(t0, t1, o.x);
        // Y3 = rr*(V - X3) - 2*Y1*J
        f.sub(V, o.x, t0);
        f.mul(rr, t0, t0);
        f.mul(p.y, J, t1);
        f.dbl(t1, t1);
        f.sub(t0, t1, o.y);
        // Z3 = (Z1+H)^2 - Z1Z1 - HH
        f.add(p.z, H, t0);
        f.sqr(t0, t0);
        f.sub(t0, Z1Z1, t0);
        f.sub(t0, HH, o.z);
    }

    // full Jacobian add (add-2007-bl) with branches
    void add(const P &p, const P &q, P &o) const {
        if (is_identity(p)) {
            o = q;
            return;
        }
        if (is_identity(q)) {
            o = p;
            return;
        }
        u64 Z1Z1[F::WORDS], Z2Z2[F::WORDS], U1[F::WORDS], U2[F::WORDS];
        u64 S1[F::WORDS], S2[F::WORDS], H[F::WORDS], r[F::WORDS], t0[F::WORDS], t1[F::WORDS];
        f.sqr(p.z, Z1Z1);
        f.sqr(q.z, Z2Z2);
        f.mul(p.x, Z2Z2, U1);
        f.mul(q.x, Z1Z1, U2);
        f.mul(p.y, q.z, t0);
        f.mul(t0, Z2Z2, S1);
        f.mul(q.y, p.z, t0);
        f.mul(t0, Z1Z1, S2);
        f.sub(U2, U1, H);
        f.sub(S2, S1, r);
        if (f.is_zero(H)) {
            if (f.is_zero(r)) {
                dbl(p, o);
            } else {
                set_identity(o);
            }
            return;
        }
        u64 I[F::WORDS], J[F::WORDS], rr[F::WORDS], V[F::WORDS];
        f.dbl(H, t0);
        f.sqr(t0, I);
        f.mul(H, I, J);
        f.dbl(r, rr);
        f.mul(U1, I, V);
        f.sqr(rr, t0);
        f.sub(t0, J, t0);
        f.dbl(V, t1);
        f.sub(t0, t1, o.x);
        f.sub(V, o.x, t0);
        f.mul(rr, t0, t0);
        f.mul(S1, J, t1);
        f.dbl(t1, t1);
        f.sub(t0, t1, o.y);
        f.add(p.z, q.z, t0);
        f.sqr(t0, t0);
        f.sub(t0, Z1Z1, t0);
        f.sub(t0, Z2Z2, t0);
        f.mul(t0, H, o.z);
    }

    void neg(P &p) const { f.neg(p.y, p.y); }

    // Batch-normalize jacobian points to affine standard form (out: x,y per
    // point; identity -> zeros).  Montgomery batch inversion of Z.
    void batch_normalize(std::vector<P> &pts, u64 *out) const {
        size_t n = pts.size();
        const int W = F::WORDS;
        std::vector<u64> prefix((n + 1) * W);
        f.one(&prefix[0]);
        for (size_t i = 0; i < n; ++i) {
            const u64 *zi = pts[i].z;
            u64 tmp[F::WORDS];
            if (f.is_zero(zi)) {
                f.one(tmp);
                f.mul(&prefix[i * W], tmp, &prefix[(i + 1) * W]);
            } else {
                f.mul(&prefix[i * W], zi, &prefix[(i + 1) * W]);
            }
        }
        u64 total[F::WORDS];
        f.inv(&prefix[n * W], total);
        std::vector<u64> zinv(n * W);
        for (size_t i = n; i-- > 0;) {
            const u64 *zi = pts[i].z;
            if (f.is_zero(zi)) {
                f.zero(&zinv[i * W]);  // unused
            } else {
                f.mul(total, &prefix[i * W], &zinv[i * W]);
                f.mul(total, zi, total);
            }
        }
        for (size_t i = 0; i < n; ++i) {
            u64 *ox = out + i * 2 * W;
            u64 *oy = ox + W;
            if (f.is_zero(pts[i].z)) {
                memset(ox, 0, 2 * W * 8);
                continue;
            }
            u64 zi2[F::WORDS], zi3[F::WORDS], xm[F::WORDS], ym[F::WORDS];
            f.sqr(&zinv[i * W], zi2);
            f.mul(zi2, &zinv[i * W], zi3);
            f.mul(pts[i].x, zi2, xm);
            f.mul(pts[i].y, zi3, ym);
            // from Montgomery per base-field word group
            for (int wgrp = 0; wgrp < W / 4; ++wgrp) {
                from_mont(*f.f, xm + wgrp * 4, ox + wgrp * 4);
                from_mont(*f.f, ym + wgrp * 4, oy + wgrp * 4);
            }
        }
    }
};

// ---------------------------------------------------------------------------
// Scalar recoding (signed windows)
// ---------------------------------------------------------------------------

static inline u32 scalar_window(const u64 *k, int bit, int c) {
    // extract c bits starting at `bit` (little-endian), bit+c may exceed 256
    int limb = bit >> 6;
    int off = bit & 63;
    u64 lo = k[limb] >> off;
    if (off + c > 64 && limb + 1 < 4) lo |= k[limb + 1] << (64 - off);
    return (u32)(lo & ((1u << c) - 1));
}

// Signed digits in [-(2^(c-1)-1), 2^(c-1)] stored as (mag, sign); the carry
// chain matches ops/msm.py scalar_digits_signed bit-for-bit.
struct SignedDigits {
    // mag in [0, 2^(c-1)], sign 0/1; max windows = ceil(256/3) + 1 = 87
    u32 mag[90];
    unsigned char sign[90];
    int W;
};

static void recode(const u64 *k, int c, SignedDigits &sd) {
    int W = (256 + c - 1) / c;
    u32 half = 1u << (c - 1);
    u32 full = 1u << c;
    u32 carry = 0;
    for (int w = 0; w < W; ++w) {
        u32 d = scalar_window(k, w * c, c) + carry;
        if (d > half) {
            sd.mag[w] = full - d;
            sd.sign[w] = 1;
            carry = 1;
        } else {
            sd.mag[w] = d;
            sd.sign[w] = 0;
            carry = 0;
        }
    }
    sd.mag[W] = carry;
    sd.sign[W] = 0;
    sd.W = W + 1;
}

// ---------------------------------------------------------------------------
// Fixed-base batch multiplication
// ---------------------------------------------------------------------------

template <class F>
static void fixed_base_impl(const CurveOps<F> &ops, const u64 *base_xy, const u64 *scalars,
                            size_t n, u64 *out, int nthreads, int c) {
    typedef Point<F> P;
    const int W = F::WORDS;
    int nwin = (256 + c - 1) / c + 1;
    u32 half = 1u << (c - 1);

    // table[w][d-1] = d * 2^{cw} * B for d in 1..half (Jacobian)
    std::vector<P> table((size_t)nwin * half);
    P cur;
    bool base_inf = true;
    for (int j = 0; j < 2 * W; ++j)
        if (base_xy[j]) { base_inf = false; break; }
    // base affine -> Montgomery
    u64 bx[F::WORDS], by[F::WORDS];
    for (int g = 0; g < W / 4; ++g) {
        to_mont(*ops.f.f, base_xy + g * 4, bx + g * 4);
        to_mont(*ops.f.f, base_xy + W + g * 4, by + g * 4);
    }
    ops.from_affine(cur, bx, by, base_inf);
    for (int w = 0; w < nwin; ++w) {
        P acc = cur;
        table[(size_t)w * half + 0] = acc;
        for (u32 d = 2; d <= half; ++d) {
            ops.add(acc, cur, acc);
            table[(size_t)w * half + (d - 1)] = acc;
        }
        // cur = 2^c * cur
        for (int i = 0; i < c; ++i) ops.dbl(cur, cur);
    }

    int T = nthreads > 1 ? nthreads : 1;
    std::vector<P> results(n);
    auto worker = [&](size_t lo, size_t hi) {
        SignedDigits sd;
        for (size_t i = lo; i < hi; ++i) {
            recode(scalars + i * 4, c, sd);
            P acc;
            ops.set_identity(acc);
            for (int w = 0; w < sd.W && w < nwin; ++w) {
                if (!sd.mag[w]) continue;
                const P &e = table[(size_t)w * half + (sd.mag[w] - 1)];
                if (sd.sign[w]) {
                    P en = e;
                    ops.neg(en);
                    ops.add(acc, en, acc);
                } else {
                    ops.add(acc, e, acc);
                }
            }
            results[i] = acc;
        }
    };
    if (T == 1 || n < 64) {
        worker(0, n);
    } else {
        std::vector<std::thread> ths;
        size_t chunk = (n + T - 1) / T;
        for (int t = 0; t < T; ++t) {
            size_t lo = t * chunk, hi = lo + chunk < n ? lo + chunk : n;
            if (lo >= hi) break;
            ths.emplace_back(worker, lo, hi);
        }
        for (auto &th : ths) th.join();
    }
    ops.batch_normalize(results, out);
}

// ---------------------------------------------------------------------------
// Pippenger MSM
// ---------------------------------------------------------------------------

static int pippenger_c(size_t n) {
    int c = 3;
    size_t t = n;
    while (t >>= 1) ++c;  // ~log2(n) + 3
    c -= 3;
    if (c < 3) c = 3;
    if (c > 16) c = 16;
    return c;
}

template <class F>
static void msm_impl(const CurveOps<F> &ops, const u64 *pts, const u64 *scalars, size_t n,
                     u64 *out, int nthreads) {
    typedef Point<F> P;
    const int W = F::WORDS;
    int c = pippenger_c(n);
    int nwin = (256 + c - 1) / c + 1;
    u32 half = 1u << (c - 1);

    // Montgomery-form affine copies (+ infinity flags)
    std::vector<u64> mx(n * W), my(n * W);
    std::vector<unsigned char> inf(n);
    for (size_t i = 0; i < n; ++i) {
        const u64 *px = pts + i * 2 * W;
        const u64 *py = px + W;
        bool is_inf = true;
        for (int j = 0; j < 2 * W; ++j)
            if (px[j]) { is_inf = false; break; }
        inf[i] = is_inf;
        if (!is_inf) {
            for (int g = 0; g < W / 4; ++g) {
                to_mont(*ops.f.f, px + g * 4, &mx[i * W + g * 4]);
                to_mont(*ops.f.f, py + g * 4, &my[i * W + g * 4]);
            }
        }
    }
    // per-point signed digits
    std::vector<u32> dig((size_t)n * nwin);
    std::vector<unsigned char> sgn((size_t)n * nwin);
    {
        SignedDigits sd;
        for (size_t i = 0; i < n; ++i) {
            recode(scalars + i * 4, c, sd);
            for (int w = 0; w < nwin; ++w) {
                dig[i * nwin + w] = w < sd.W ? sd.mag[w] : 0;
                sgn[i * nwin + w] = w < sd.W ? sd.sign[w] : 0;
            }
        }
    }

    std::vector<P> window_sums(nwin);
    auto window_worker = [&](int w) {
        std::vector<P> buckets(half);
        std::vector<unsigned char> used(half, 0);
        for (size_t i = 0; i < n; ++i) {
            if (inf[i]) continue;
            u32 d = dig[i * nwin + w];
            if (!d) continue;
            u32 b = d - 1;
            if (!used[b]) {
                ops.from_affine(buckets[b], &mx[i * W], &my[i * W], false);
                if (sgn[i * nwin + w]) ops.neg(buckets[b]);
                used[b] = 1;
            } else if (sgn[i * nwin + w]) {
                u64 ny[F::WORDS];
                ops.f.neg(&my[i * W], ny);
                ops.madd(buckets[b], &mx[i * W], ny, buckets[b]);
            } else {
                ops.madd(buckets[b], &mx[i * W], &my[i * W], buckets[b]);
            }
        }
        // suffix sums: sum_d d*bucket[d]
        P running, acc;
        ops.set_identity(running);
        ops.set_identity(acc);
        for (int b = (int)half - 1; b >= 0; --b) {
            if (used[b]) ops.add(running, buckets[b], running);
            ops.add(acc, running, acc);
        }
        window_sums[w] = acc;
    };

    int T = nthreads > 1 ? nthreads : 1;
    if (T == 1) {
        for (int w = 0; w < nwin; ++w) window_worker(w);
    } else {
        std::vector<std::thread> ths;
        std::atomic_int next{0};
        for (int t = 0; t < T; ++t)
            ths.emplace_back([&]() {
                for (;;) {
                    int w = next.fetch_add(1);
                    if (w >= nwin) return;
                    window_worker(w);
                }
            });
        for (auto &th : ths) th.join();
    }

    // Horner combine, top window first
    P res;
    ops.set_identity(res);
    for (int w = nwin - 1; w >= 0; --w) {
        for (int i = 0; i < c && w != nwin - 1; ++i) ops.dbl(res, res);
        ops.add(res, window_sums[w], res);
    }
    std::vector<P> single(1, res);
    ops.batch_normalize(single, out);
}

// ---------------------------------------------------------------------------
// Curve registry + C ABI
// ---------------------------------------------------------------------------

// moduli (little-endian 64-bit limbs)
static const u64 BN254_FQ[4] = {0x3c208c16d87cfd47ull, 0x97816a916871ca8dull,
                                0xb85045b68181585dull, 0x30644e72e131a029ull};
static const u64 P256_FP[4] = {0xffffffffffffffffull, 0x00000000ffffffffull,
                               0x0000000000000000ull, 0xffffffff00000001ull};
static const u64 T256_FP[4] = {0x93135661b1c4b117ull, 0x7e72b42b30e73177ull,
                               0x0000000000000001ull, 0xffffffff00000001ull};

struct CurveEntry {
    FieldCtx field;
    int a_kind;
    bool init = false;
};

static CurveEntry g_curves[3];
static FieldCtx g_bn254_fq;
static bool g_g2_init = false;

static CurveEntry *get_curve(int id) {
    if (id < 0 || id > 2) return nullptr;
    CurveEntry &e = g_curves[id];
    if (!e.init) {
        const u64 *mod = id == 0 ? BN254_FQ : (id == 1 ? P256_FP : T256_FP);
        field_init(e.field, mod);
        e.a_kind = id == 0 ? A_ZERO : A_MINUS3;
        e.init = true;
    }
    return &e;
}

static FieldCtx *get_g2_field() {
    if (!g_g2_init) {
        field_init(g_bn254_fq, BN254_FQ);
        g_g2_init = true;
    }
    return &g_bn254_fq;
}

extern "C" {

// out: n * 2 * 4 u64 (affine x,y standard form; identity -> zeros)
int cn_fixed_base(int curve_id, const u64 *base_xy, const u64 *scalars, size_t n, u64 *out,
                  int nthreads) {
    CurveEntry *e = get_curve(curve_id);
    if (!e) return -1;
    FpOps f(&e->field);
    CurveOps<FpOps> ops(f, e->a_kind);
    fixed_base_impl(ops, base_xy, scalars, n, out, nthreads, 8);
    return 0;
}

int cn_msm(int curve_id, const u64 *pts, const u64 *scalars, size_t n, u64 *out, int nthreads) {
    CurveEntry *e = get_curve(curve_id);
    if (!e) return -1;
    FpOps f(&e->field);
    CurveOps<FpOps> ops(f, e->a_kind);
    msm_impl(ops, pts, scalars, n, out, nthreads);
    return 0;
}

// G2: points are 8 u64 per coordinate pair component -> 16 u64 per point
int cn_fixed_base_g2(const u64 *base, const u64 *scalars, size_t n, u64 *out, int nthreads) {
    Fq2Ops f(get_g2_field());
    CurveOps<Fq2Ops> ops(f, A_ZERO);
    fixed_base_impl(ops, base, scalars, n, out, nthreads, 8);
    return 0;
}

int cn_msm_g2(const u64 *pts, const u64 *scalars, size_t n, u64 *out, int nthreads) {
    Fq2Ops f(get_g2_field());
    CurveOps<Fq2Ops> ops(f, A_ZERO);
    msm_impl(ops, pts, scalars, n, out, nthreads);
    return 0;
}

// batched independent scalar muls (variable bases): out[i] = k[i] * P[i]
int cn_mul_many(int curve_id, const u64 *pts, const u64 *scalars, size_t n, u64 *out,
                int nthreads) {
    CurveEntry *e = get_curve(curve_id);
    if (!e) return -1;
    FpOps f(&e->field);
    CurveOps<FpOps> ops(f, e->a_kind);
    typedef Point<FpOps> P;
    std::vector<P> results(n);
    auto worker = [&](size_t lo, size_t hi) {
        SignedDigits sd;
        for (size_t i = lo; i < hi; ++i) {
            const u64 *px = pts + i * 8;
            bool is_inf = true;
            for (int j = 0; j < 8; ++j)
                if (px[j]) { is_inf = false; break; }
            P acc;
            ops.set_identity(acc);
            if (is_inf) {
                results[i] = acc;
                continue;
            }
            u64 mxx[4], myy[4];
            to_mont(e->field, px, mxx);
            to_mont(e->field, px + 4, myy);
            // double-and-add, 4-bit windows
            recode(scalars + i * 4, 4, sd);
            // precompute 1..8 multiples
            P tab[8];
            ops.from_affine(tab[0], mxx, myy, false);
            for (int d = 1; d < 8; ++d) ops.madd(tab[d - 1], mxx, myy, tab[d]);
            for (int w = sd.W - 1; w >= 0; --w) {
                if (w != sd.W - 1)
                    for (int b = 0; b < 4; ++b) ops.dbl(acc, acc);
                if (sd.mag[w]) {
                    P ee = tab[sd.mag[w] - 1];
                    if (sd.sign[w]) ops.neg(ee);
                    ops.add(acc, ee, acc);
                }
            }
            results[i] = acc;
        }
    };
    int T = nthreads > 1 ? nthreads : 1;
    if (T == 1 || n < 16) {
        worker(0, n);
    } else {
        std::vector<std::thread> ths;
        size_t chunk = (n + T - 1) / T;
        for (int t = 0; t < T; ++t) {
            size_t lo = t * chunk, hi = lo + chunk < n ? lo + chunk : n;
            if (lo >= hi) break;
            ths.emplace_back(worker, lo, hi);
        }
        for (auto &th : ths) th.join();
    }
    ops.batch_normalize(results, out);
    return 0;
}

// ---------------------------------------------------------------------------
// Generic modular vector kernels (host-side witness/QAP/sumcheck work).
// All values standard form (non-Montgomery) LE 4xu64; modulus passed per call.
// ---------------------------------------------------------------------------

// out[out_idx[k]] += coeff[k] * x[in_idx[k]]  (mod N), k = 0..nnz-1.
// Used for R1CS matvec a = Az (out_idx = constraint row) and its transpose
// in QAP evaluation A_i(t) (out_idx = variable, x = Lagrange coeffs) —
// forks/groth16/src/r1cs_to_qap.rs semantics.  `out` must be zeroed by the
// caller (or carry a previous standard-form accumulation).
int cn_coo_matvec(const u64 *mod, size_t nnz, const u32 *out_idx, const u32 *in_idx,
                  const u64 *coeff, const u64 *x, u64 *out, size_t n_out) {
    FieldCtx f;
    field_init(f, mod);
    // accumulate c*z*R^{-1}; fix with one *R^2 Montgomery mul at the end
    std::vector<u64> acc(n_out * 4, 0);
    // convert existing out to the same domain: acc = out * R^{-1}*R = treat
    // out as standard and multiply by R^{-2}... simpler: require zeroed out,
    // or fold prior value by mont_mul(out, one) = out*R^{-1}
    u64 one[4] = {1, 0, 0, 0};
    for (size_t i = 0; i < n_out; ++i) {
        if (!u256_is_zero(out + i * 4)) fmul(f, out + i * 4, one, &acc[i * 4]);
    }
    for (size_t k = 0; k < nnz; ++k) {
        u64 p[4];
        fmul(f, coeff + k * 4, x + (size_t)in_idx[k] * 4, p);  // c*z*R^{-1}
        fadd(f, &acc[(size_t)out_idx[k] * 4], p, &acc[(size_t)out_idx[k] * 4]);
    }
    for (size_t i = 0; i < n_out; ++i) fmul(f, &acc[i * 4], f.r2, out + i * 4);
    return 0;
}

// Lagrange basis at tau: out[j] = factor * w^j / (t - w^j), j = 0..n-1,
// with factor = (t^n - 1)/n precomputed by the caller (models/groth16.py
// _lagrange_coeffs_at).
int cn_lagrange_at(const u64 *mod, const u64 *w_std, const u64 *t_std,
                   const u64 *factor_std, size_t n, u64 *out) {
    FieldCtx f;
    field_init(f, mod);
    u64 w[4], t[4], factor[4];
    to_mont(f, w_std, w);
    to_mont(f, t_std, t);
    to_mont(f, factor_std, factor);
    std::vector<u64> nums(n * 4), dens(n * 4), prefix((n + 1) * 4);
    u64 wj[4];
    memcpy(wj, f.r1, 32);  // 1 in Montgomery
    memcpy(&prefix[0], f.r1, 32);
    for (size_t j = 0; j < n; ++j) {
        fmul(f, factor, wj, &nums[j * 4]);
        fsub(f, t, wj, &dens[j * 4]);
        fmul(f, &prefix[j * 4], &dens[j * 4], &prefix[(j + 1) * 4]);
        fmul(f, wj, w, wj);
    }
    u64 total[4];
    finv(f, &prefix[n * 4], total);
    for (size_t j = n; j-- > 0;) {
        u64 inv_j[4];
        fmul(f, total, &prefix[j * 4], inv_j);
        fmul(f, total, &dens[j * 4], total);
        u64 lm[4];
        fmul(f, &nums[j * 4], inv_j, lm);
        from_mont(f, lm, out + j * 4);
    }
    return 0;
}

// Elementwise vector ops, standard form: op 0 = mul, 1 = add, 2 = sub.
int cn_vec_op(const u64 *mod, int op, const u64 *a, const u64 *b, size_t n, u64 *out) {
    FieldCtx f;
    field_init(f, mod);
    if (op == 0) {
        for (size_t i = 0; i < n; ++i) {
            u64 m[4];
            fmul(f, a + i * 4, b + i * 4, m);       // a*b*R^{-1}
            fmul(f, m, f.r2, out + i * 4);          // *R^2*R^{-1} = a*b
        }
    } else if (op == 1) {
        for (size_t i = 0; i < n; ++i) fadd(f, a + i * 4, b + i * 4, out + i * 4);
    } else if (op == 2) {
        for (size_t i = 0; i < n; ++i) fsub(f, a + i * 4, b + i * 4, out + i * 4);
    } else {
        return -1;
    }
    return 0;
}

// Batch inversion, standard form; zeros map to zero.
int cn_batch_inv(const u64 *mod, const u64 *a, size_t n, u64 *out) {
    FieldCtx f;
    field_init(f, mod);
    std::vector<u64> prefix((n + 1) * 4), am(n * 4);
    memcpy(&prefix[0], f.r1, 32);
    for (size_t i = 0; i < n; ++i) {
        if (u256_is_zero(a + i * 4)) {
            memcpy(&am[i * 4], f.r1, 32);  // placeholder 1
        } else {
            to_mont(f, a + i * 4, &am[i * 4]);
        }
        fmul(f, &prefix[i * 4], &am[i * 4], &prefix[(i + 1) * 4]);
    }
    u64 total[4];
    finv(f, &prefix[n * 4], total);
    for (size_t i = n; i-- > 0;) {
        u64 inv_i[4];
        fmul(f, total, &prefix[i * 4], inv_i);
        fmul(f, total, &am[i * 4], total);
        if (u256_is_zero(a + i * 4)) {
            memset(out + i * 4, 0, 32);
        } else {
            from_mont(f, inv_i, out + i * 4);
        }
    }
    return 0;
}

// out[j] = scale * base^j, standard form.
int cn_powers(const u64 *mod, const u64 *base_std, const u64 *scale_std, size_t n, u64 *out) {
    FieldCtx f;
    field_init(f, mod);
    u64 b[4], acc[4];
    to_mont(f, base_std, b);
    to_mont(f, scale_std, acc);
    for (size_t j = 0; j < n; ++j) {
        from_mont(f, acc, out + j * 4);
        fmul(f, acc, b, acc);
    }
    return 0;
}

// ---------------------------------------------------------------------------
// Spartan sumcheck hot loops (forks/Spartan-t256/src/sumcheck.rs:430-778).
// The prover's per-round work is O(n) field math over the full evaluation
// tables; these run it natively (standard-form u64x4 in/out, threaded).
// ---------------------------------------------------------------------------

static void parallel_chunks(size_t n, int nthreads,
                            const std::function<void(size_t, size_t, int)> &body) {
    int T = nthreads > 1 ? nthreads : 1;
    if (T == 1 || n < 4096) {
        body(0, n, 0);
        return;
    }
    std::vector<std::thread> ths;
    size_t chunk = (n + T - 1) / T;
    for (int t = 0; t < T; ++t) {
        size_t lo = t * chunk, hi = lo + chunk < n ? lo + chunk : n;
        if (lo >= hi) break;
        ths.emplace_back(body, lo, hi, t);
    }
    for (auto &th : ths) th.join();
}

// Round evals for sum_x A(x)*B(x): out = (e0, e2) with
//   e0 = sum_i A_lo[i]*B_lo[i],
//   e2 = sum_i (2*A_hi[i]-A_lo[i]) * (2*B_hi[i]-B_lo[i]).
// A/B are length 2*half (lo = [0,half), hi = [half,2*half)).
int cn_sumcheck_quad(const u64 *mod, size_t half, const u64 *A, const u64 *B,
                     u64 *out, int nthreads) {
    FieldCtx f;
    field_init(f, mod);
    int T = nthreads > 1 ? nthreads : 1;
    std::vector<u64> acc(T * 8, 0);
    parallel_chunks(half, nthreads, [&](size_t lo, size_t hi, int t) {
        u64 *e0 = &acc[t * 8], *e2 = &acc[t * 8 + 4];
        for (size_t i = lo; i < hi; ++i) {
            const u64 *al = A + i * 4, *ah = A + (half + i) * 4;
            const u64 *bl = B + i * 4, *bh = B + (half + i) * 4;
            u64 p[4], a2[4], b2[4];
            fmul(f, al, bl, p);            // al*bl*R^{-1}
            fadd(f, e0, p, e0);
            fadd(f, ah, ah, a2); fsub(f, a2, al, a2);
            fadd(f, bh, bh, b2); fsub(f, b2, bl, b2);
            fmul(f, a2, b2, p);
            fadd(f, e2, p, e2);
        }
    });
    u64 e0[4] = {0, 0, 0, 0}, e2[4] = {0, 0, 0, 0};
    for (int t = 0; t < T; ++t) {
        fadd(f, e0, &acc[t * 8], e0);
        fadd(f, e2, &acc[t * 8 + 4], e2);
    }
    fmul(f, e0, f.r2, out);         // undo the deferred R^{-1}
    fmul(f, e2, f.r2, out + 4);
    return 0;
}

// Round evals for sum_x A(x)*(B(x)*C(x) - D(x)): out = (e0, e2, e3) at
// extension points 0, 2, 3 (sumcheck.rs prove_cubic_with_additive_term).
int cn_sumcheck_cubic(const u64 *mod, size_t half, const u64 *A, const u64 *B,
                      const u64 *C, const u64 *D, u64 *out, int nthreads) {
    FieldCtx f;
    field_init(f, mod);
    int T = nthreads > 1 ? nthreads : 1;
    std::vector<u64> acc(T * 12, 0);
    parallel_chunks(half, nthreads, [&](size_t lo, size_t hi, int t) {
        u64 *e0 = &acc[t * 12], *e2 = &acc[t * 12 + 4], *e3 = &acc[t * 12 + 8];
        for (size_t i = lo; i < hi; ++i) {
            u64 am[4], bm[4], cm[4], dm[4], ad[4], bd[4], cd[4], dd[4];
            u64 bc[4], tsum[4], p[4];
            const u64 *al = A + i * 4, *ah = A + (half + i) * 4;
            const u64 *bl = B + i * 4, *bh = B + (half + i) * 4;
            const u64 *cl = C + i * 4, *ch = C + (half + i) * 4;
            const u64 *dl = D + i * 4, *dh = D + (half + i) * 4;
            to_mont(f, al, am); to_mont(f, bl, bm);
            to_mont(f, cl, cm); to_mont(f, dl, dm);
            // deltas (hi - lo) in Montgomery form drive both ext points
            u64 ahm[4], bhm[4], chm[4], dhm[4];
            to_mont(f, ah, ahm); to_mont(f, bh, bhm);
            to_mont(f, ch, chm); to_mont(f, dh, dhm);
            fsub(f, ahm, am, ad); fsub(f, bhm, bm, bd);
            fsub(f, chm, cm, cd); fsub(f, dhm, dm, dd);
            // e0 += a*(b*c - d)
            fmul(f, bm, cm, bc);
            fsub(f, bc, dm, tsum);
            fmul(f, am, tsum, p);
            fadd(f, e0, p, e0);
            // ext point 2: v2 = hi + delta; point 3: v3 = v2 + delta
            u64 a2[4], b2[4], c2[4], d2[4];
            fadd(f, ahm, ad, a2); fadd(f, bhm, bd, b2);
            fadd(f, chm, cd, c2); fadd(f, dhm, dd, d2);
            fmul(f, b2, c2, bc);
            fsub(f, bc, d2, tsum);
            fmul(f, a2, tsum, p);
            fadd(f, e2, p, e2);
            fadd(f, a2, ad, a2); fadd(f, b2, bd, b2);
            fadd(f, c2, cd, c2); fadd(f, d2, dd, d2);
            fmul(f, b2, c2, bc);
            fsub(f, bc, d2, tsum);
            fmul(f, a2, tsum, p);
            fadd(f, e3, p, e3);
        }
    });
    u64 e0[4] = {0, 0, 0, 0}, e2[4] = {0, 0, 0, 0}, e3[4] = {0, 0, 0, 0};
    for (int t = 0; t < T; ++t) {
        fadd(f, e0, &acc[t * 12], e0);
        fadd(f, e2, &acc[t * 12 + 4], e2);
        fadd(f, e3, &acc[t * 12 + 8], e3);
    }
    from_mont(f, e0, out);
    from_mont(f, e2, out + 4);
    from_mont(f, e3, out + 8);
    return 0;
}

// Bind the top multilinear variable: out[i] = lo[i] + r*(hi[i] - lo[i]),
// i = 0..half-1 (DensePolynomial::bound_poly_var_top).
int cn_bind_top(const u64 *mod, size_t half, const u64 *evals, const u64 *r_std,
                u64 *out, int nthreads) {
    FieldCtx f;
    field_init(f, mod);
    u64 rm[4];
    to_mont(f, r_std, rm);
    parallel_chunks(half, nthreads, [&](size_t lo, size_t hi, int) {
        for (size_t i = lo; i < hi; ++i) {
            u64 d[4], p[4];
            fsub(f, evals + (half + i) * 4, evals + i * 4, d);
            fmul(f, d, rm, p);                       // d*r (std: rm has R)
            fadd(f, evals + i * 4, p, out + i * 4);
        }
    });
    return 0;
}

// eq(x, r) table over x in {0,1}^m (EqPolynomial::evals): doubling build,
// out length 2^m, standard form.  rs: m scalars, top variable first.
int cn_eq_evals(const u64 *mod, const u64 *rs_std, size_t m, u64 *out) {
    FieldCtx f;
    field_init(f, mod);
    memcpy(out, f.r1, 32);  // start with [1] in Montgomery
    size_t n = 1;
    for (size_t v = 0; v < m; ++v) {
        u64 rm[4], one_minus_r[4];
        to_mont(f, rs_std + v * 4, rm);
        fsub(f, f.r1, rm, one_minus_r);
        for (size_t i = n; i-- > 0;) {
            u64 e[4];
            memcpy(e, out + i * 4, 32);
            fmul(f, e, one_minus_r, out + i * 4);
            fmul(f, e, rm, out + (n + i) * 4);
        }
        n *= 2;
    }
    for (size_t i = 0; i < n; ++i) {
        u64 v[4];
        from_mont(f, out + i * 4, v);
        memcpy(out + i * 4, v, 32);
    }
    return 0;
}

// Dot product sum_i a[i]*b[i] mod N, standard form.
int cn_dot(const u64 *mod, const u64 *a, const u64 *b, size_t n, u64 *out) {
    FieldCtx f;
    field_init(f, mod);
    u64 acc[4] = {0, 0, 0, 0};
    for (size_t i = 0; i < n; ++i) {
        u64 p[4];
        fmul(f, a + i * 4, b + i * 4, p);  // a*b*R^{-1}
        fadd(f, acc, p, acc);
    }
    fmul(f, acc, f.r2, out);
    return 0;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// BN254 pairing tower (verifier side; reference: ark-bn254 via
// forks/groth16/src/verifier.rs:44 and ark-poly-commit kzg10/mod.rs:357).
//
// Mirrors the host oracle core/pairing.py exactly: generic affine Miller
// loop over E(Fq12) with the D-type twist untwisting map, loop count 6u+2,
// two Frobenius correction lines, plain (p^12-1)/r final exponentiation.
// The pairing value is canonical, so matching the oracle's structure makes
// bit-exactness trivially checkable while still being ~1000x faster than
// Python bigints.
//
// Layouts (Montgomery form internally, standard form at the C ABI):
//   Fq2  = u64[8]   (c0, c1)
//   Fq6  = u64[24]  (c0, c1, c2 : Fq2)
//   Fq12 = u64[48]  (c0, c1 : Fq6)
// Frobenius coefficients and the hard-part exponent are supplied by Python
// at init (computed exactly in core/fields.py) — no bignum code needed here.
// ---------------------------------------------------------------------------

namespace pairing {

struct PairingCtx {
    FieldCtx fq;
    u64 frob_c1_6[6][8];    // Montgomery Fq2
    u64 frob_c2_6[6][8];
    u64 frob_c1_12[12][8];
    std::vector<u64> hard_exp;  // little-endian limbs of (p^4-p^2+1)/r
    bool init = false;
};

static PairingCtx g_ctx;

// --- Fq2 (beyond Fq2Ops: nonresidue, conjugate, frobenius) ---

static inline void fq2_mul(const FieldCtx &f, const u64 *a, const u64 *b, u64 *o) {
    Fq2Ops(&f).mul(a, b, o);
}
static inline void fq2_add(const FieldCtx &f, const u64 *a, const u64 *b, u64 *o) {
    Fq2Ops(&f).add(a, b, o);
}
static inline void fq2_sub(const FieldCtx &f, const u64 *a, const u64 *b, u64 *o) {
    Fq2Ops(&f).sub(a, b, o);
}
static inline void fq2_neg(const FieldCtx &f, const u64 *a, u64 *o) {
    Fq2Ops(&f).neg(a, o);
}
static inline void fq2_sqr(const FieldCtx &f, const u64 *a, u64 *o) {
    Fq2Ops(&f).sqr(a, o);
}
static inline void fq2_inv(const FieldCtx &f, const u64 *a, u64 *o) {
    Fq2Ops(&f).inv(a, o);
}

// x9 = 8x + x
static inline void fmul9(const FieldCtx &f, const u64 *a, u64 *o) {
    u64 t[4];
    fdbl(f, a, t);
    fdbl(f, t, t);
    fdbl(f, t, t);
    fadd(f, t, a, o);
}

// * (9 + u):  (9 a0 - a1, a0 + 9 a1)
static inline void fq2_mul_by_nonresidue(const FieldCtx &f, const u64 *a, u64 *o) {
    u64 n0[4], n1[4], t[4];
    fmul9(f, a, n0);
    fsub(f, n0, a + 4, t);
    fmul9(f, a + 4, n1);
    fadd(f, n1, a, o + 4);
    memcpy(o, t, 32);
}

static inline void fq2_frob(const FieldCtx &f, const u64 *a, int power, u64 *o) {
    memcpy(o, a, 32);
    if (power & 1)
        fneg(f, a + 4, o + 4);
    else
        memcpy(o + 4, a + 4, 32);
}

// --- Fq6 ---

static void fq6_add(const FieldCtx &f, const u64 *a, const u64 *b, u64 *o) {
    for (int i = 0; i < 3; ++i) fq2_add(f, a + 8 * i, b + 8 * i, o + 8 * i);
}
static void fq6_sub(const FieldCtx &f, const u64 *a, const u64 *b, u64 *o) {
    for (int i = 0; i < 3; ++i) fq2_sub(f, a + 8 * i, b + 8 * i, o + 8 * i);
}
static void fq6_neg(const FieldCtx &f, const u64 *a, u64 *o) {
    for (int i = 0; i < 3; ++i) fq2_neg(f, a + 8 * i, o + 8 * i);
}

// * v :  (c0, c1, c2) -> (xi*c2, c0, c1); alias-safe (a may equal o)
static void fq6_mul_by_nonresidue(const FieldCtx &f, const u64 *a, u64 *o) {
    u64 t[8], c0[8], c1[8];
    fq2_mul_by_nonresidue(f, a + 16, t);
    memcpy(c0, a, 64);
    memcpy(c1, a + 8, 64);
    memcpy(o, t, 64);
    memcpy(o + 8, c0, 64);
    memcpy(o + 16, c1, 64);
}

static void fq6_mul(const FieldCtx &f, const u64 *A, const u64 *B, u64 *o) {
    const u64 *a0 = A, *a1 = A + 8, *a2 = A + 16;
    const u64 *b0 = B, *b1 = B + 8, *b2 = B + 16;
    u64 t0[8], t1[8], t2[8], s0[8], s1[8], m[8], r0[8], r1[8], r2[8];
    fq2_mul(f, a0, b0, t0);
    fq2_mul(f, a1, b1, t1);
    fq2_mul(f, a2, b2, t2);
    // c0 = ((a1+a2)(b1+b2) - t1 - t2)*xi_v + t0
    fq2_add(f, a1, a2, s0);
    fq2_add(f, b1, b2, s1);
    fq2_mul(f, s0, s1, m);
    fq2_sub(f, m, t1, m);
    fq2_sub(f, m, t2, m);
    fq2_mul_by_nonresidue(f, m, r0);
    fq2_add(f, r0, t0, r0);
    // c1 = (a0+a1)(b0+b1) - t0 - t1 + xi*t2
    fq2_add(f, a0, a1, s0);
    fq2_add(f, b0, b1, s1);
    fq2_mul(f, s0, s1, m);
    fq2_sub(f, m, t0, m);
    fq2_sub(f, m, t1, m);
    u64 x2[8];
    fq2_mul_by_nonresidue(f, t2, x2);
    fq2_add(f, m, x2, r1);
    // c2 = (a0+a2)(b0+b2) - t0 - t2 + t1
    fq2_add(f, a0, a2, s0);
    fq2_add(f, b0, b2, s1);
    fq2_mul(f, s0, s1, m);
    fq2_sub(f, m, t0, m);
    fq2_sub(f, m, t2, m);
    fq2_add(f, m, t1, r2);
    memcpy(o, r0, 64);
    memcpy(o + 8, r1, 64);
    memcpy(o + 16, r2, 64);
}

static void fq6_sqr(const FieldCtx &f, const u64 *a, u64 *o) { fq6_mul(f, a, a, o); }

static void fq6_inv(const FieldCtx &f, const u64 *A, u64 *o) {
    const u64 *a0 = A, *a1 = A + 8, *a2 = A + 16;
    u64 t0[8], t1[8], t2[8], m[8], d[8], di[8];
    // t0 = a0^2 - xi*(a1*a2)
    fq2_sqr(f, a0, t0);
    fq2_mul(f, a1, a2, m);
    fq2_mul_by_nonresidue(f, m, m);
    fq2_sub(f, t0, m, t0);
    // t1 = xi*a2^2 - a0*a1
    fq2_sqr(f, a2, t1);
    fq2_mul_by_nonresidue(f, t1, t1);
    fq2_mul(f, a0, a1, m);
    fq2_sub(f, t1, m, t1);
    // t2 = a1^2 - a0*a2
    fq2_sqr(f, a1, t2);
    fq2_mul(f, a0, a2, m);
    fq2_sub(f, t2, m, t2);
    // d = xi*(a2*t1 + a1*t2) + a0*t0
    u64 u0[8], u1[8];
    fq2_mul(f, a2, t1, u0);
    fq2_mul(f, a1, t2, u1);
    fq2_add(f, u0, u1, d);
    fq2_mul_by_nonresidue(f, d, d);
    fq2_mul(f, a0, t0, m);
    fq2_add(f, d, m, d);
    fq2_inv(f, d, di);
    fq2_mul(f, t0, di, o);
    fq2_mul(f, t1, di, o + 8);
    fq2_mul(f, t2, di, o + 16);
}

static void fq6_frob(const PairingCtx &c, const u64 *a, int power, u64 *o) {
    const FieldCtx &f = c.fq;
    u64 t[8];
    fq2_frob(f, a, power, o);
    fq2_frob(f, a + 8, power, t);
    fq2_mul(f, t, c.frob_c1_6[power % 6], o + 8);
    fq2_frob(f, a + 16, power, t);
    fq2_mul(f, t, c.frob_c2_6[power % 6], o + 16);
}

// --- Fq12 ---

static void fq12_mul(const FieldCtx &f, const u64 *A, const u64 *B, u64 *o) {
    const u64 *a0 = A, *a1 = A + 24, *b0 = B, *b1 = B + 24;
    u64 t0[24], t1[24], s0[24], s1[24], m[24], r0[24], r1[24];
    fq6_mul(f, a0, b0, t0);
    fq6_mul(f, a1, b1, t1);
    fq6_mul_by_nonresidue(f, t1, r0);
    fq6_add(f, t0, r0, r0);
    fq6_add(f, a0, a1, s0);
    fq6_add(f, b0, b1, s1);
    fq6_mul(f, s0, s1, m);
    fq6_sub(f, m, t0, m);
    fq6_sub(f, m, t1, r1);
    memcpy(o, r0, 192);
    memcpy(o + 24, r1, 192);
}

static void fq12_sqr(const FieldCtx &f, const u64 *a, u64 *o) { fq12_mul(f, a, a, o); }

static void fq12_conj(const FieldCtx &f, const u64 *a, u64 *o) {
    memcpy(o, a, 192);
    fq6_neg(f, a + 24, o + 24);
}

static void fq12_one(const FieldCtx &f, u64 *o) {
    memset(o, 0, 384);
    memcpy(o, f.r1, 32);
}

static bool fq12_is_one(const FieldCtx &f, const u64 *a) {
    if (memcmp(a, f.r1, 32) != 0) return false;
    for (int i = 4; i < 48; ++i)
        if (a[i]) return false;
    return true;
}

static void fq12_inv(const FieldCtx &f, const u64 *A, u64 *o) {
    u64 t0[24], t1[24], ti[24];
    fq6_sqr(f, A, t0);
    fq6_sqr(f, A + 24, t1);
    fq6_mul_by_nonresidue(f, t1, t1);
    fq6_sub(f, t0, t1, t0);
    fq6_inv(f, t0, ti);
    fq6_mul(f, A, ti, o);
    fq6_mul(f, A + 24, ti, o + 24);
    fq6_neg(f, o + 24, o + 24);
}

static void fq12_frob(const PairingCtx &c, const u64 *a, int power, u64 *o) {
    const FieldCtx &f = c.fq;
    u64 c1[24];
    fq6_frob(c, a, power, o);
    fq6_frob(c, a + 24, power, c1);
    const u64 *g = c.frob_c1_12[power % 12];
    for (int i = 0; i < 3; ++i) fq2_mul(f, c1 + 8 * i, g, o + 24 + 8 * i);
}

// square-and-multiply over a little-endian multi-limb exponent
static void fq12_pow(const FieldCtx &f, const u64 *a, const std::vector<u64> &e, u64 *o) {
    u64 acc[48], base[48];
    fq12_one(f, acc);
    memcpy(base, a, 384);
    int top = (int)e.size() - 1;
    while (top >= 0 && e[top] == 0) --top;
    for (int limb = 0; limb <= top; ++limb) {
        u64 bits = e[limb];
        int nbits = (limb == top) ? 64 - __builtin_clzll(bits) : 64;
        for (int i = 0; i < nbits; ++i) {
            if ((bits >> i) & 1) fq12_mul(f, acc, base, acc);
            fq12_sqr(f, base, base);
        }
    }
    memcpy(o, acc, 384);
}

// --- E(Fq12) affine points + line evaluation (mirrors core/pairing.py) ---

struct Pt12 {
    u64 x[48], y[48];
    bool inf;
};

// line through t and q evaluated at (px, py); t <- t + q
static void add_eval(const PairingCtx &c, Pt12 &t, const Pt12 &q,
                     const u64 *px, const u64 *py, u64 *line) {
    const FieldCtx &f = c.fq;
    u64 lam[48], d[48], n[48];
    bool same_x = memcmp(t.x, q.x, 384) == 0;
    if (same_x && memcmp(t.y, q.y, 384) == 0) {
        // lam = 3 x^2 / 2 y
        u64 x2[48], three[48], two[48];
        fq12_sqr(f, t.x, x2);
        memset(three, 0, 384);
        memset(two, 0, 384);
        // 3, 2 in Montgomery form (slot c0.c0.c0)
        fadd(f, f.r1, f.r1, two);
        fadd(f, two, f.r1, three);
        fq12_mul(f, x2, three, n);
        fq12_mul(f, t.y, two, d);
        fq12_inv(f, d, d);
        fq12_mul(f, n, d, lam);
    } else if (same_x) {
        // t = -q: vertical line X - x1
        for (int i = 0; i < 48; i += 4) fsub(f, px + i, t.x + i, line + i);
        t.inf = true;
        return;
    } else {
        u64 dy[48], dx[48];
        for (int i = 0; i < 48; i += 4) fsub(f, q.y + i, t.y + i, dy + i);
        for (int i = 0; i < 48; i += 4) fsub(f, q.x + i, t.x + i, dx + i);
        fq12_inv(f, dx, dx);
        fq12_mul(f, dy, dx, lam);
    }
    // line = (py - y1) - lam*(px - x1)
    u64 pmx[48], pmy[48], lm[48];
    for (int i = 0; i < 48; i += 4) fsub(f, px + i, t.x + i, pmx + i);
    for (int i = 0; i < 48; i += 4) fsub(f, py + i, t.y + i, pmy + i);
    fq12_mul(f, lam, pmx, lm);
    for (int i = 0; i < 48; i += 4) fsub(f, pmy + i, lm + i, line + i);
    // x3 = lam^2 - x1 - x2 ; y3 = lam (x1 - x3) - y1
    u64 l2[48], x3[48], y3[48], t0[48];
    fq12_sqr(f, lam, l2);
    for (int i = 0; i < 48; i += 4) fsub(f, l2 + i, t.x + i, x3 + i);
    for (int i = 0; i < 48; i += 4) fsub(f, x3 + i, q.x + i, x3 + i);
    for (int i = 0; i < 48; i += 4) fsub(f, t.x + i, x3 + i, t0 + i);
    fq12_mul(f, lam, t0, y3);
    for (int i = 0; i < 48; i += 4) fsub(f, y3 + i, t.y + i, y3 + i);
    memcpy(t.x, x3, 384);
    memcpy(t.y, y3, 384);
}

// untwist (x, y) in E'(Fq2) -> E(Fq12): (x*w^2, y*w^3)
static void untwist(const PairingCtx &c, const u64 *g2, Pt12 &o) {
    const FieldCtx &f = c.fq;
    // x * w^2: w^2 = v -> Fq12(Fq6(0, x_fq2, 0), 0) ... multiply generically:
    // embed x as Fq12 then multiply by W2 constant = Fq12(Fq6(0,1,0),0)
    u64 xe[48], ye[48], w2[48], w3[48];
    memset(xe, 0, 384);
    memset(ye, 0, 384);
    memcpy(xe, g2, 64);        // x -> c0.c0
    memcpy(ye, g2 + 8, 64);    // y -> c0.c0
    memset(w2, 0, 384);
    memcpy(w2 + 8, f.r1, 32);  // c0.c1 = 1
    memset(w3, 0, 384);
    memcpy(w3 + 24 + 8, f.r1, 32);  // c1.c1 = 1
    fq12_mul(f, xe, w2, o.x);
    fq12_mul(f, ye, w3, o.y);
    o.inf = false;
}

static const u128 ATE_LOOP = (u128)6 * 4965661367192848881ull + 2;

// Miller loop f_{6u+2,Q}(P); P affine Montgomery (x, y), Q untwisted
static void miller_loop(const PairingCtx &c, const u64 *p_mont, const u64 *q_g2_mont,
                        u64 *out) {
    const FieldCtx &f = c.fq;
    u64 px[48], py[48];
    memset(px, 0, 384);
    memset(py, 0, 384);
    memcpy(px, p_mont, 32);
    memcpy(py, p_mont + 4, 32);

    Pt12 qt, t;
    untwist(c, q_g2_mont, qt);
    t = qt;

    u64 facc[48], line[48];
    fq12_one(f, facc);
    int top = 0;
    {
        u128 v = ATE_LOOP;
        while (v >> (top + 1)) ++top;
    }
    for (int i = top - 1; i >= 0; --i) {
        add_eval(c, t, t, px, py, line);
        fq12_sqr(f, facc, facc);
        fq12_mul(f, facc, line, facc);
        if ((ATE_LOOP >> i) & 1) {
            add_eval(c, t, qt, px, py, line);
            fq12_mul(f, facc, line, facc);
        }
    }
    // Frobenius corrections: Q1 = pi(Q), Q2 = -pi^2(Q)
    Pt12 q1, q2;
    fq12_frob(c, qt.x, 1, q1.x);
    fq12_frob(c, qt.y, 1, q1.y);
    q1.inf = false;
    fq12_frob(c, qt.x, 2, q2.x);
    u64 y2[48];
    fq12_frob(c, qt.y, 2, y2);
    fq6_neg(f, y2, q2.y);
    fq6_neg(f, y2 + 24, q2.y + 24);
    q2.inf = false;
    add_eval(c, t, q1, px, py, line);
    fq12_mul(f, facc, line, facc);
    add_eval(c, t, q2, px, py, line);
    fq12_mul(f, facc, line, facc);
    memcpy(out, facc, 384);
}

static void final_exp(const PairingCtx &c, const u64 *a, u64 *out) {
    const FieldCtx &f = c.fq;
    u64 f1[48], fi[48], f2[48], fr[48];
    fq12_conj(f, a, f1);
    fq12_inv(f, a, fi);
    fq12_mul(f, f1, fi, f1);
    fq12_frob(c, f1, 2, f2);
    fq12_mul(f, f2, f1, f2);
    fq12_pow(f, f2, c.hard_exp, fr);
    memcpy(out, fr, 384);
}

}  // namespace pairing

extern "C" {

// Initialize the pairing context. All inputs standard form little-endian:
// frob_c1_6: 6 Fq2 (6*8 u64), frob_c2_6: 6 Fq2, frob_c1_12: 12 Fq2,
// hard_exp: nlimbs u64 of (p^4 - p^2 + 1) / r.
int cn_pairing_init(const u64 *frob_c1_6, const u64 *frob_c2_6,
                    const u64 *frob_c1_12, const u64 *hard_exp, int hard_limbs) {
    using namespace pairing;
    field_init(g_ctx.fq, BN254_FQ);
    const FieldCtx &f = g_ctx.fq;
    for (int i = 0; i < 6; ++i) {
        to_mont(f, frob_c1_6 + i * 8, g_ctx.frob_c1_6[i]);
        to_mont(f, frob_c1_6 + i * 8 + 4, g_ctx.frob_c1_6[i] + 4);
        to_mont(f, frob_c2_6 + i * 8, g_ctx.frob_c2_6[i]);
        to_mont(f, frob_c2_6 + i * 8 + 4, g_ctx.frob_c2_6[i] + 4);
    }
    for (int i = 0; i < 12; ++i) {
        to_mont(f, frob_c1_12 + i * 8, g_ctx.frob_c1_12[i]);
        to_mont(f, frob_c1_12 + i * 8 + 4, g_ctx.frob_c1_12[i] + 4);
    }
    g_ctx.hard_exp.assign(hard_exp, hard_exp + hard_limbs);
    g_ctx.init = true;
    return 0;
}

// prod_i e(P_i, Q_i) with one shared final exponentiation.
// g1s: n * 8 u64 (x, y standard form; (0,0) = infinity)
// g2s: n * 16 u64 (x.c0, x.c1, y.c0, y.c1; all-zero = infinity)
// out: 48 u64, the Fq12 result in standard form (c0.c0.c0 ... c1.c2.c1)
int cn_multi_pairing(const u64 *g1s, const u64 *g2s, size_t n, u64 *out) {
    using namespace pairing;
    if (!g_ctx.init) return -1;
    const FieldCtx &f = g_ctx.fq;
    u64 acc[48], ml[48];
    fq12_one(f, acc);
    for (size_t i = 0; i < n; ++i) {
        const u64 *p = g1s + i * 8;
        const u64 *q = g2s + i * 16;
        bool p_inf = u256_is_zero(p) && u256_is_zero(p + 4);
        bool q_inf = u256_is_zero(q) && u256_is_zero(q + 4) &&
                     u256_is_zero(q + 8) && u256_is_zero(q + 12);
        if (p_inf || q_inf) continue;
        u64 pm[8], qm[16];
        to_mont(f, p, pm);
        to_mont(f, p + 4, pm + 4);
        for (int k = 0; k < 4; ++k) to_mont(f, q + 4 * k, qm + 4 * k);
        miller_loop(g_ctx, pm, qm, ml);
        fq12_mul(f, acc, ml, acc);
    }
    u64 fe[48];
    final_exp(g_ctx, acc, fe);
    for (int i = 0; i < 48; i += 4) from_mont(f, fe + i, out + i);
    return 0;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Witness-program executor (r1cs/witness_program.py).
//
// Replays a compiled witness program: the framework's native equivalent of
// the reference's compiled circom witness calculator
// (forks/circom-compat/src/witness/witness_calculator.rs).  The program is a
// flat u32 code stream + a deduplicated Montgomery coefficient table + a
// big-constant pool (RSA moduli and Barrett reciprocals for DIVMOD ops).
// Values are (nv, 4) u64 standard form — the exact layout groth16.prove
// consumes (zu), so a replayed witness feeds the prover with zero
// conversions.
// ---------------------------------------------------------------------------

namespace wp {

// variable-width big unsigned helpers (little-endian u64 words)
static void big_zero(u64 *a, int n) { memset(a, 0, 8 * (size_t)n); }

// a += b << (64*shift_words + shift_bits), a has na words capacity
static void big_add_shifted(u64 *a, int na, const u64 *b, int nb,
                            int shift_bits_total) {
    int sw = shift_bits_total / 64, sb = shift_bits_total % 64;
    u128 carry = 0;
    for (int i = 0; i <= nb && sw + i < na; ++i) {
        u64 w = 0;
        if (sb == 0) {
            w = (i < nb) ? b[i] : 0;
        } else {
            u64 lo = (i < nb) ? (b[i] << sb) : 0;
            u64 hi = (i > 0) ? (b[i - 1] >> (64 - sb)) : 0;
            w = lo | hi;
        }
        carry += (u128)a[sw + i] + w;
        a[sw + i] = (u64)carry;
        carry >>= 64;
    }
    for (int i = sw + nb + 1; carry && i < na; ++i) {
        carry += a[i];
        a[i] = (u64)carry;
        carry >>= 64;
    }
}

// out(no words) = x(nx) * y(ny); out capacity >= nx+ny
static void big_mul(u64 *out, const u64 *x, int nx, const u64 *y, int ny) {
    big_zero(out, nx + ny);
    for (int i = 0; i < nx; ++i) {
        if (!x[i]) continue;
        u128 carry = 0;
        for (int j = 0; j < ny; ++j) {
            carry += (u128)x[i] * y[j] + out[i + j];
            out[i + j] = (u64)carry;
            carry >>= 64;
        }
        int k = i + ny;
        while (carry) {
            carry += out[k];
            out[k++] = (u64)carry;
            carry >>= 64;
        }
    }
}

// out = a >> k (a has n words; out has n words)
static void big_shr(u64 *out, const u64 *a, int n, int k) {
    int sw = k / 64, sb = k % 64;
    for (int i = 0; i < n; ++i) {
        u64 lo = (sw + i < n) ? a[sw + i] : 0;
        u64 hi = (sw + i + 1 < n) ? a[sw + i + 1] : 0;
        out[i] = sb ? ((lo >> sb) | (hi << (64 - sb))) : lo;
    }
}

static int big_cmp(const u64 *a, int na, const u64 *b, int nb) {
    int n = na > nb ? na : nb;
    for (int i = n - 1; i >= 0; --i) {
        u64 x = i < na ? a[i] : 0, y = i < nb ? b[i] : 0;
        if (x < y) return -1;
        if (x > y) return 1;
    }
    return 0;
}

// a -= b (a >= b)
static void big_sub(u64 *a, int na, const u64 *b, int nb) {
    u128 borrow = 0;
    for (int i = 0; i < na; ++i) {
        u128 bi = (i < nb ? b[i] : 0) + borrow;
        if ((u128)a[i] >= bi) {
            a[i] = (u64)((u128)a[i] - bi);
            borrow = 0;
        } else {
            a[i] = (u64)(((u128)1 << 64) + a[i] - bi);
            borrow = 1;
        }
    }
}

// extract `width` bits at offset `shift` from a (n words)
static u64 big_bits(const u64 *a, int n, int shift, int width) {
    int sw = shift / 64, sb = shift % 64;
    u64 lo = sw < n ? a[sw] >> sb : 0;
    if (sb && sw + 1 < n) lo |= a[sw + 1] << (64 - sb);
    return width >= 64 ? lo : (lo & (((u64)1 << width) - 1));
}

struct Eval {
    const FieldCtx *f;
    const u64 *coeffs;  // (ncoeff, 4) Montgomery
    u64 *values;        // (nv, 4) standard

    // acc = sum coeff[id] * values[idx]  (standard form)
    void terms(const u32 *code, u32 nt, u64 *acc) const {
        big_zero(acc, 4);
        u64 t[4];
        for (u32 i = 0; i < nt; ++i) {
            u32 idx = code[2 * i], cid = code[2 * i + 1];
            fmul(*f, coeffs + (size_t)cid * 4, values + (size_t)idx * 4, t);
            fadd(*f, acc, t, acc);
        }
    }
};

}  // namespace wp


// signed big accumulator helpers for the NN (non-native limb) hint ops
static void big_divmod_barrett(u64 *q, int nq, u64 *r, int nr,
                               const u64 *x, int nx, const u64 *m, int nm,
                               const u64 *mu, int nmu, int S) {
    // q = floor(x/m) via q_hat = (x*mu) >> S with correction; r = x - q*m
    std::vector<u64> xmu((size_t)nx + nmu + 1, 0);
    wp::big_mul(xmu.data(), x, nx, mu, nmu);
    std::vector<u64> qq(nx + 2, 0);
    {
        int sw = S / 64, sb = S % 64;
        int tot = nx + nmu + 1;
        for (int i = 0; i < nx + 2; ++i) {
            u64 lo = (sw + i < tot) ? xmu[sw + i] : 0;
            u64 hi = (sw + i + 1 < tot) ? xmu[sw + i + 1] : 0;
            qq[i] = sb ? ((lo >> sb) | (hi << (64 - sb))) : lo;
        }
    }
    std::vector<u64> qn((size_t)nx + nm + 3, 0);
    wp::big_mul(qn.data(), qq.data(), nx + 2, m, nm);
    std::vector<u64> rr(x, x + nx);
    rr.resize(nx + 2, 0);
    if (wp::big_cmp(qn.data(), nx + nm + 3, rr.data(), (int)rr.size()) > 0) {
        // q_hat overshot (should not happen with floor mu) — rebuild by
        // decrementing until q*m <= x
        for (;;) {
            for (int i = 0; i < nx + 2; ++i) { if (qq[i]--) break; }
            std::fill(qn.begin(), qn.end(), 0);
            wp::big_mul(qn.data(), qq.data(), nx + 2, m, nm);
            if (wp::big_cmp(qn.data(), nx + nm + 3, rr.data(), (int)rr.size()) <= 0)
                break;
        }
    }
    wp::big_sub(rr.data(), (int)rr.size(), qn.data(), (int)rr.size());
    int guard = 0;
    while (wp::big_cmp(rr.data(), (int)rr.size(), m, nm) >= 0) {
        wp::big_sub(rr.data(), (int)rr.size(), m, nm);
        for (int i = 0; i < nx + 2; ++i) { if (++qq[i]) break; }
        if (++guard > 4) break;
    }
    for (int i = 0; i < nq; ++i) q[i] = (i < nx + 2) ? qq[i] : 0;
    for (int i = 0; i < nr; ++i) r[i] = (i < (int)rr.size()) ? rr[i] : 0;
}

// modular inverse via Fermat (m prime, nm <= 4 words): out = a^(m-2) mod m
static void big_modinv_prime(u64 *out, const u64 *a, const u64 *m, int nm,
                             const u64 *mu, int nmu, int S) {
    std::vector<u64> m2(m, m + nm);
    // m - 2
    u64 two[1] = {2};
    wp::big_sub(m2.data(), nm, two, 1);
    std::vector<u64> acc(nm, 0), base(a, a + nm), t(2 * nm + 2, 0),
        red(nm + 2, 0), qs(2 * nm + 4, 0);
    acc[0] = 1;
    int bits = nm * 64;
    for (int i = bits - 1; i >= 0; --i) {
        // acc = acc^2 mod m
        std::fill(t.begin(), t.end(), 0);
        wp::big_mul(t.data(), acc.data(), nm, acc.data(), nm);
        big_divmod_barrett(qs.data(), (int)qs.size(), red.data(), (int)red.size(),
                           t.data(), 2 * nm, m, nm, mu, nmu, S);
        std::copy(red.begin(), red.begin() + nm, acc.begin());
        if ((m2[i / 64] >> (i % 64)) & 1) {
            std::fill(t.begin(), t.end(), 0);
            wp::big_mul(t.data(), acc.data(), nm, base.data(), nm);
            big_divmod_barrett(qs.data(), (int)qs.size(), red.data(), (int)red.size(),
                               t.data(), 2 * nm, m, nm, mu, nmu, S);
            std::copy(red.begin(), red.begin() + nm, acc.begin());
        }
    }
    std::copy(acc.begin(), acc.begin() + nm, out);
}

extern "C" {

// Returns 0 on success; negative codes identify the failing check.
int cn_witness_run(const u64 *mod, const u32 *code, size_t code_len,
                   const u64 *coeffs_mont, const u64 *bigpool,
                   const u32 *in_idx, const u64 *in_val, size_t n_in,
                   u64 *values, size_t nv) {
    FieldCtx f;
    field_init(f, mod);
    u64 half[4];
    memcpy(half, f.mod, 32);
    // half = (mod-1)/2 -- mod is odd
    u64 one_[4] = {1, 0, 0, 0};
    u256_sub(half, half, one_);
    for (int i = 0; i < 4; ++i) {
        u64 hi = (i + 1 < 4) ? half[i + 1] : 0;
        half[i] = (half[i] >> 1) | (hi << 63);
    }
    memset(values, 0, 32 * nv);
    values[0] = 1;
    for (size_t i = 0; i < n_in; ++i)
        memcpy(values + (size_t)in_idx[i] * 4, in_val + i * 4, 32);

    wp::Eval ev{&f, coeffs_mont, values};
    size_t pc = 0;
    u64 A[4], B[4], C[4], T[4];
    while (pc < code_len) {
        u32 kind = code[pc++];
        switch (kind) {
            case 0: {  // SOLVE_C: out, invc_id, nA, nB, nC, terms...
                u32 out = code[pc], invc = code[pc + 1];
                u32 na = code[pc + 2], nb = code[pc + 3], nc = code[pc + 4];
                pc += 5;
                ev.terms(code + pc, na, A); pc += 2 * na;
                ev.terms(code + pc, nb, B); pc += 2 * nb;
                ev.terms(code + pc, nc, C); pc += 2 * nc;
                to_mont(f, A, T);
                fmul(f, T, B, T);          // A*B standard
                fsub(f, T, C, T);
                fmul(f, coeffs_mont + (size_t)invc * 4, T,
                     values + (size_t)out * 4);
                break;
            }
            case 1: {  // SOLVE_LIN: out, invc_id, nA, terms...
                u32 out = code[pc], invc = code[pc + 1], na = code[pc + 2];
                pc += 3;
                ev.terms(code + pc, na, A); pc += 2 * na;
                fmul(f, coeffs_mont + (size_t)invc * 4, A,
                     values + (size_t)out * 4);
                break;
            }
            case 2: {  // DECOMP: nouts, neg, nkn, (out,shift,width)*, kn...
                u32 nouts = code[pc], neg = code[pc + 1], nkn = code[pc + 2];
                pc += 3;
                const u32 *osw = code + pc; pc += 3 * nouts;
                ev.terms(code + pc, nkn, A); pc += 2 * nkn;
                if (!neg) {  // r = (-eval) mod F
                    wp::big_zero(C, 4);
                    fsub(f, C, A, T);
                    memcpy(A, T, 32);
                }
                u64 acc[5] = {0, 0, 0, 0, 0};
                for (u32 j = 0; j < nouts; ++j) {
                    u32 o = osw[3 * j], sh = osw[3 * j + 1], w = osw[3 * j + 2];
                    u64 v = wp::big_bits(A, 4, (int)sh, (int)(w > 64 ? 64 : w));
                    u64 *dst = values + (size_t)o * 4;
                    wp::big_zero(dst, 4);
                    dst[0] = v;
                    u64 vv[1] = {v};
                    wp::big_add_shifted(acc, 5, vv, 1, (int)sh);
                }
                if (acc[4] != 0 || u256_cmp(acc, A) != 0) return -2;
                break;
            }
            case 3: {  // HINT_DECOMP: base, nbits, nt, terms...
                u32 base = code[pc], nbits = code[pc + 1], nt = code[pc + 2];
                pc += 3;
                ev.terms(code + pc, nt, A); pc += 2 * nt;
                for (u32 i = 0; i < nbits; ++i) {
                    u64 *dst = values + (size_t)(base + i) * 4;
                    wp::big_zero(dst, 4);
                    dst[0] = (A[i / 64] >> (i % 64)) & 1;
                }
                break;
            }
            case 4: {  // INV01: inv, out, nt, terms...
                u32 invw = code[pc], outw = code[pc + 1], nt = code[pc + 2];
                pc += 3;
                ev.terms(code + pc, nt, A); pc += 2 * nt;
                u64 *di = values + (size_t)invw * 4;
                u64 *dout = values + (size_t)outw * 4;
                if (u256_is_zero(A)) {
                    wp::big_zero(di, 4);
                    wp::big_zero(dout, 4);
                    dout[0] = 1;
                } else {
                    to_mont(f, A, T);
                    finv(f, T, T);
                    from_mont(f, T, di);
                    wp::big_zero(dout, 4);
                }
                break;
            }
            case 5: {  // ONEHOT: base, n, nt, terms...
                u32 base = code[pc], n = code[pc + 1], nt = code[pc + 2];
                pc += 3;
                ev.terms(code + pc, nt, A); pc += 2 * nt;
                u64 x = (A[1] | A[2] | A[3]) ? ~(u64)0 : A[0];
                for (u32 j = 0; j < n; ++j) {
                    u64 *dst = values + (size_t)(base + j) * 4;
                    wp::big_zero(dst, 4);
                    dst[0] = (j == x) ? 1 : 0;
                }
                break;
            }
            case 6: {  // SHR: out, k, nt, terms...
                u32 out = code[pc], k = code[pc + 1], nt = code[pc + 2];
                pc += 3;
                ev.terms(code + pc, nt, A); pc += 2 * nt;
                wp::big_shr(values + (size_t)out * 4, A, 4, (int)k);
                break;
            }
            case 7: {  // NEGMOD: out, k, nt, terms...
                u32 out = code[pc], k = code[pc + 1], nt = code[pc + 2];
                pc += 3;
                ev.terms(code + pc, nt, A); pc += 2 * nt;
                u64 mask = (k >= 64) ? ~(u64)0 : (((u64)1 << k) - 1);
                u64 v = A[0] & mask;
                u64 *dst = values + (size_t)out * 4;
                wp::big_zero(dst, 4);
                dst[0] = (mask + 1 - v) & mask;  // (-v) mod 2^k, k < 64
                break;
            }
            case 8: {  // SSHR_BIAS: out, k, bias_off, nt, terms...
                u32 out = code[pc], k = code[pc + 1], boff = code[pc + 2];
                u32 nt = code[pc + 3];
                pc += 4;
                ev.terms(code + pc, nt, A); pc += 2 * nt;
                const u64 *bias = bigpool + boff;  // standard, 4 words
                u64 *dst = values + (size_t)out * 4;
                if (u256_cmp(A, half) > 0) {  // negative representative
                    u64 m[4];
                    u256_sub(m, f.mod, A);            // magnitude
                    // ceil(m / 2^k) = (m + 2^k - 1) >> k ; m < 2^254 so
                    // the add cannot overflow 4 words for k <= 127
                    u64 addend[4] = {0, 0, 0, 0};  // k < 128 expected
                    if (k < 64) addend[0] = ((u64)1 << k) - 1;
                    else { addend[0] = ~(u64)0; addend[1] = ((u64)1 << (k - 64)) - 1; }
                    u256_add(m, m, addend);
                    wp::big_shr(T, m, 4, (int)k);
                    fsub(f, bias, T, dst);
                } else {
                    wp::big_shr(T, A, 4, (int)k);
                    fadd(f, bias, T, dst);
                }
                break;
            }
            case 9: {  // DIVMOD
                u32 limb_bits = code[pc], ka = code[pc + 1], kb = code[pc + 2];
                u32 kq = code[pc + 3], kr = code[pc + 4];
                u32 noff = code[pc + 5], nw = code[pc + 6];
                u32 muoff = code[pc + 7], muw = code[pc + 8], S = code[pc + 9];
                pc += 10;
                const int WA = 72, WX = 144, WQ = 256;
                std::vector<u64> Abig(WA, 0), Bbig(WA, 0), X(WX, 0),
                    XMu(WQ, 0), Q(WX, 0), QN(WQ, 0);
                for (u32 li = 0; li < ka; ++li) {
                    u32 nt = code[pc++];
                    ev.terms(code + pc, nt, A); pc += 2 * nt;
                    wp::big_add_shifted(Abig.data(), WA, A, 4,
                                        (int)(limb_bits * li));
                }
                for (u32 li = 0; li < kb; ++li) {
                    u32 nt = code[pc++];
                    ev.terms(code + pc, nt, A); pc += 2 * nt;
                    wp::big_add_shifted(Bbig.data(), WA, A, 4,
                                        (int)(limb_bits * li));
                }
                const u32 *qidx = code + pc; pc += kq;
                const u32 *ridx = code + pc; pc += kr;
                wp::big_mul(X.data(), Abig.data(), WA / 2, Bbig.data(), WA / 2);
                // q_hat = (X * mu) >> S
                wp::big_mul(XMu.data(), X.data(), WX / 2 + 2,
                            bigpool + muoff, (int)muw);
                // q_hat = XMu >> S
                {
                    int sw = (int)S / 64, sb = (int)S % 64;
                    for (int i = 0; i < WX; ++i) {
                        u64 lo = (sw + i < WQ) ? XMu[sw + i] : 0;
                        u64 hi = (sw + i + 1 < WQ) ? XMu[sw + i + 1] : 0;
                        Q[i] = sb ? ((lo >> sb) | (hi << (64 - sb))) : lo;
                    }
                }
                // r = X - q*n ; correct while r >= n
                wp::big_mul(QN.data(), Q.data(), WX / 2 + 2, bigpool + noff,
                            (int)nw);
                if (wp::big_cmp(QN.data(), WX, X.data(), WX) > 0) return -3;
                wp::big_sub(X.data(), WX, QN.data(), WX);
                int guard = 0;
                while (wp::big_cmp(X.data(), WX, bigpool + noff, (int)nw) >= 0) {
                    wp::big_sub(X.data(), WX, bigpool + noff, (int)nw);
                    // Q += 1
                    for (int i = 0; i < WX; ++i) {
                        if (++Q[i]) break;
                    }
                    if (++guard > 8) return -4;
                }
                for (u32 li = 0; li < kq; ++li) {
                    u64 *dst = values + (size_t)qidx[li] * 4;
                    wp::big_zero(dst, 4);
                    for (int w = 0; w < 4; ++w)
                        dst[w] = wp::big_bits(Q.data(), WX,
                                              (int)(limb_bits * li) + 64 * w,
                                              64);
                    // mask to limb_bits
                    int top = (int)limb_bits;
                    for (int w = 0; w < 4; ++w) {
                        int lo = 64 * w;
                        if (lo >= top) dst[w] = 0;
                        else if (top - lo < 64)
                            dst[w] &= (((u64)1 << (top - lo)) - 1);
                    }
                }
                for (u32 li = 0; li < kr; ++li) {
                    u64 *dst = values + (size_t)ridx[li] * 4;
                    wp::big_zero(dst, 4);
                    for (int w = 0; w < 4; ++w)
                        dst[w] = wp::big_bits(X.data(), WX,
                                              (int)(limb_bits * li) + 64 * w,
                                              64);
                    int top = (int)limb_bits;
                    for (int w = 0; w < 4; ++w) {
                        int lo = 64 * w;
                        if (lo >= top) dst[w] = 0;
                        else if (top - lo < 64)
                            dst[w] &= (((u64)1 << (top - lo)) - 1);
                    }
                }
                break;
            }
            case 10: {  // SOLVE_AB: out, invc_id, nR, nOther, nC, terms...
                u32 out = code[pc], invc = code[pc + 1];
                u32 nr = code[pc + 2], no = code[pc + 3], nc = code[pc + 4];
                pc += 5;
                ev.terms(code + pc, nr, A); pc += 2 * nr;   // R_rest
                ev.terms(code + pc, no, B); pc += 2 * no;   // other row
                ev.terms(code + pc, nc, C); pc += 2 * nc;   // C row
                if (u256_is_zero(B)) return -5;
                to_mont(f, B, T);
                finv(f, T, T);               // (other)^-1 Montgomery
                fmul(f, T, C, T);            // C / other, standard
                fsub(f, T, A, T);
                fmul(f, coeffs_mont + (size_t)invc * 4, T,
                     values + (size_t)out * 4);
                break;
            }
            case 11:
            case 12: {  // NN_RED / NN_QUOT
                u32 limb_bits = code[pc], n_out = code[pc + 1];
                u32 moff = code[pc + 2], nmw = code[pc + 3];
                u32 muoff = code[pc + 4], muw = code[pc + 5], S = code[pc + 6];
                u32 boff = code[pc + 7], bw = code[pc + 8];
                u32 n_muls = code[pc + 9], n_lins = code[pc + 10];
                bool want_quot = (kind == 12);
                pc += 11;
                const u32 *oidx = code + pc; pc += n_out;
                const int WV = 12, WP = 26, WT = 32;
                std::vector<u64> TOT(WT, 0);
                bool tneg = false;
                std::vector<u64> Av(WV), Bv(WV), Pv(WP), Sc(WP + 2);
                auto eval_vec = [&](u32 kk, u64 *dst) {
                    wp::big_zero(dst, WV);
                    for (u32 li = 0; li < kk; ++li) {
                        u32 nt = code[pc++];
                        ev.terms(code + pc, nt, A); pc += 2 * nt;
                        wp::big_add_shifted(dst, WV, A, 4,
                                            (int)(limb_bits * li));
                    }
                };
                auto add_signed = [&](const u64 *mag, int nmag, bool neg) {
                    if (tneg == neg) {
                        u128 c = 0;
                        for (int i = 0; i < WT; ++i) {
                            c += (u128)TOT[i] + (i < nmag ? mag[i] : 0);
                            TOT[i] = (u64)c; c >>= 64;
                        }
                    } else if (wp::big_cmp(TOT.data(), WT, mag, nmag) >= 0) {
                        wp::big_sub(TOT.data(), WT, mag, nmag);
                    } else {
                        std::vector<u64> t2(mag, mag + nmag);
                        t2.resize(WT, 0);
                        wp::big_sub(t2.data(), WT, TOT.data(), WT);
                        TOT.assign(t2.begin(), t2.end());
                        tneg = neg;
                    }
                    bool zero = true;
                    for (int i = 0; i < WT; ++i) if (TOT[i]) { zero = false; break; }
                    if (zero) tneg = false;
                };
                for (u32 mi = 0; mi < n_muls; ++mi) {
                    u32 sgn = code[pc], smag = code[pc + 1];
                    u32 ka = code[pc + 2], kb = code[pc + 3];
                    pc += 4;
                    eval_vec(ka, Av.data());
                    eval_vec(kb, Bv.data());
                    wp::big_zero(Pv.data(), WP);
                    wp::big_mul(Pv.data(), Av.data(), WV, Bv.data(), WV);
                    wp::big_zero(Sc.data(), WP + 2);
                    { u128 c = 0;
                      for (int i = 0; i < WP; ++i) {
                          c += (u128)Pv[i] * smag;
                          Sc[i] = (u64)c; c >>= 64;
                      }
                      Sc[WP] = (u64)c; }
                    add_signed(Sc.data(), WP + 1, sgn == 0);
                }
                for (u32 li2 = 0; li2 < n_lins; ++li2) {
                    u32 sgn = code[pc], smag = code[pc + 1], kc = code[pc + 2];
                    pc += 3;
                    eval_vec(kc, Av.data());
                    wp::big_zero(Sc.data(), WP + 2);
                    { u128 c = 0;
                      for (int i = 0; i < WV; ++i) {
                          c += (u128)Av[i] * smag;
                          Sc[i] = (u64)c; c >>= 64;
                      }
                      Sc[WV] = (u64)c; }
                    add_signed(Sc.data(), WV + 1, sgn == 0);
                }
                std::vector<u64> Q(WT + 2, 0), Rr(nmw + 2, 0);
                big_divmod_barrett(Q.data(), (int)Q.size(), Rr.data(), (int)Rr.size(),
                                   TOT.data(), WT, bigpool + moff, (int)nmw,
                                   bigpool + muoff, (int)muw, (int)S);
                std::vector<u64> OUTV(WT + 4, 0);
                if (!want_quot) {
                    if (tneg) {
                        bool rz = true;
                        for (int i = 0; i < (int)Rr.size(); ++i) if (Rr[i]) { rz = false; break; }
                        if (!rz) {
                            std::vector<u64> t2(bigpool + moff, bigpool + moff + nmw);
                            t2.resize(Rr.size(), 0);
                            wp::big_sub(t2.data(), (int)t2.size(), Rr.data(), (int)Rr.size());
                            Rr = t2;
                        }
                    }
                    std::copy(Rr.begin(), Rr.end(), OUTV.begin());
                } else {
                    // floor quotient: neg -> -(Q+1) if R != 0 else -Q; then + bias
                    bool rz = true;
                    for (int i = 0; i < (int)Rr.size(); ++i) if (Rr[i]) { rz = false; break; }
                    std::vector<u64> B2(bigpool + boff, bigpool + boff + bw);
                    B2.resize(WT + 4, 0);
                    if (tneg) {
                        if (!rz) { for (int i = 0; i < (int)Q.size(); ++i) if (++Q[i]) break; }
                        wp::big_sub(B2.data(), (int)B2.size(), Q.data(), (int)Q.size());
                    } else {
                        u128 c = 0;
                        for (int i = 0; i < (int)B2.size(); ++i) {
                            c += (u128)B2[i] + (i < (int)Q.size() ? Q[i] : 0);
                            B2[i] = (u64)c; c >>= 64;
                        }
                    }
                    OUTV = B2;
                }
                for (u32 li3 = 0; li3 < n_out; ++li3) {
                    u64 *dst = values + (size_t)oidx[li3] * 4;
                    wp::big_zero(dst, 4);
                    int top = (int)limb_bits;
                    for (int w = 0; w < 4; ++w) {
                        int lo = 64 * w;
                        if (lo >= top) { dst[w] = 0; continue; }
                        u64 v = wp::big_bits(OUTV.data(), (int)OUTV.size(),
                                             (int)(limb_bits * li3) + lo, 64);
                        if (top - lo < 64) v &= (((u64)1 << (top - lo)) - 1);
                        dst[w] = v;
                    }
                }
                break;
            }
            case 13: {  // NN_INV_MUL
                u32 limb_bits = code[pc], n_out = code[pc + 1];
                u32 moff = code[pc + 2], nmw = code[pc + 3];
                u32 muoff = code[pc + 4], muw = code[pc + 5], S = code[pc + 6];
                u32 n_nt = code[pc + 7], n_dt = code[pc + 8];
                pc += 9;
                const u32 *oidx = code + pc; pc += n_out;
                const int WV = 12, WT = 16;
                std::vector<u64> Av(WV);
                auto eval_lin = [&](u32 nl, std::vector<u64> &MAG, bool &neg) {
                    MAG.assign(WT, 0);
                    neg = false;
                    for (u32 i = 0; i < nl; ++i) {
                        u32 sgn = code[pc], smag = code[pc + 1], kc = code[pc + 2];
                        pc += 3;
                        wp::big_zero(Av.data(), WV);
                        for (u32 li = 0; li < kc; ++li) {
                            u32 nt = code[pc++];
                            ev.terms(code + pc, nt, A); pc += 2 * nt;
                            wp::big_add_shifted(Av.data(), WV, A, 4,
                                                (int)(limb_bits * li));
                        }
                        std::vector<u64> Sc(WV + 2, 0);
                        { u128 c = 0;
                          for (int w = 0; w < WV; ++w) {
                              c += (u128)Av[w] * smag;
                              Sc[w] = (u64)c; c >>= 64;
                          }
                          Sc[WV] = (u64)c; }
                        bool sneg = (sgn == 0);
                        if (neg == sneg) {
                            u128 c = 0;
                            for (int w = 0; w < WT; ++w) {
                                c += (u128)MAG[w] + (w < WV + 1 ? Sc[w] : 0);
                                MAG[w] = (u64)c; c >>= 64;
                            }
                        } else if (wp::big_cmp(MAG.data(), WT, Sc.data(), WV + 1) >= 0) {
                            wp::big_sub(MAG.data(), WT, Sc.data(), WV + 1);
                        } else {
                            std::vector<u64> t2(Sc.begin(), Sc.begin() + WV + 1);
                            t2.resize(WT, 0);
                            wp::big_sub(t2.data(), WT, MAG.data(), WT);
                            MAG.assign(t2.begin(), t2.end());
                            neg = sneg;
                        }
                    }
                };
                std::vector<u64> NUM, DEN;
                bool nneg, dneg;
                eval_lin(n_nt, NUM, nneg);
                eval_lin(n_dt, DEN, dneg);
                auto reduce = [&](std::vector<u64> &MAG, bool neg,
                                  std::vector<u64> &out) {
                    std::vector<u64> Q(WT + 2, 0);
                    out.assign(nmw + 2, 0);
                    big_divmod_barrett(Q.data(), (int)Q.size(), out.data(),
                                       (int)out.size(), MAG.data(), WT,
                                       bigpool + moff, (int)nmw,
                                       bigpool + muoff, (int)muw, (int)S);
                    bool rz = true;
                    for (auto w : out) if (w) { rz = false; break; }
                    if (neg && !rz) {
                        std::vector<u64> t2(bigpool + moff, bigpool + moff + nmw);
                        t2.resize(out.size(), 0);
                        wp::big_sub(t2.data(), (int)t2.size(), out.data(), (int)out.size());
                        out = t2;
                    }
                };
                std::vector<u64> num_r, den_r;
                reduce(NUM, nneg, num_r);
                reduce(DEN, dneg, den_r);
                bool dz = true;
                for (auto w : den_r) if (w) { dz = false; break; }
                std::vector<u64> OUTV(nmw + 4, 0);
                if (!dz) {
                    std::vector<u64> invd(nmw, 0);
                    big_modinv_prime(invd.data(), den_r.data(),
                                     bigpool + moff, (int)nmw,
                                     bigpool + muoff, (int)muw, (int)S);
                    std::vector<u64> prod(2 * nmw + 4, 0), Q2(2 * nmw + 6, 0);
                    wp::big_mul(prod.data(), num_r.data(), nmw, invd.data(), nmw);
                    std::vector<u64> red(nmw + 2, 0);
                    big_divmod_barrett(Q2.data(), (int)Q2.size(), red.data(),
                                       (int)red.size(), prod.data(), 2 * nmw,
                                       bigpool + moff, (int)nmw,
                                       bigpool + muoff, (int)muw, (int)S);
                    std::copy(red.begin(), red.end(), OUTV.begin());
                }
                for (u32 li3 = 0; li3 < n_out; ++li3) {
                    u64 *dst = values + (size_t)oidx[li3] * 4;
                    wp::big_zero(dst, 4);
                    int top = (int)limb_bits;
                    for (int w = 0; w < 4; ++w) {
                        int lo = 64 * w;
                        if (lo >= top) { dst[w] = 0; continue; }
                        u64 v = wp::big_bits(OUTV.data(), (int)OUTV.size(),
                                             (int)(limb_bits * li3) + lo, 64);
                        if (top - lo < 64) v &= (((u64)1 << (top - lo)) - 1);
                        dst[w] = v;
                    }
                }
                break;
            }
            default:
                return -1;
        }
    }
    return 0;
}

}  // extern "C"
