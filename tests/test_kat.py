"""Coefficient-exact KATs: the device pipeline vs a pure python-int oracle.

The reference pins every op with deterministic-RNG KATs (ref: README.md:48,
tests/gpqhe.c:167-171) but checks only decoded distances; a silent
constant-factor or representative-convention drift would pass.  This oracle
replays the SAME surf stream through the SAME samplers and recomputes every
ciphertext with exact python integers following the engine's documented
representative conventions (nonnegative representatives mod 2^nbits(q_l);
relin divide-round u = floor(c/P) + [c mod P > P/2], matching mpi_rdiv's
ties-down semantics, ref: src/types.c:115-128) — then asserts EXACT limb
equality for keygen, enc (sk+pk), add, mul+relin, rescale, moddown, conj and
rot.  Models the reference pipeline he-mult.c:88-156 / he-rescale.c:33-54 /
he-automorphism.c:40-115 at exact-integer level.
"""

import numpy as np
import pytest

from gpqhe_jax import params
from gpqhe_jax.context import HeContext
from gpqhe_jax.ring import sample as smp
from gpqhe_jax.scheme.engine import CKKS
from gpqhe_jax.substrate import bigint
from gpqhe_jax.substrate.surf import Surf


# ---------------------------------------------------------------------------
# exact-integer oracle
# ---------------------------------------------------------------------------

class Oracle:
    """Python-int model of the CKKS engine with identical surf consumption."""

    def __init__(self, ctx: HeContext):
        self.ctx = ctx
        self.rng = Surf()
        self.n = ctx.poly.n

    # -- ring ----------------------------------------------------------------

    def negacyclic(self, a, b):
        n = self.n
        out = [0] * n
        for i in range(n):
            ai = a[i]
            if ai == 0:
                continue
            for j in range(n):
                k = i + j
                if k < n:
                    out[k] += ai * b[j]
                else:
                    out[k - n] -= ai * b[j]
        return out

    def galois(self, a, rot, qb):
        """rot=None -> conjugation (ref: src/poly.c:263-283)."""
        n, m = self.n, 2 * self.n
        mod = 1 << qb
        out = [0] * n
        if rot is None:
            out[0] = a[0] % mod
            for i in range(1, n):
                out[i] = (-a[n - i]) % mod
        else:
            power = pow(params.ROT, rot, m)
            for i in range(n):
                k = (i * power) % m
                if k < n:
                    out[k] = a[i] % mod
                else:
                    out[k - n] = (-a[i]) % mod
        return out

    # -- keygen (sampling order mirrors scheme/engine.py exactly) ------------

    def keypair(self):
        ctx = self.ctx
        qb = ctx.q[ctx.L].bit_length()
        self.s = [int(x) for x in smp.sample_sk(self.rng, self.n)]
        e = [int(x) for x in smp.sample_error(self.rng, self.n)]
        p1 = smp.sample_uniform_ints(self.rng, self.n, ctx.q[ctx.L])
        prod = self.negacyclic(self.s, p1)
        p0 = [(-c + ei) % (1 << qb) for c, ei in zip(prod, e)]
        self.pk = (p0, p1)

    def genswk(self, sp):
        ctx = self.ctx
        PqL = ctx.PqL
        e = [int(x) for x in smp.sample_error(self.rng, self.n)]
        swkp1 = smp.sample_uniform_ints(self.rng, self.n, PqL)
        prod = self.negacyclic(swkp1, self.s)
        swkp0 = [(-c + ei + ctx.P * spi) % PqL
                 for c, ei, spi in zip(prod, e, sp)]
        return (swkp0, swkp1)

    def genrlk(self):
        s2 = self.negacyclic(self.s, self.s)
        self.rlk = self.genswk(s2)

    def genck(self):
        n = self.n
        conj = [self.s[0]] + [-self.s[n - i] for i in range(1, n)]
        self.ck = self.genswk(conj)

    def genrk(self, rotations):
        n, m = self.n, 2 * self.n
        self.rk = {}
        for rot in rotations:
            power = pow(params.ROT, rot, m)
            rk = [0] * n
            for i in range(n):
                k = (i * power) % m
                if k < n:
                    rk[k] = self.s[i]
                else:
                    rk[k - n] = -self.s[i]
            self.rk[rot] = self.genswk(rk)

    # -- encrypt --------------------------------------------------------------

    def enc_pk(self, m):
        ctx = self.ctx
        qb = ctx.q[ctx.L].bit_length()
        mod = 1 << qb
        v = [int(x) for x in smp.sample_zo(self.rng, self.n)]
        e0 = [int(x) for x in smp.sample_error(self.rng, self.n)]
        e1 = [int(x) for x in smp.sample_error(self.rng, self.n)]
        c0 = self.negacyclic(self.pk[0], v)
        c1 = self.negacyclic(self.pk[1], v)
        c0 = [(c + mi + ei) % mod for c, mi, ei in zip(c0, m, e0)]
        c1 = [(c + ei) % mod for c, ei in zip(c1, e1)]
        return (ctx.L, c0, c1)

    def enc_sk(self, m):
        ctx = self.ctx
        qb = ctx.q[ctx.L].bit_length()
        mod = 1 << qb
        e = [int(x) for x in smp.sample_error(self.rng, self.n)]
        c1 = smp.sample_uniform_ints(self.rng, self.n, ctx.q[ctx.L])
        prod = self.negacyclic(c1, self.s)
        c0 = [(-c + mi + ei) % mod for c, mi, ei in zip(prod, m, e)]
        return (ctx.L, c0, c1)

    def dec(self, ct):
        l, c0, c1 = ct
        qb = self.ctx.q[l].bit_length()
        prod = self.negacyclic(c1, self.s)
        return [(p + c) % (1 << qb) for p, c in zip(prod, c0)]

    # -- scheme ops -----------------------------------------------------------

    def add(self, ct1, ct2):
        l = ct1[0]
        mod = 1 << self.ctx.q[l].bit_length()
        return (l, [(a + b) % mod for a, b in zip(ct1[1], ct2[1])],
                [(a + b) % mod for a, b in zip(ct1[2], ct2[2])])

    def keyswitch(self, d, swk, l):
        """u_h = rdiv(d (*) swk_h, P) mod 2^qb (engine _keyswitch_core)."""
        ctx = self.ctx
        mod = 1 << ctx.q[l].bit_length()
        P = ctx.P
        out = []
        for h in range(2):
            c = self.negacyclic(d, swk[h])
            u = [(ci // P) + (1 if (ci % P) > P // 2 else 0) for ci in c]
            out.append([ui % mod for ui in u])
        return out

    def mul(self, ct1, ct2):
        """he_mul + he_relin (ref: src/he-mult.c:88-156)."""
        assert ct1[0] == ct2[0]
        l = ct1[0]
        mod = 1 << self.ctx.q[l].bit_length()
        d0 = [x % mod for x in self.negacyclic(ct1[1], ct2[1])]
        d2 = [x % mod for x in self.negacyclic(ct1[2], ct2[2])]
        d1a = self.negacyclic(ct1[1], ct2[2])
        d1b = self.negacyclic(ct1[2], ct2[1])
        d1 = [(a + b) % mod for a, b in zip(d1a, d1b)]
        u0, u1 = self.keyswitch(d2, self.rlk, l)
        c0 = [(u + d) % mod for u, d in zip(u0, d0)]
        c1 = [(u + d) % mod for u, d in zip(u1, d1)]
        return (l, c0, c1)

    def rs(self, ct):
        """Shift+round by Delta=2^logD on the nonneg representative, ties
        down, then mask to q_{l-1} width (engine rs / lb.rshift_round)."""
        l, c0, c1 = ct
        logD = self.ctx.p.bit_length() - 1
        mod = 1 << self.ctx.q[l - 1].bit_length()
        half = 1 << (logD - 1)

        def one(c):
            return [((x >> logD) + (1 if (x & ((1 << logD) - 1)) > half else 0))
                    % mod for x in c]
        return (l - 1, one(c0), one(c1))

    def moddown(self, ct):
        l, c0, c1 = ct
        mod = 1 << self.ctx.q[l - 1].bit_length()
        return (l - 1, [x % mod for x in c0], [x % mod for x in c1])

    def conj(self, ct):
        l, c0, c1 = ct
        qb = self.ctx.q[l].bit_length()
        d0 = self.galois(c0, None, qb)
        d1 = self.galois(c1, None, qb)
        u0, u1 = self.keyswitch(d1, self.ck, l)
        mod = 1 << qb
        return (l, [(u + d) % mod for u, d in zip(u0, d0)], u1)

    def rot(self, ct, r):
        l, c0, c1 = ct
        qb = self.ctx.q[l].bit_length()
        d0 = self.galois(c0, r, qb)
        d1 = self.galois(c1, r, qb)
        u0, u1 = self.keyswitch(d1, self.rk[r], l)
        mod = 1 << qb
        return (l, [(u + d) % mod for u, d in zip(u0, d0)], u1)


# ---------------------------------------------------------------------------
# the test
# ---------------------------------------------------------------------------

def _ct_ints(eng, ct):
    """Engine ciphertext -> (l, c0 ints, c1 ints) reduced mod 2^qbits."""
    mod = 1 << eng.qbits(ct.l)
    c0 = [v % mod for v in bigint.limbs_to_ints(np.asarray(ct.c0))]
    c1 = [v % mod for v in bigint.limbs_to_ints(np.asarray(ct.c1))]
    return ct.l, c0, c1


def _assert_ct_equal(name, eng, ct, oct_):
    l, c0, c1 = _ct_ints(eng, ct)
    assert l == oct_[0], f"{name}: level {l} != {oct_[0]}"
    assert c0 == oct_[1], f"{name}: c0 mismatch"
    assert c1 == oct_[2], f"{name}: c1 mismatch"


def test_exact_oracle_kat():
    ctx = HeContext(logn=4, q=1 << 610, slots=2, Delta=1 << 30)
    eng = CKKS(ctx, rng=Surf())
    orc = Oracle(ctx)

    # keygen (same stream order: keypair, rlk, ck, rk)
    pk, sk = eng.keypair()
    orc.keypair()
    s_ints = [int(v) - (1 << 32) if int(v) >= (1 << 31) else int(v)
              for v in bigint.limbs_to_ints(np.asarray(sk.s))]
    assert s_ints == orc.s, "secret key stream mismatch"
    qbL = eng.qbits(ctx.L)
    pk_c0 = [v % (1 << qbL) for v in bigint.limbs_to_ints(np.asarray(pk.p0))]
    assert pk_c0 == [v % (1 << qbL) for v in orc.pk[0]], "pk.p0 mismatch"

    rlk = eng.genrlk(sk)
    orc.genrlk()
    ck = eng.genck(sk)
    orc.genck()
    rk = eng.genrk(sk, rotations=[0, 1])
    orc.genrk([0, 1])

    # encode (host-side, shared): message from the same stream
    m0 = smp.sample_z01vec(eng.rng, ctx.slots)
    m0_o = smp.sample_z01vec(orc.rng, ctx.slots)
    assert np.array_equal(m0, m0_o)
    pt = eng.ecd(m0)
    m_ints = bigint.limbs_to_ints(np.asarray(pt.m))
    mod_pt = 1 << pt.mod_bits
    m_signed = [(v % mod_pt) - mod_pt if (v % mod_pt) >= mod_pt // 2
                else v % mod_pt for v in m_ints]

    # enc_pk / enc_sk
    ct = eng.enc_pk(pt, pk)
    oct_ = orc.enc_pk(m_signed)
    _assert_ct_equal("enc_pk", eng, ct, oct_)

    ct_sk = eng.enc_sk(pt, sk)
    oct_sk = orc.enc_sk(m_signed)
    _assert_ct_equal("enc_sk", eng, ct_sk, oct_sk)

    # dec round-trip at exact level
    ptd = eng.dec(ct, sk)
    dec_ints = bigint.limbs_to_ints(np.asarray(ptd.m))
    modq = 1 << (eng.qbits(ct.l) - 1)
    odec = orc.dec(oct_)
    assert [v % modq for v in dec_ints] == [v % modq for v in odec], "dec"

    # add
    _assert_ct_equal("add", eng, eng.add(ct, ct_sk), orc.add(oct_, oct_sk))

    # mul + relin, then rescale, then moddown
    ct_mul = eng.mul(ct, ct_sk, rlk)
    oct_mul = orc.mul(oct_, oct_sk)
    _assert_ct_equal("mul+relin", eng, ct_mul, oct_mul)

    ct_rs = eng.rs(ct_mul)
    oct_rs = orc.rs(oct_mul)
    _assert_ct_equal("rescale", eng, ct_rs, oct_rs)

    ct_md = eng.moddown(ct_rs)
    oct_md = orc.moddown(oct_rs)
    _assert_ct_equal("moddown", eng, ct_md, oct_md)

    # automorphisms
    _assert_ct_equal("conj", eng, eng.conj(ct.copy(), ck), orc.conj(oct_))
    _assert_ct_equal("rot1", eng, eng.rot(ct.copy(), 1, rk), orc.rot(oct_, 1))

    # fused mul_rs must equal mul-then-rs exactly
    ct_f = eng.mul_rs(ct, ct_sk, rlk)
    _assert_ct_equal("mul_rs", eng, ct_f, oct_rs)


def test_exact_oracle_ladder_sweep():
    """Per-level exact sweep (VERDICT r2 #6): walk a deep ladder (logn=5,
    L=20) doing fused mul+relin+rescale AND conj at EVERY level, asserting
    limb equality against the python-int oracle.  This pins the truncated
    reconstruct margins (bound_bits), the log-depth carries and the
    divide-round at every (dim_mul, dim_swk, k) combination in live use —
    an off-by-one in any margin formula fails here at the level where the
    basis shrinks past it."""
    ctx = HeContext(logn=5, q=1 << 610, slots=2, Delta=1 << 30)
    eng = CKKS(ctx, rng=Surf())
    orc = Oracle(ctx)

    pk, sk = eng.keypair()
    orc.keypair()
    rlk = eng.genrlk(sk)
    orc.genrlk()
    ck = eng.genck(sk)
    orc.genck()

    m0 = smp.sample_z01vec(eng.rng, ctx.slots)
    smp.sample_z01vec(orc.rng, ctx.slots)
    pt = eng.ecd(m0)
    m_ints = bigint.limbs_to_ints(np.asarray(pt.m))
    mod_pt = 1 << pt.mod_bits
    m_signed = [(v % mod_pt) - mod_pt if (v % mod_pt) >= mod_pt // 2
                else v % mod_pt for v in m_ints]
    ct = eng.enc_pk(pt, pk)
    oct_ = orc.enc_pk(m_signed)
    _assert_ct_equal("enc_pk", eng, ct, oct_)

    assert ctx.L >= 15, ctx.L
    while ct.l >= 1:
        l = ct.l
        oct_c = orc.conj(oct_)
        ct_c = eng.conj(ct.copy(), ck)
        _assert_ct_equal(f"conj@l={l}", eng, ct_c, oct_c)
        ct = eng.mul_rs(ct, ct_c, rlk)
        oct_ = orc.rs(orc.mul(oct_, oct_c))
        _assert_ct_equal(f"mul_rs@l={l}", eng, ct, oct_)
