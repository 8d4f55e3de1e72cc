"""Algorithm-layer KATs: gemv/sum/idx/nrm2 and nonlinear evaluators.

Mirrors the reference tests (ref: tests/gpqhe.c test_gemv:641, test_sum:686,
test_idx:734, test_nrm2:779, test_inv:840, test_exp:888, test_sigmoid:931,
test_log:973, test_cmp:1021, test_sqrt:1202) at reduced depth
(logn=13, logq=218 — one row down the security table, ref: src/precomp.c:57-64)
with smaller iteration counts so CI depth fits L=7.
"""

import math

import numpy as np
import pytest

from gpqhe_jax.algo import linalg, nonlinear
from gpqhe_jax.context import HeContext
from gpqhe_jax.ring import sample as smp
from gpqhe_jax.scheme.engine import CKKS
from gpqhe_jax.substrate.surf import Surf

TOL = 1e-5


@pytest.fixture(scope="module")
def eng():
    ctx = HeContext(logn=13, q=1 << 218, slots=4, Delta=1 << 30)
    return CKKS(ctx, rng=Surf())


@pytest.fixture(scope="module")
def keys(eng):
    pk, sk = eng.keypair()
    rlk = eng.genrlk(sk)
    ck = eng.genck(sk)
    rk = eng.genrk(sk)
    return pk, sk, rlk, ck, rk


def dist(a, b):
    return float(np.max(np.abs(np.asarray(a) - np.asarray(b))))


def plain_gemv(A, v, slots):
    A = np.asarray(A).reshape(slots, slots)
    return A @ v


def test_gemv(eng, keys):
    pk, sk, _, _, rk = keys
    s = eng.ctx.slots
    m0 = smp.sample_z01vec(eng.rng, s)
    A = smp.sample_z01vec(eng.rng, s * s)
    ct = eng.enc_pk(eng.ecd(m0), pk)
    out = linalg.gemv(eng, A, ct, rk)
    assert dist(eng.dcd(eng.dec(out, sk)), plain_gemv(A, m0, s)) < TOL


def test_sum_idx_nrm2(eng, keys):
    pk, sk, rlk, ck, rk = keys
    s = eng.ctx.slots
    m0 = smp.sample_z01vec(eng.rng, s)
    ct = eng.enc_pk(eng.ecd(m0), pk)
    # sum lands the total in the row-0 slot (ref: src/he-algo.c:95-103)
    out = linalg.he_sum(eng, ct, rk)
    got = eng.dcd(eng.dec(out, sk))
    assert abs(got[0] - np.sum(m0)) < TOL
    # idx extracts one slot
    out = linalg.he_idx(eng, ct, 2, rk)
    got = eng.dcd(eng.dec(out, sk))
    assert abs(got[2] - m0[2]) < TOL
    # nrm2 = sum |m|^2
    out = linalg.he_nrm2(eng, ct, rlk, ck, rk)
    got = eng.dcd(eng.dec(out, sk))
    assert abs(got[0] - np.sum(np.abs(m0) ** 2)) < TOL


def plain_inv(x, iter):
    an = 2 - x
    bn = 1 - x
    for _ in range(iter):
        bn = bn * bn
        an = an * (bn + 1)
    return an


def test_inv(eng, keys):
    """Goldschmidt inverse vs the same plaintext iteration
    (ref: tests/gpqhe.c:840-886 checks HE against the iteration, not 1/x)."""
    pk, sk, rlk, _, _ = keys
    s = eng.ctx.slots
    iter = 3
    m0 = smp.sample_z01vec(eng.rng, s).real + 0.2  # keep away from 0
    m0 = np.minimum(m0, 0.95).astype(np.complex128)
    ct = eng.enc_pk(eng.ecd(m0), pk)
    out = nonlinear.he_inv(eng, ct, rlk, iter)
    got = eng.dcd(eng.dec(out, sk))
    # Delta=2^30 noise floor after a depth-7 chain sits right at 1e-5
    # (the reference's nonlinear configs carry the same floor); allow 5e-5.
    assert dist(got, plain_inv(m0, iter)) < 5e-5


def test_sqrt(eng, keys):
    pk, sk, rlk, _, _ = keys
    s = eng.ctx.slots
    m0 = (smp.sample_z01vec(eng.rng, s).real * 0.5 + 0.3).astype(np.complex128)
    ct = eng.enc_pk(eng.ecd(m0), pk)
    out = nonlinear.he_sqrt(eng, ct, rlk, iter=2)
    got = eng.dcd(eng.dec(out, sk))
    # 2 Wilkes iterations: compare against the same plaintext iteration
    an, bn = m0.copy(), m0 - 1
    for _ in range(2):
        an = an * (1 - bn / 2)
        bn = bn * bn * (bn - 3) / 4
    assert dist(got, an) < TOL


def plain_exp_series(x, iter):
    """The exact plaintext model of he_exp: Taylor to x^7 on x/2^iter, then
    iter squarings (ref: src/he-algo.c:364-458)."""
    z = x / (1 << iter)
    t = sum(z ** k / math.factorial(k) for k in range(8))
    for _ in range(iter):
        t = t * t
    return t


def test_exp(eng, keys):
    """HE exp vs the SAME truncated-series plaintext model at the reference's
    1e-5 CHECK_DIFF bound (ref: tests/gpqhe.c:167-171, 888-928); the looser
    libm comparison only bounds the series truncation."""
    pk, sk, rlk, _, _ = keys
    s = eng.ctx.slots
    m0 = (smp.sample_z01vec(eng.rng, s).real * 0.5).astype(np.complex128)
    ct = eng.enc_pk(eng.ecd(m0), pk)
    out = nonlinear.he_exp(eng, 1.0, ct, rlk, iter=2)
    got = eng.dcd(eng.dec(out, sk))
    assert dist(got, plain_exp_series(m0, 2)) < 1e-5
    assert dist(got, np.exp(m0)) < 1e-3  # series truncation at iter=2


def test_exp_reference_shape(eng, keys):
    """The reference's own exp regime: a = 2*pi*i/Delta, |a*m| tiny, checked
    against cexp at 1e-5 (ref: tests/gpqhe.c:888-928)."""
    pk, sk, rlk, _, _ = keys
    s = eng.ctx.slots
    a = 2j * np.pi / eng.ctx.Delta
    m0 = smp.sample_z01vec(eng.rng, s)
    ct = eng.enc_pk(eng.ecd(m0), pk)
    out = nonlinear.he_exp(eng, a, ct, rlk, iter=2)
    got = eng.dcd(eng.dec(out, sk))
    assert dist(got, np.exp(a * m0)) < 1e-5


def plain_sigmoid_poly(x):
    """he_sigmoid's exact degree-9 polynomial (ref: src/he-algo.c:208-277)."""
    return (0.5
            + (-1.0 / 48) * x * (x * x + (1.0 / 4) / (-1.0 / 48))
            + (-17.0 / 80640) * x * (x * x + (1.0 / 480) / (-17.0 / 80640)) * x ** 4
            + (31.0 / 1451520) * x * x ** 8)


def test_sigmoid(eng, keys):
    """HE sigmoid vs its exact polynomial at 1e-5, and vs libm in the
    reference's m/10 regime where the poly is 1e-5-accurate
    (ref: tests/gpqhe.c:931-971)."""
    pk, sk, rlk, _, _ = keys
    s = eng.ctx.slots
    m0 = (smp.sample_z01vec(eng.rng, s).real * 2 - 1).astype(np.complex128)
    ct = eng.enc_pk(eng.ecd(m0), pk)
    out = nonlinear.he_sigmoid(eng, ct, rlk)
    got = eng.dcd(eng.dec(out, sk))
    assert dist(got, plain_sigmoid_poly(m0)) < 1e-5
    # the reference regime: m/10, exact sigmoid at CHECK_DIFF 1e-5
    m1 = smp.sample_z01vec(eng.rng, s) / 10
    ct1 = eng.enc_pk(eng.ecd(m1), pk)
    got1 = eng.dcd(eng.dec(nonlinear.he_sigmoid(eng, ct1, rlk), sk))
    assert dist(got1, 1 / (1 + np.exp(-m1))) < 1e-5


def plain_log_series(x):
    """he_log's exact odd/even degree-10 series (ref: src/he-algo.c:279-361,
    mirrored at tests/gpqhe.c:986-989)."""
    odd = (x / 9) * (9 + (9.0 / 3) * x ** 2 + (9.0 / 5) * x ** 4
                     + (9.0 / 7) * x ** 6 + x ** 8)
    even = (-x * x / 10) * ((10.0 / 2) + (10.0 / 4) * x ** 2
                            + (10.0 / 6) * x ** 4 + (10.0 / 8) * x ** 6 + x ** 8)
    return odd + even


def test_log(eng, keys):
    pk, sk, rlk, _, _ = keys
    s = eng.ctx.slots
    m0 = (smp.sample_z01vec(eng.rng, s).real * 0.2 + 0.9).astype(np.complex128)
    x = m0 - 1
    ct = eng.enc_pk(eng.ecd(x), pk)  # evaluator computes log(1+x)
    out = nonlinear.he_log(eng, ct, rlk)
    got = eng.dcd(eng.dec(out, sk))
    assert dist(got, plain_log_series(x)) < 1e-5   # exact series model
    assert dist(got, np.log(m0)) < 1e-3            # series approximation
    # the reference regime: x ~ 1e-5, both checks at 1e-5
    x1 = (smp.sample_z01vec(eng.rng, s).real / 100000).astype(np.complex128)
    got1 = eng.dcd(eng.dec(nonlinear.he_log(eng, eng.enc_pk(eng.ecd(x1), pk),
                                            rlk), sk))
    assert dist(got1, np.log(1 + x1)) < 1e-5
    assert dist(got1, plain_log_series(x1)) < 1e-5


def test_rlsin(eng, keys):
    """sin(a*ct)/a via exp/conj (ref: tests/gpqhe.c test_rlsin:1156), against
    the exact exp-series model at 1e-5 and libm at the truncation level."""
    from gpqhe_jax.bootstrap import rlsin

    pk, sk, rlk, ck, _ = keys
    s = eng.ctx.slots
    a = 2 * np.pi
    m0 = (smp.sample_z01vec(eng.rng, s).real * 0.2).astype(np.complex128)
    ct = eng.enc_pk(eng.ecd(m0), pk)
    out = rlsin(eng, a, ct, rlk, ck, iter=1)
    got = eng.dcd(eng.dec(out, sk))
    e = plain_exp_series(1j * a * m0, 1)
    assert dist(got, (e - np.conj(e)) / (2j * a)) < 1e-5
    assert dist(got, np.sin(a * m0) / a) < 1e-3


def test_rlsin_reference_shape(eng, keys):
    """The reference's rlsin regime: message m/Delta, output == message at
    CHECK_DIFF 1e-5 (sin(x) ~ x; ref: tests/gpqhe.c:1156-1200)."""
    from gpqhe_jax.bootstrap import rlsin

    pk, sk, rlk, ck, _ = keys
    s = eng.ctx.slots
    m0 = smp.sample_z01vec(eng.rng, s) / eng.ctx.Delta
    ct = eng.enc_pk(eng.ecd(m0), pk)
    out = rlsin(eng, 2 * np.pi, ct, rlk, ck, iter=2)
    got = eng.dcd(eng.dec(out, sk))
    assert dist(got, m0) < 1e-5


def test_cmp(eng, keys):
    """Comparison at reduced iterations (ref: tests/gpqhe.c test_cmp:1021)."""
    pk, sk, rlk, _, _ = keys
    s = eng.ctx.slots
    a = np.array([0.55, 0.40, 0.52, 0.47], dtype=np.complex128)
    b = np.array([0.45, 0.60, 0.48, 0.53], dtype=np.complex128)
    ct1 = eng.enc_pk(eng.ecd(a), pk)
    ct2 = eng.enc_pk(eng.ecd(b), pk)
    out = nonlinear.he_cmp(eng, ct1, ct2, rlk, iter=2, alpha=1)
    got = eng.dcd(eng.dec(out, sk)).real
    expect = np.array([1.0, 0.0, 1.0, 0.0])
    assert np.all(np.abs(np.round(got) - expect) == 0)


def test_cmppt(eng, keys):
    """Ciphertext-vs-plaintext comparison (ref: src/he-algo.c:532-548 —
    the only public algo-layer op the reference leaves untested)."""
    pk, sk, rlk, _, _ = keys
    a = np.array([0.55, 0.40, 0.52, 0.47], dtype=np.complex128)
    b = np.array([0.45, 0.60, 0.48, 0.53], dtype=np.complex128)
    ct = eng.enc_pk(eng.ecd(a), pk)
    pt = eng.ecd(b)
    out = nonlinear.he_cmppt(eng, ct, pt, rlk, iter=2, alpha=1)
    got = eng.dcd(eng.dec(out, sk)).real
    expect = (a.real > b.real).astype(float)
    assert np.all(np.abs(np.round(got) - expect) == 0)


def test_gemv_hoisted(eng, keys):
    """Double-hoisted gemv agrees with the classic path and the plaintext
    oracle (one key switch per giant step; CKKS.hoisted_gemv_fn)."""
    from gpqhe_jax.algo.linalg import HoistedGemvPlan

    e, pk, sk, rlk, ck, rk = eng, *keys
    slots = e.ctx.slots
    rng = np.random.default_rng(17)
    A = (rng.standard_normal(slots * slots)
         + 1j * rng.standard_normal(slots * slots)) * 0.3
    m = smp.sample_z01vec(e.rng, slots)
    ct = e.enc_pk(e.ecd(m), pk)
    ref = A.reshape(slots, slots) @ m
    plan = HoistedGemvPlan(e, A)
    got = e.dcd(e.dec(linalg.gemv(e, A, ct, rk, plan=plan, hoisted=True), sk))
    assert np.max(np.abs(got - ref)) < 1e-5
    classic = e.dcd(e.dec(linalg.gemv(e, A, ct, rk), sk))
    assert np.max(np.abs(got - classic)) < 1e-5
    # plan reuse: second call hits the cached per-level pack
    got2 = e.dcd(e.dec(linalg.gemv(e, A, ct, rk, plan=plan, hoisted=True), sk))
    assert np.max(np.abs(got2 - ref)) < 1e-5


def test_gemv_hoisted_slots256():
    """Hoisted gemv at slots=256 (full packing, logn=9): the streamed
    slab-per-giant-step design keeps compile time and memory flat in slots
    (one prep + one step program; 16 slab uploads of n1=16 diagonals)."""
    from gpqhe_jax.algo.linalg import HoistedGemvPlan

    slots = 256
    ctx = HeContext(logn=9, q=1 << 120, slots=slots, Delta=1 << 30)
    e = CKKS(ctx, rng=Surf())
    pk, sk = e.keypair()
    n1 = 16
    rots = sorted(set(range(n1)) | {i * n1 for i in range(slots // n1)})
    rk = e.genrk(sk, rotations=rots)
    rng = np.random.default_rng(5)
    A = (rng.standard_normal(slots * slots)
         + 1j * rng.standard_normal(slots * slots)) * 0.1
    m = smp.sample_z01vec(e.rng, slots)
    ct = e.enc_pk(e.ecd(m), pk)
    plan = HoistedGemvPlan(e, A)
    out = linalg.gemv(e, None, ct, rk, plan=plan, hoisted=True)
    got = e.dcd(e.dec(out, sk))
    assert np.max(np.abs(got - A.reshape(slots, slots) @ m)) < 1e-5


def test_sum_hoisted(eng, keys):
    e, pk, sk, rlk, ck, rk = eng, *keys
    slots = e.ctx.slots
    m = smp.sample_z01vec(e.rng, slots)
    ct = e.enc_pk(e.ecd(m), pk)
    got = e.dcd(e.dec(linalg.he_sum(e, ct, rk, hoisted=True), sk))
    assert abs(got[0] - m.sum()) < 1e-5
