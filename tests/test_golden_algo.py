"""Algorithm-layer golden KATs against the compiled reference binary at the
reference DEFAULT parameters (VERDICT r3 #3).

tests/golden/golden_algo_{linear,nonlinear,cmp}.json hold decoded outputs
produced by the UNMODIFIED reference sources (he-algo.c compositions,
-DSUPERCOP surf stream) — see tests/golden/gen_golden_algo.c.  Each test
replays the IDENTICAL surf-consumption order (keys, messages, encryptions)
so both sides compute on bit-identical ciphertexts, then diffs the decoded
results.

Tolerances (same framework as test_golden.py): ops routed through key
switches carry the documented nonnegative-vs-centered representative
divergence, whose decoded magnitude is ~(h+2)/Delta per switch (h=64).
  linear    Delta=2^50: per-switch ~6e-14; gemv accumulates ~n1+n2 switches
            plus f64 decode rounding -> gate 1e-9 (measured ~1e-11).
  nonlinear Delta=2^30: per-switch ~6e-8, amplified through the iteration
            depth (inv: iter+1 muls; exp: Taylor + iter squarings)
            -> gate 1e-4 (the ops themselves only approximate the true
            function to ~1e-6, and both sides share that error).
  cmp       depth (3+iter)(1+t): the iteration is CONTRACTIVE toward
            {0, 1/2, 1} (a^n/(a^n+b^n)), so divergences shrink rather than
            amplify -> gate 1e-4.

The raw sampled messages must match BIT-exactly (stream parity).

Reference op sequences: tests/gpqhe.c test_gemv:641, test_sum:686,
test_idx:734, test_nrm2:779, test_inv:840, test_exp:888, test_sigmoid:931,
test_log:973, test_sqrt:1202, test_cmp:1021; defaults tests/gpqhe.c:1296-1322.
"""

import json
import os

import numpy as np
import pytest

from gpqhe_jax.context import HeContext
from gpqhe_jax.ring import sample as smp
from gpqhe_jax.scheme.engine import CKKS
from gpqhe_jax.substrate.surf import Surf

pytestmark = pytest.mark.slow   # reference-default rings (logn=14/15)

GDIR = os.path.join(os.path.dirname(__file__), "golden")


def _load(name):
    with open(os.path.join(GDIR, name)) as f:
        return {k: np.array([complex(a, b) for a, b in v])
                for k, v in json.load(f).items()}


def test_golden_algo_linear():
    """gemv/sum/idx/nrm2 at logn=14, logq=438, slots=16, Delta=2^50."""
    from gpqhe_jax.algo.linalg import HoistedGemvPlan, gemv, he_idx, he_nrm2, he_sum

    g = _load("golden_algo_linear.json")
    ctx = HeContext(logn=14, q=1 << 438, slots=16, Delta=1 << 50)
    eng = CKKS(ctx, rng=Surf())
    pk, sk = eng.keypair()
    rlk = eng.genrlk(sk)
    ck = eng.genck(sk)
    rk = eng.genrk(sk)

    v = smp.sample_z01vec(eng.rng, ctx.slots)
    A = smp.sample_z01vec(eng.rng, ctx.slots * ctx.slots)
    assert np.array_equal(v, g["v"]), "surf stream divergence (v)"
    assert np.array_equal(A, g["A"]), "surf stream divergence (A)"
    ct = eng.enc_pk(eng.ecd(v), pk)

    def dec(out):
        return eng.dcd(eng.dec(out, sk))

    # classic path mirrors the reference composition op for op
    got = dec(gemv(eng, A, ct.copy(), rk))
    assert np.max(np.abs(got - g["gemv"])) < 1e-9
    # the hoisted production path computes the same sums with ONE
    # divide-round per giant step — must agree within the same gate
    got_h = dec(gemv(eng, None, ct.copy(), rk,
                     plan=HoistedGemvPlan(eng, A), hoisted=True))
    assert np.max(np.abs(got_h - g["gemv"])) < 1e-9

    assert np.max(np.abs(dec(he_sum(eng, ct.copy(), rk)) - g["sum"])) < 1e-9
    assert np.max(np.abs(dec(he_idx(eng, ct.copy(), 1, rk)) - g["idx1"])) < 1e-9
    assert np.max(np.abs(dec(he_nrm2(eng, ct.copy(), rlk, ck, rk))
                         - g["nrm2"])) < 1e-9


def test_golden_algo_nonlinear():
    """inv/exp/sigmoid/log/sqrt at logn=14, logq=438, slots=4, Delta=2^30,
    iter=5 (sqrt 6)."""
    from gpqhe_jax.algo.nonlinear import he_exp, he_inv, he_log, he_sigmoid, he_sqrt

    g = _load("golden_algo_nonlinear.json")
    ctx = HeContext(logn=14, q=1 << 438, slots=4, Delta=1 << 30)
    eng = CKKS(ctx, rng=Surf())
    pk, sk = eng.keypair()
    rlk = eng.genrlk(sk)

    m0 = smp.sample_z01vec(eng.rng, ctx.slots)
    assert np.array_equal(m0, g["m0"]), "surf stream divergence (m0)"

    a = 2j * np.pi / float(1 << 30)
    mi = m0.real + 0.5
    me = m0 * a
    ms = m0 / 10
    ml = m0.real / 100000
    mq = m0.real + 0j
    cts = {}
    for name, msg in [("inv", mi), ("exp", me), ("sigmoid", ms),
                      ("log", ml), ("sqrt", mq)]:
        cts[name] = eng.enc_pk(eng.ecd(np.asarray(msg, dtype=np.complex128)),
                               pk)

    def dec(out):
        return eng.dcd(eng.dec(out, sk))

    assert np.max(np.abs(dec(he_inv(eng, cts["inv"], rlk, 5)) - g["inv"])) < 1e-4
    assert np.max(np.abs(dec(he_exp(eng, a, cts["exp"], rlk, 5)) - g["exp"])) < 1e-4
    assert np.max(np.abs(dec(he_sigmoid(eng, cts["sigmoid"], rlk))
                         - g["sigmoid"])) < 1e-4
    assert np.max(np.abs(dec(he_log(eng, cts["log"], rlk)) - g["log"])) < 1e-4
    assert np.max(np.abs(dec(he_sqrt(eng, cts["sqrt"], rlk, 6)) - g["sqrt"])) < 1e-4


def test_golden_algo_cmp():
    """cmp at logn=15, logq=881, slots=4, Delta=2^30, iter=5, alpha=2."""
    from gpqhe_jax.algo.nonlinear import he_cmp

    g = _load("golden_algo_cmp.json")
    ctx = HeContext(logn=15, q=1 << 881, slots=4, Delta=1 << 30)
    eng = CKKS(ctx, rng=Surf())
    pk, sk = eng.keypair()
    rlk = eng.genrlk(sk)

    m0 = smp.sample_z01vec(eng.rng, ctx.slots)
    m0 = smp.sample_z01vec(eng.rng, ctx.slots)   # sampled twice (ref :1041)
    assert np.array_equal(m0, g["m0"]), "surf stream divergence (m0)"
    ma = m0.real + 0.5
    mb = m0.imag + 0.5
    ct1 = eng.enc_pk(eng.ecd(np.asarray(ma, dtype=np.complex128)), pk)
    ct2 = eng.enc_pk(eng.ecd(np.asarray(mb, dtype=np.complex128)), pk)

    out = he_cmp(eng, ct1, ct2, rlk, iter=5, alpha=2)
    got = eng.dcd(eng.dec(out, sk))
    assert np.max(np.abs(got - g["cmp"])) < 1e-4
    # and the decision bits agree with the plaintext comparison
    assert np.array_equal(np.round(got.real), (ma > mb).astype(float))
