"""Integration tests at the reference's EXACT default parameters
(ref: tests/gpqhe.c:1296-1299: linear ops at logn=14, logq=438, slots=16,
Delta=2^50).  Run with:  pytest -m slow tests/test_full_params.py

Excluded from the default suite (pyproject addopts) because keygen alone
generates 18 switching keys at n=16384."""

import numpy as np
import pytest

from gpqhe_jax.context import HeContext
from gpqhe_jax.ring import sample as smp
from gpqhe_jax.scheme.engine import CKKS
from gpqhe_jax.substrate.surf import Surf

pytestmark = pytest.mark.slow

TOL = 1e-5


@pytest.fixture(scope="module")
def eng():
    ctx = HeContext(logn=14, q=1 << 438, slots=16, Delta=1 << 50)
    return CKKS(ctx, rng=Surf())


@pytest.fixture(scope="module")
def keys(eng):
    pk, sk = eng.keypair()
    rlk = eng.genrlk(sk)
    ck = eng.genck(sk)
    rk = eng.genrk(sk, rotations=[0, 1, 4])
    return pk, sk, rlk, ck, rk


def dist(a, b):
    return float(np.max(np.abs(a - b)))


def test_full_enc_dec(eng, keys):
    pk, sk, *_ = keys
    m0 = smp.sample_z01vec(eng.rng, eng.ctx.slots)
    pt = eng.ecd(m0)
    for ct in (eng.enc_sk(pt, sk), eng.enc_pk(pt, pk)):
        assert dist(eng.dcd(eng.dec(ct, sk)), m0) < TOL


def test_full_add_mul(eng, keys):
    pk, sk, rlk, *_ = keys
    m1 = smp.sample_z01vec(eng.rng, eng.ctx.slots)
    m2 = smp.sample_z01vec(eng.rng, eng.ctx.slots)
    ct1 = eng.enc_pk(eng.ecd(m1), pk)
    ct2 = eng.enc_pk(eng.ecd(m2), pk)
    assert dist(eng.dcd(eng.dec(eng.add(ct1, ct2), sk)), m1 + m2) < TOL
    ctm = eng.rs(eng.mul(ct1, ct2, rlk))
    assert ctm.l == eng.ctx.L - 1
    assert dist(eng.dcd(eng.dec(ctm, sk)), m1 * m2) < TOL


def test_full_conj_rot(eng, keys):
    pk, sk, _, ck, rk = keys
    m0 = smp.sample_z01vec(eng.rng, eng.ctx.slots)
    ct = eng.enc_pk(eng.ecd(m0), pk)
    assert dist(eng.dcd(eng.dec(eng.conj(ct.copy(), ck), sk)), np.conj(m0)) < TOL
    for r in (1, 4):
        got = eng.dcd(eng.dec(eng.rot(ct.copy(), r, rk), sk))
        assert dist(got, np.concatenate([m0[r:], m0[:r]])) < TOL
