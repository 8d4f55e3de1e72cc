"""Bootstrap tests.

test_coeff2slot mirrors the reference's test exactly (ref:
tests/gpqhe.c:1096-1154): message m0/Delta, NO modulus raise, c2s output
slots must equal the encode coefficients Re/Im(invcanemb(m))*Delta.

test_full_bootstrap exercises the corrected full pipeline (the reference's
raise-Delta-to-qL flow is untested there and overflows the modulus — see
bootstrap/__init__.py): a ciphertext at a low level comes back to a high
level with its message intact.

Tiny ring (logn=5) with the security-table bypass keeps every compile small;
the ladder depth comes from logq.
"""

import numpy as np
import pytest

pytestmark = pytest.mark.slow  # many per-level compiles

from gpqhe_jax import bootstrap as bs
from gpqhe_jax.context import HeContext
from gpqhe_jax.ring import sample as smp
from gpqhe_jax.ring.canemb import invcanemb
from gpqhe_jax.scheme.engine import CKKS
from gpqhe_jax.substrate.surf import Surf


def test_coeff2slot():
    """c2s slots == encode coefficients (the reference's test shape,
    ref: tests/gpqhe.c:1110-1144; that test divides the message by Delta,
    which makes every encode coefficient round to 0 and the comparison
    unsatisfiable as written — here the message stays O(1) and the expected
    slots are the exactly-rounded coefficients, with a Delta-relative
    tolerance)."""
    ctx = HeContext(logn=5, q=1 << 400, slots=4, Delta=1 << 30)
    eng = CKKS(ctx, rng=Surf())
    pk, sk = eng.keypair()
    ck = eng.genck(sk)
    rk = eng.genrk(sk, bs.bootstrap_rotations(ctx))
    Delta = ctx.Delta
    m0 = smp.sample_z01vec(eng.rng, ctx.slots)
    pt = eng.ecd(m0)
    u = invcanemb(m0, ctx.slots, ctx.poly.cyc_group, ctx.poly.ring_zetas,
                  ctx.poly.m)
    mr0 = np.round(u.real * Delta) / Delta   # exact encode coeffs / Delta
    mi0 = np.round(u.imag * Delta) / Delta   # (c2s ledger decodes to t/Delta)
    ct = eng.enc_pk(pt, pk)
    bctx = bs.BootstrapContext(eng)
    ct0, ct1 = bs.coeff2slot(eng, bctx, ct, ck, rk)
    mr = eng.dcd(eng.dec(ct0, sk))
    mi = eng.dcd(eng.dec(ct1, sk))
    assert np.max(np.abs(mr - mr0)) < 1e-5
    assert np.max(np.abs(mi - mi0)) < 1e-5


def test_full_packing_c2s():
    """Full packing (slots = n/2, gap = 1) — the one regime where the
    reference's U construction (ref: src/he-bootstrap.c:299-342) is a valid
    DFT: our generalized U must equal it entry for entry, and the HE
    coeff2slot must recover the encode coefficients (SubSum is empty here)."""
    slots = 16  # n/2 at logn=5
    ctx = HeContext(logn=5, q=1 << 400, slots=slots, Delta=1 << 30)
    eng = CKKS(ctx, rng=Surf())
    bctx = bs.BootstrapContext(eng)

    # reference construction: zeta_i = e^(2 pi i cyc[i*gap]/m), U0[i,j] =
    # zeta_i^(j*gap), U1[i,j] = zeta_i^(j*gap + n/2)
    m = ctx.poly.m
    nh = ctx.poly.n // 2
    gap = nh // slots
    cyc = ctx.poly.cyc_group
    U0_ref = np.empty((slots, slots), dtype=np.complex128)
    U1_ref = np.empty((slots, slots), dtype=np.complex128)
    for i in range(slots):
        zeta = np.exp(2j * np.pi * int(cyc[i * gap]) / m)
        for j in range(slots):
            U0_ref[i, j] = zeta ** (j * gap)
            U1_ref[i, j] = zeta ** (j * gap + nh)
    assert np.allclose(bctx.U0.reshape(slots, slots), U0_ref, atol=1e-9)
    assert np.allclose(bctx.U1.reshape(slots, slots), U1_ref, atol=1e-9)

    # HE c2s at full packing (the test_coeff2slot shape)
    pk, sk = eng.keypair()
    ck = eng.genck(sk)
    rk = eng.genrk(sk, bs.bootstrap_rotations(ctx))
    m0 = smp.sample_z01vec(eng.rng, slots)
    pt = eng.ecd(m0)
    u = invcanemb(m0, slots, ctx.poly.cyc_group, ctx.poly.ring_zetas,
                  ctx.poly.m)
    mr0 = np.round(u.real * ctx.Delta) / ctx.Delta
    mi0 = np.round(u.imag * ctx.Delta) / ctx.Delta
    ct = eng.enc_pk(pt, pk)
    ct0, ct1 = bs.coeff2slot(eng, bctx, ct, ck, rk)
    assert np.max(np.abs(eng.dcd(eng.dec(ct0, sk)) - mr0)) < 1e-5
    assert np.max(np.abs(eng.dcd(eng.dec(ct1, sk)) - mi0)) < 1e-5


def _run_full_bootstrap(logn: int, logq: int, slots: int, iter: int,
                        tol: float = 1e-2) -> None:
    ctx = HeContext(logn=logn, q=1 << logq, slots=slots, Delta=1 << 30)
    eng = CKKS(ctx, rng=Surf())
    pk, sk = eng.keypair()
    rlk = eng.genrlk(sk)
    ck = eng.genck(sk)
    rk = eng.genrk(sk, bs.bootstrap_rotations(ctx))
    m0 = smp.sample_z01vec(eng.rng, ctx.slots) * 0.1
    ct = eng.enc_pk(eng.ecd(m0), pk)
    # burn down to a low level, as after a deep computation
    while ct.l > 1:
        ct = eng.moddown(ct)
    assert ct.l == 1
    bctx = bs.BootstrapContext(eng)
    ct_boot = bs.bootstrap(eng, bctx, ct, rlk, ck, rk, iter=iter)
    assert ct_boot.l > ct.l + 3, "bootstrap must regain levels"
    got = eng.dcd(eng.dec(ct_boot, sk))
    assert np.max(np.abs(got - m0)) < tol, np.max(np.abs(got - m0))


def test_full_bootstrap():
    # 2^iter >~ 4*pi*(h/2+1) = ~113 for the tiny ring's h=16 -> iter=7.
    # logq mod 30 = 10 keeps q_0 = 2^10 so EvalSin's q_0/(4 pi) noise
    # amplification stays small (see tests/test_bootstrap_smoke.py).
    _run_full_bootstrap(logn=5, logq=790, slots=4, iter=7)


def test_full_bootstrap_second_config():
    """Different ring, packing density and ladder depth so one lucky
    parameter set cannot mask a composition regression (h=32 -> iter=8)."""
    _run_full_bootstrap(logn=6, logq=700, slots=8, iter=8)
