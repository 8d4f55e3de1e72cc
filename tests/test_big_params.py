"""The reference's largest test configuration: comparison at logn=15.

Mirrors the reference's cmp defaults exactly — logn=15, logq=881, slots=4,
Delta=2^30, iter=5, alpha=2 (ref: tests/gpqhe.c:1317-1322) — the only config
that exercises the logn=15 row of the security table (logq <= 881,
ref: src/precomp.c:57-64).  Heavy: ~25 ciphertext multiplies at n=2^15 with
30+ RNS primes each; run with `-m slow`.
"""

import numpy as np
import pytest

pytestmark = pytest.mark.slow

from gpqhe_jax.algo import nonlinear
from gpqhe_jax.context import HeContext
from gpqhe_jax.scheme.engine import CKKS
from gpqhe_jax.substrate.surf import Surf


def test_cmp_logn15_reference_config():
    ctx = HeContext(logn=15, q=1 << 881, slots=4, Delta=1 << 30)
    eng = CKKS(ctx, rng=Surf())
    pk, sk = eng.keypair()
    rlk = eng.genrlk(sk)
    # the reference's message shape (ref: tests/gpqhe.c:1040-1043)
    from gpqhe_jax.ring import sample as smp
    m0 = smp.sample_z01vec(eng.rng, ctx.slots)
    m0 = smp.sample_z01vec(eng.rng, ctx.slots)  # reference samples twice
    a = m0.real + 0.5
    b = m0.imag + 0.5
    ct1 = eng.enc_pk(eng.ecd(a.astype(np.complex128)), pk)
    ct2 = eng.enc_pk(eng.ecd(b.astype(np.complex128)), pk)
    out = nonlinear.he_cmp(eng, ct1, ct2, rlk, iter=5, alpha=2)
    got = np.round(eng.dcd(eng.dec(out, sk)).real)
    expect = (a > b).astype(float)
    assert np.array_equal(got, expect), (got, expect, a, b)
