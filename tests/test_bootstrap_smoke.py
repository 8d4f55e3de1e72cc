"""Default-suite bootstrap smoke test.

The full-parameter bootstrap tests live behind `-m slow`; round 1 proved a
slow-only deep pipeline can silently break while the default suite stays
green.  This is the cheapest end-to-end composition that exercises every
bootstrap stage (raise -> SubSum -> c2s -> EvalSin -> s2c): logn=4, 2 slots,
iter=6 (h=8 -> 2^iter >~ 4*pi*(h/2+1) ~ 63).

logq is chosen so q_0 = 2^10 (logq mod logDelta = 10): EvalSin's output
constant q_src/(4*pi*Delta) = q_0/(4*pi) amplifies every bit of exp noise,
so a small base modulus keeps the amplification ~2^6 instead of ~2^17.
"""

import numpy as np

from gpqhe_jax import bootstrap as bs
from gpqhe_jax.context import HeContext
from gpqhe_jax.ring import sample as smp
from gpqhe_jax.scheme.engine import CKKS
from gpqhe_jax.substrate.surf import Surf


def test_bootstrap_smoke():
    ctx = HeContext(logn=4, q=1 << 610, slots=2, Delta=1 << 30)
    eng = CKKS(ctx, rng=Surf())
    pk, sk = eng.keypair()
    rlk = eng.genrlk(sk)
    ck = eng.genck(sk)
    rk = eng.genrk(sk, bs.bootstrap_rotations(ctx))
    m0 = smp.sample_z01vec(eng.rng, ctx.slots) * 0.1
    ct = eng.enc_pk(eng.ecd(m0), pk)
    while ct.l > 1:
        ct = eng.moddown(ct)
    bctx = bs.BootstrapContext(eng)
    ct_boot = bs.bootstrap(eng, bctx, ct, rlk, ck, rk, iter=6)
    assert ct_boot.l > ct.l + 3, "bootstrap must regain levels"
    got = eng.dcd(eng.dec(ct_boot, sk))
    assert np.max(np.abs(got - m0)) < 1e-2, np.max(np.abs(got - m0))
