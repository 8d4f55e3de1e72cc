"""Bootstrap at the reference's own default scale (VERDICT r2 #2).

The CLI bootstrap defaults — logn=15, logq=881 — are the only
security-table-legal bootstrap regime (every smaller logn row caps logq
far below the ~600 bits the pipeline consumes; ref: src/precomp.c:57-64,
tests/gpqhe.c:1317-1322).  Until this config runs green, "bootstrap works"
holds only on rings 512x smaller than the target.

Ladder: L = 881//30 = 29 levels, q0 = 2^(881 - 870) = 2^11 (small q0 keeps
EvalSin's q0/(4 pi) noise amplification below the message scale).  h = 64
(the reference hardcode, n >= 128 so no cap), so the EvalSin range
condition 2^iter >= 4*pi*(h/2+1) ~ 415 derives iter = 9; bootstrap()
validates this (iter=None).

Runtime note (for the suite budget): first cold run compiles ~60 programs
at n = 2^15; the persistent .jax_cache makes warm reruns cheap.
"""

import numpy as np
import pytest

pytestmark = pytest.mark.slow

from gpqhe_jax import bootstrap as bs
from gpqhe_jax.context import HeContext
from gpqhe_jax.ring import sample as smp
from gpqhe_jax.scheme.engine import CKKS
from gpqhe_jax.substrate.surf import Surf


def test_bootstrap_reference_scale():
    ctx = HeContext(logn=15, q=1 << 881, slots=4, Delta=1 << 30)
    eng = CKKS(ctx, rng=Surf(), ntt_impl="butterfly")
    pk, sk = eng.keypair()
    rlk = eng.genrlk(sk)
    ck = eng.genck(sk)
    rk = eng.genrk(sk, bs.bootstrap_rotations(ctx))
    m0 = smp.sample_z01vec(eng.rng, ctx.slots) * 0.1
    ct = eng.enc_pk(eng.ecd(m0), pk)
    while ct.l > 1:
        ct = eng.moddown(ct)
    assert ct.l == 1
    bctx = bs.BootstrapContext(eng)
    ct_boot = bs.bootstrap(eng, bctx, ct, rlk, ck, rk)  # iter derived from h
    assert ct_boot.l >= 10, ct_boot.l
    got = eng.dcd(eng.dec(ct_boot, sk))
    assert np.max(np.abs(got - m0)) < 1e-2, np.max(np.abs(got - m0))
