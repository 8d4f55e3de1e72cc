"""Golden KATs against the ACTUAL compiled reference (VERDICT r2 #4).

tests/golden/golden_logn11.json holds decoded outputs produced by the
UNMODIFIED reference sources compiled with -DSUPERCOP (deterministic surf,
ref: src/rng.c:36-77) against the system libgcrypt — see
tests/golden/gen_golden.c + generate.sh.  This test replays the IDENTICAL
surf-consumption sequence on the JAX engine and diffs the decoded values.

Unlike tests/test_kat.py (whose python-int oracle replays the engine's own
conventions), this pins the engine against an independent implementation:
a systematic drift shared by engine and oracle fails HERE.  Both sides see
bit-identical keys/errors/messages (same stream, same sampler byte order).

Tolerances: enc/add/moddown agree to canonical-embedding f64 rounding
(gate 1e-9).  Every op routed through a key switch (mul's relin, conj,
rot) carries one DOCUMENTED representative divergence: the engine feeds
the key switch the nonnegative representative mod 2^nbits(q_l) while the
reference smods it centered mod q_l (ref: src/poly.c:109-120); the
difference delta (multiples of q_l, |delta| <= 2 q_l) cancels exactly in
decryption through the swk identity swk0 + swk1*s = P*s^2 + e (mod PqL) —
up to each half's independent +-1 divide-round choice, which decryption
amplifies by at most the secret's Hamming weight via c1*s.  Decoded bound:
(h+2)/Delta = 6.3e-5 here (measured: mulrs 6.3e-6, conj 1.9e-5; both
impls sit 4.03e-4 from the true product — identical noise floor).
"""

import json
import os

import numpy as np

from gpqhe_jax.context import HeContext
from gpqhe_jax.ring import sample as smp
from gpqhe_jax.scheme.engine import CKKS
from gpqhe_jax.substrate.surf import Surf

GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "golden_logn11.json")


def _arr(v):
    return np.array([complex(a, b) for a, b in v])


def test_golden_vs_reference_binary():
    with open(GOLDEN) as f:
        g = {k: _arr(v) for k, v in json.load(f).items()}

    ctx = HeContext(logn=11, q=1 << 48, slots=4, Delta=1 << 20)
    eng = CKKS(ctx, rng=Surf())
    pk, sk = eng.keypair()
    rlk = eng.genrlk(sk)
    ck = eng.genck(sk)
    rk = eng.genrk(sk)                 # all slots rotations, order 0..3

    m0 = smp.sample_z01vec(eng.rng, ctx.slots)
    ct1 = eng.enc_pk(eng.ecd(m0), pk)
    m1 = smp.sample_z01vec(eng.rng, ctx.slots)
    ct2 = eng.enc_pk(eng.ecd(m1), pk)

    # stream parity: the raw messages must match the reference's bit for bit
    assert np.array_equal(m0, g["m0"]), "surf stream diverged before m0"
    assert np.array_equal(m1, g["m1"]), "surf stream diverged before m1"

    def dcd(ct):
        return eng.dcd(eng.dec(ct, sk))

    from gpqhe_jax import params
    # every op routed through a key switch (mul's relin, conj, rot) carries
    # the representative-freedom divide-round divergence — see docstring
    tol_ks = (params.BLKSIZ + 2) / ctx.Delta    # 6.3e-5 here
    checks = {
        "enc": (dcd(ct1), 1e-9),
        "add": (dcd(eng.add(ct1, ct2)), 1e-9),
        "mulrs": (dcd(eng.rs(eng.mul(ct1, ct2, rlk))), tol_ks),
        "conj": (dcd(eng.conj(ct1.copy(), ck)), tol_ks),
        "rot1": (dcd(eng.rot(ct1.copy(), 1, rk)), tol_ks),
        "moddown": (dcd(eng.moddown(ct1)), 1e-9),
    }
    for name, (got, tol) in checks.items():
        diff = float(np.max(np.abs(got - g[name])))
        assert diff < tol, f"{name}: diff {diff} vs reference binary (tol {tol})"
