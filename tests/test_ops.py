"""Kernel-layer KATs: modmath, NTT (vs schoolbook negacyclic product),
limb arithmetic, RNS decompose/reconstruct (vs python-int oracle).

Device analogue of the reference's tests/polymul.c (PARI/GP oracle,
ref: tests/polymul.c:84-124) and tests/crt.c (shrunken-param CRT roundtrips,
ref: tests/crt.c:94-214).
"""

import random

import jax.numpy as jnp
import numpy as np
import pytest

from gpqhe_jax.context import PolyContext
from gpqhe_jax.ops import limbs as lb
from gpqhe_jax.ops import rns as rns_ops
from gpqhe_jax.ops.modmath import mont_mul, mulmod, to_mont
from gpqhe_jax.ops.ntt import intt, ntt
from gpqhe_jax.substrate import bigint


@pytest.fixture(scope="module")
def pctx():
    return PolyContext(6, q=1 << 20, dim_cap=24)


def test_mulmod_exact(pctx):
    random.seed(2)
    dim = 4
    b = pctx.basis(dim)
    a = np.array([[random.randrange(p) for _ in range(64)] for p in b.primes], dtype=np.uint64)
    c = np.array([[random.randrange(p) for _ in range(64)] for p in b.primes], dtype=np.uint64)
    got = np.asarray(mulmod(jnp.array(a), jnp.array(c),
                            jnp.array(b.ps)[:, None], jnp.array(b.pinv_mont)[:, None],
                            jnp.array(b.r2)[:, None]))
    for d, p in enumerate(b.primes):
        exp = [(int(a[d, i]) * int(c[d, i])) % p for i in range(64)]
        assert [int(x) for x in got[d]] == exp


def test_ntt_roundtrip_and_product(pctx):
    random.seed(3)
    dim = 3
    n = pctx.n
    b = pctx.basis(dim)
    ba = rns_ops.make_basis_arrays(pctx, dim)
    a = np.array([[random.randrange(p) for _ in range(n)] for p in b.primes], dtype=np.uint64)
    c = np.array([[random.randrange(p) for _ in range(n)] for p in b.primes], dtype=np.uint64)
    ah = ntt(jnp.array(a), ba.zetas, ba.ps, ba.pinv)
    back = np.asarray(intt(ah, ba.zetas_inv, ba.ps, ba.pinv, ba.ninv_mont))
    assert np.array_equal(back, a)
    ch = mulmod(ah, ntt(jnp.array(c), ba.zetas, ba.ps, ba.pinv),
                ba.ps[:, None], ba.pinv[:, None], jnp.array(b.r2)[:, None])
    prod = np.asarray(intt(ch, ba.zetas_inv, ba.ps, ba.pinv, ba.ninv_mont))
    for d, p in enumerate(b.primes):
        ref = [0] * n
        for i in range(n):
            ai = int(a[d, i])
            for j in range(n):
                k = i + j
                if k >= n:
                    ref[k - n] = (ref[k - n] - ai * int(c[d, j])) % p
                else:
                    ref[k] = (ref[k] + ai * int(c[d, j])) % p
        assert [int(x) for x in prod[d]] == ref


def test_limb_arith():
    random.seed(4)
    K = 9
    mod = 1 << (32 * K)
    xs = [random.getrandbits(32 * K - random.randrange(200)) for _ in range(40)]
    ys = [random.getrandbits(32 * K - random.randrange(200)) for _ in range(40)]
    ax = jnp.array(bigint.ints_to_limbs(xs, K))
    ay = jnp.array(bigint.ints_to_limbs(ys, K))
    assert bigint.limbs_to_ints(np.asarray(lb.add(ax, ay))) == [(x + y) % mod for x, y in zip(xs, ys)]
    assert bigint.limbs_to_ints(np.asarray(lb.sub(ax, ay))) == [(x - y) % mod for x, y in zip(xs, ys)]
    assert bigint.limbs_to_ints(np.asarray(lb.neg(ax))) == [(-x) % mod for x in xs]
    got_ge = np.asarray(lb.geq_const(ax, jnp.array(bigint.int_to_limbs(ys[0], K))))
    assert list(got_ge) == [x >= ys[0] for x in xs]
    assert bigint.limbs_to_ints(np.asarray(lb.mask_bits(ax, 100))) == [x % (1 << 100) for x in xs]
    for t in (1, 31, 32, 50, 64, 97):
        assert bigint.limbs_to_ints(np.asarray(lb.rshift(ax, t))) == [x >> t for x in xs]
        exp = [(x >> t) + (1 if (x & ((1 << t) - 1)) > (1 << (t - 1)) else 0) for x in xs]
        assert bigint.limbs_to_ints(np.asarray(lb.rshift_round(ax, t))) == exp
    c = random.getrandbits(300)
    c16 = bigint.digits16(c, 2 * K)
    got = bigint.limbs_to_ints(np.asarray(lb.mul_const_mod2k(ax, c16, K)))
    assert got == [(x * c) % mod for x in xs]


def test_fit_signed():
    """Widening a signed value must sign-extend (regression: genswk corrupted
    negative products when k_out exceeded the reconstruction width)."""
    K = 4
    vals = [-5, 7, -(1 << 100), (1 << 100) + 3]
    ax = jnp.array(bigint.ints_to_limbs(vals, K))
    wide = np.asarray(lb.fit_signed(ax, 32 * 8, 8))
    assert bigint.limbs_to_signed_ints(wide) == vals
    narrowed = np.asarray(lb.fit_signed(ax, 64, 2))
    assert bigint.limbs_to_ints(narrowed) == [v % (1 << 64) for v in vals]
    masked_wide = np.asarray(lb.fit_signed(ax, 100, 8))
    assert bigint.limbs_to_ints(masked_wide) == [v % (1 << 100) for v in vals]


def test_to_f64_centered():
    K = 5
    qb = 130
    vals = [0, 1, -1, (1 << 129) - 5, -(1 << 129) + 3, 12345678901234]
    ax = jnp.array(bigint.ints_to_limbs([v % (1 << qb) for v in vals], K))
    got = np.asarray(lb.to_f64_centered(ax, qb))
    for g, v in zip(got, vals):
        assert g == pytest.approx(float(v), rel=1e-15)


@pytest.mark.parametrize("dim", [1, 2, 5, 24])
def test_rns_roundtrip(pctx, dim):
    random.seed(5 + dim)
    n = pctx.n
    b = pctx.basis(dim)
    ba = rns_ops.make_basis_arrays(pctx, dim)
    plan = rns_ops.make_recon_plan(pctx, dim)
    res = np.stack([np.array([random.randrange(p) for _ in range(n)], dtype=np.uint64)
                    for p in b.primes])
    out = np.asarray(rns_ops.reconstruct(jnp.array(res), ba, plan))
    got = bigint.limbs_to_signed_ints(out)
    for i in range(n):
        x = sum(int(res[d, i]) * b.phat[d] * b.phat_invmp[d] for d in range(dim)) % b.P
        if x >= b.P_half:
            x -= b.P
        assert got[i] == x
    K = 30
    w = rns_ops.make_decomp_weights(pctx, dim, K)
    vals = [random.getrandbits(32 * K - random.randrange(0, 200)) for _ in range(n)]
    limbs = bigint.ints_to_limbs(vals, K)
    dres = np.asarray(rns_ops.decompose(jnp.array(limbs), ba, w))
    for d, p in enumerate(b.primes):
        assert [int(x) for x in dres[d]] == [v % p for v in vals]


def test_mont_domain(pctx):
    b = pctx.basis(2)
    a = jnp.array([[5, 7], [11, 13]], dtype=jnp.uint64)
    ps = jnp.array(b.ps)[:, None]
    pinv = jnp.array(b.pinv_mont)[:, None]
    r2 = jnp.array(b.r2)[:, None]
    am = to_mont(a, ps, pinv, r2)
    back = mont_mul(am, jnp.ones_like(a), ps, pinv)
    assert np.array_equal(np.asarray(back), np.asarray(a))


@pytest.mark.parametrize("dim", [2, 8])
def test_reconstruct_boundary_values(pctx, dim):
    """Boundary-value CRT reconstruct: values adjacent to 0, P/2 and P,
    fast (truncated k_out) vs exact path vs python-int oracle.

    Would have caught the round-2 fast-path alpha off-by-one: the f64
    alpha estimate floor(af) can miss by one exactly when value/P is within
    f64 error of 0 or 1 (v in {P-1, P-2, 1, ...}); the centered fast path
    must absorb that via the frac decision, and center=False must route to
    the exact full-width-correction path."""
    b = pctx.basis(dim)
    ba = rns_ops.make_basis_arrays(pctx, dim)
    plan = rns_ops.make_recon_plan(pctx, dim)
    P = b.P
    # signed test values; |v| small enough for a bound_bits margin >= 3
    bound_bits = plan.logP - 40
    big = (1 << bound_bits) - 1
    vals = [0, 1, 2, -1, -2, big, -big, big - 1, -(big - 1), 3, -3]
    n = pctx.n
    vals = (vals * ((n // len(vals)) + 1))[:n]
    res = np.stack([np.array([v % p for v in vals], dtype=np.uint64)
                    for p in b.primes])
    rj = jnp.array(res)
    k_out = max(2, (bound_bits + 63) // 32)  # truncated width, < plan.ks
    assert k_out < plan.ks
    fast = np.asarray(rns_ops.reconstruct(rj, ba, plan, center=True,
                                          k_out=k_out, bound_bits=bound_bits))
    exact = np.asarray(rns_ops.reconstruct(rj, ba, plan, center=True))
    mod_f = 1 << (32 * k_out)
    for i, v in enumerate(vals):
        got = bigint.limbs_to_ints(fast[i:i + 1])[0]
        assert got == v % mod_f, (i, v, got)
        got_e = bigint.limbs_to_signed_ints(exact[i:i + 1])[0]
        assert got_e == v, (i, v, got_e)
    # center=False: nonnegative residue in [0, P), exact at any k_out request
    nn = np.asarray(rns_ops.reconstruct(rj, ba, plan, center=False,
                                        k_out=plan.ks))
    for i, v in enumerate(vals):
        got = bigint.limbs_to_ints(nn[i:i + 1])[0]
        assert got == v % P, (i, v, got)


def test_reconstruct_fast_path_alpha_stress(pctx):
    """Force alpha floor misses with a perturbed inv_p table: the centered
    fast path must still be exact for in-margin values (the frac decision
    self-corrects a +-1 alpha error); this pins the actual correctness
    argument rather than the (removed) vacuous residue check."""
    import dataclasses

    dim = 8
    b = pctx.basis(dim)
    ba = rns_ops.make_basis_arrays(pctx, dim)
    plan = rns_ops.make_recon_plan(pctx, dim)
    # perturb inv_p so af picks up a ~2^-20 error: enough to flip floor(af)
    # for near-boundary values, far below the P/4 margin
    pert = plan.inv_p * (1.0 + np.float64(2.0 ** -22))
    plan_p = dataclasses.replace(plan, inv_p=pert)
    bound_bits = plan.logP - 40
    big = (1 << bound_bits) - 1
    vals = [0, 1, -1, big, -big, 12345, -12345]
    n = pctx.n
    vals = (vals * ((n // len(vals)) + 1))[:n]
    res = np.stack([np.array([v % p for v in vals], dtype=np.uint64)
                    for p in b.primes])
    k_out = max(2, (bound_bits + 63) // 32)
    fast = np.asarray(rns_ops.reconstruct(jnp.array(res), ba, plan_p,
                                          center=True, k_out=k_out,
                                          bound_bits=bound_bits))
    mod_f = 1 << (32 * k_out)
    for i, v in enumerate(vals):
        got = bigint.limbs_to_ints(fast[i:i + 1])[0]
        assert got == v % mod_f, (i, v, got)


def test_geq_const_wide_bases():
    """Hierarchical geq_const vs a python-int oracle at widths around the
    62-limb single-round exactness boundary (logn=15/logq=881 key-switch
    reaches K=68; the old single-round trick silently required K <= 62)."""
    from gpqhe_jax.ops import limbs as lb

    rng = np.random.default_rng(7)
    for k in (3, 62, 63, 68, 124, 125):
        c_int = int.from_bytes(rng.bytes(4 * k), "little")
        cl = np.frombuffer(c_int.to_bytes(4 * k, "little"), dtype=np.uint32).copy()
        vals = [0, 1, c_int - 1, c_int, c_int + 1, (1 << (32 * k)) - 1] + \
            [int.from_bytes(rng.bytes(4 * k), "little") for _ in range(24)]
        a = np.stack([np.frombuffer(v.to_bytes(4 * k, "little"),
                                    dtype=np.uint32).copy() for v in vals])
        got = np.asarray(lb.geq_const(jnp.asarray(a), jnp.asarray(cl)))
        want = np.array([v >= c_int for v in vals])
        assert np.array_equal(got, want), k
