"""RingEngine's NTT entry points on stacked [P, dim, n] inputs, checked
against a schoolbook negacyclic product (ref: src/poly.c:84-107 semantics),
and the backend choice."""

import numpy as np
import pytest

import jax.numpy as jnp

from gpqhe_jax.context import HeContext, PolyContext
from gpqhe_jax.ring.poly import RingEngine
from gpqhe_jax.scheme.engine import CKKS

LOGN, DIM = 6, 3
N = 1 << LOGN


@pytest.fixture(scope="module")
def ring():
    return RingEngine(PolyContext(LOGN, q=1 << 54, dim_cap=DIM))


def _rand(ring, P, seed):
    rng = np.random.default_rng(seed)
    return np.stack([np.stack([rng.integers(0, p, N, dtype=np.uint64)
                               for p in ring.pctx.primes[:DIM]])
                     for _ in range(P)])


def _as_int(x):
    return np.asarray(x).astype(object)


def _schoolbook(a, b, p):
    """Negacyclic product mod X^n + 1, mod p, in Python ints."""
    full = np.convolve(a, b)
    c = full[:N].copy()
    c[:N - 1] -= full[N:]
    return c % p


def _pointwise(x, y, ps):
    return (x * y) % np.array(ps, dtype=object)[:, None]


@pytest.mark.parametrize("P", [1, 4])
@pytest.mark.parametrize("direction", ["forward", "inverse"])
def test_stacked_ntt_vs_schoolbook(ring, P, direction):
    """forward: F(a*b) == F(a).F(b);  inverse: G(x.y) == G(x)*G(y)."""
    ps = ring.pctx.primes[:DIM]
    x, y = _rand(ring, P, 1), _rand(ring, P, 2)
    t = ring.ntt_f if direction == "forward" else ring.ntt_i
    tx, ty = _as_int(t(jnp.asarray(x), DIM)), _as_int(t(jnp.asarray(y), DIM))
    assert tx.shape == (P, DIM, N)
    xo, yo = x.astype(object), y.astype(object)
    for k in range(P):
        if direction == "forward":
            prod = np.stack([_schoolbook(xo[k, d], yo[k, d], ps[d])
                             for d in range(DIM)])
            got = _as_int(t(jnp.asarray(prod.astype(np.uint64)), DIM))
            want = _pointwise(tx[k], ty[k], ps)
        else:
            got = _as_int(t(jnp.asarray(
                _pointwise(xo[k], yo[k], ps).astype(np.uint64)), DIM))
            want = np.stack([_schoolbook(tx[k, d], ty[k, d], ps[d])
                             for d in range(DIM)])
        assert np.array_equal(got, want), f"poly {k} differs"


def test_unknown_ntt_impl_rejected():
    pctx = PolyContext(LOGN, q=1 << 54, dim_cap=DIM)
    with pytest.raises(ValueError, match="ntt_impl"):
        RingEngine(pctx, ntt_impl="pallas")
    ctx = HeContext(logn=6, q=1 << 110, slots=4, Delta=1 << 30)
    with pytest.raises(ValueError, match="ntt_impl"):
        CKKS(ctx, ntt_impl="pallas")
