"""Shrunken-prime CRT debug mode: logp=9 (the reference's -DTEST_CRT,
ref: src/params.h:30-33, tests/crt.c:94-214, tests/Makefile:23-29).

Round-trips decompose -> reconstruct at every dim from dimub down to 1 with
9-bit primes, where intermediate values are eyeball-able."""

import random

import jax.numpy as jnp
import numpy as np
import pytest

from gpqhe_jax.context import PolyContext
from gpqhe_jax.ops import rns as rns_ops
from gpqhe_jax.substrate import bigint


def test_crt_9bit_primes():
    logn = 4
    pctx = PolyContext(logn, q=1 << 8, logp=9, dim_cap=6)
    n = pctx.n
    # chain starts at 2^9+1 stepping 2n; tiny n means the chain climbs fast
    assert all(10 <= p.bit_length() <= 11 for p in pctx.primes), pctx.primes
    random.seed(21)
    for dim in range(pctx.dimub, 0, -1):
        b = pctx.basis(dim)
        ba = rns_ops.make_basis_arrays(pctx, dim)
        plan = rns_ops.make_recon_plan(pctx, dim)
        vals = [random.randrange(b.P) for _ in range(n)]
        k = bigint.nlimbs(b.P.bit_length())
        limbs = jnp.asarray(bigint.ints_to_limbs(vals, k))
        w = rns_ops.make_decomp_weights(pctx, dim, k)
        res = rns_ops.decompose(limbs, ba, w)
        for d, p in enumerate(b.primes):
            assert [int(x) for x in np.asarray(res)[d]] == [v % p for v in vals]
        back = rns_ops.reconstruct(res, ba, plan, center=False)
        got = bigint.limbs_to_ints(np.asarray(back))
        assert got == vals, f"dim={dim}"


def test_crt_ntt_small_primes():
    """NTT still works over the 9-bit chain (p = 1 mod 2n holds)."""
    from gpqhe_jax.ops.ntt import intt, ntt

    pctx = PolyContext(4, q=1 << 8, logp=9, dim_cap=3)
    ba = rns_ops.make_basis_arrays(pctx, 3)
    random.seed(22)
    a = np.stack([np.array([random.randrange(p) for _ in range(16)], dtype=np.uint64)
                  for p in pctx.primes[:3]])
    rt = intt(ntt(jnp.asarray(a), ba.zetas, ba.ps, ba.pinv),
              ba.zetas_inv, ba.ps, ba.pinv, ba.ninv_mont)
    assert np.array_equal(np.asarray(rt), a)
