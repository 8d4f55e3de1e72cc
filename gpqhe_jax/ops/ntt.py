"""Batched negacyclic NTT / INTT over a stack of RNS primes.

Vectorized reformulation of the reference's scalar butterfly loops
(ref: src/ntt.c:37-73): each stage becomes one vectorized butterfly over the
whole [dim, n] residue tensor (reshape to [dim, nblocks, 2, len]), so XLA sees
logn fused elementwise passes instead of n/2*logn scalar iterations.  Twiddles
are Montgomery-domain, bit-reversed, identical to the reference tables
(ref: src/precomp.c:244-264).

Shapes:
  a:      u64[..., dim, n]   residues per prime (leading batch dims allowed)
  zetas:  u64[dim, n]
  ps:     u64[dim]
  pinv:   u64[dim]
"""

from __future__ import annotations

import jax.numpy as jnp

from .modmath import mont_mul, addmod, submod


def _bcast(x, a_ndim):
    """Broadcast per-prime scalar [dim] against [..., dim, nblocks, 2?, len]."""
    return x.reshape(x.shape + (1,) * (a_ndim - 1))


def ntt(a, zetas, ps, pinv):
    """Forward negacyclic NTT, in bit-reversed twiddle order (ref: src/ntt.c:37-52)."""
    n = a.shape[-1]
    dim = a.shape[-2]
    batch = a.shape[:-2]
    ln = n.bit_length() - 1
    p = ps.reshape((1,) * len(batch) + (dim, 1, 1))
    pv = pinv.reshape((1,) * len(batch) + (dim, 1, 1))
    length = n // 2
    while length >= 1:
        nblocks = n // (2 * length)
        x = a.reshape(batch + (dim, nblocks, 2, length))
        z = zetas[:, nblocks:2 * nblocks].reshape((1,) * len(batch) + (dim, nblocks, 1))
        x0 = x[..., 0, :]
        x1 = x[..., 1, :]
        t = mont_mul(x1, z, p, pv)
        y0 = addmod(x0, t, p)
        y1 = submod(x0, t, p)
        a = jnp.stack([y0, y1], axis=-2).reshape(batch + (dim, n))
        length //= 2
    del ln
    return a


def ntt_galois_perm(logn: int, rot: int | None) -> "np.ndarray":
    """Index permutation realizing the galois automorphism IN THE NTT DOMAIN.

    The butterfly NTT's output index i holds the evaluation at w^(2*brv(i)+1)
    (w = 2n-th root; Kyber-shaped CT network, ref: src/ntt.c:37-52).  The
    automorphism X -> X^g (g = 5^rot for rotations, ref: src/poly.c:263-276;
    g = -1 for conjugation, ref: src/poly.c:278-283) evaluates the original
    polynomial at w^(e*g), so NTT(galois(a))[j] = NTT(a)[perm[j]] with
    2*brv(perm[j])+1 = (2*brv(j)+1)*g mod 2n — a pure permutation (no signs:
    Montgomery/scale factors are index-independent).  Valid for the
    'butterfly' backend; NOT for 'matmul'."""
    import numpy as np
    n = 1 << logn
    m = 2 * n
    g = pow(5, rot, m) if rot is not None else m - 1

    def brv(x):
        r = 0
        for _ in range(logn):
            r = (r << 1) | (x & 1)
            x >>= 1
        return r

    e = np.array([2 * brv(j) + 1 for j in range(n)], dtype=np.int64)
    inv_e = np.zeros(m, dtype=np.int64)
    inv_e[e] = np.arange(n)
    return inv_e[(e * g) % m].astype(np.int32)


def ntt_numpy(a, zetas, p, pinv):
    """Host reference for ntt() over ONE prime: the same butterfly network in
    vectorized numpy u64 (a u64[..., n], zetas u64[n], p and pinv np.uint64).
    The independent oracle the device NTT is checked against bit for bit."""
    import numpy as np
    M32 = np.uint64(0xFFFFFFFF)
    S32 = np.uint64(32)

    def mulhilo(x, y):
        xl, xh, yl, yh = x & M32, x >> S32, y & M32, y >> S32
        ll, lh, hl = xl * yl, xl * yh, xh * yl
        cross = (ll >> S32) + (lh & M32) + (hl & M32)
        hi = xh * yh + (lh >> S32) + (hl >> S32) + (cross >> S32)
        lo = (cross << S32) | (ll & M32)
        return hi, lo

    def mont_mul_np(x, y):
        hi, lo = mulhilo(x, y)
        t, _ = mulhilo(lo * pinv, p)
        r = hi - t
        return np.where(hi < t, r + p, r)

    n = a.shape[-1]
    length = n // 2
    while length >= 1:
        nblocks = n // (2 * length)
        x = a.reshape(a.shape[:-1] + (nblocks, 2, length))
        z = zetas[nblocks:2 * nblocks].reshape(nblocks, 1)
        x0 = x[..., 0, :]
        t = mont_mul_np(x[..., 1, :], z)
        s = x0 + t
        y0 = np.where(s >= p, s - p, s)
        d = x0 - t
        y1 = np.where(x0 < t, d + p, d)
        a = np.stack([y0, y1], axis=-2).reshape(a.shape)
        length //= 2
    return a


def intt(a, zetas_inv, ps, pinv, ninv_mont):
    """Inverse NTT, Gentleman-Sande order, with final n^-1 scaling
    (ref: src/ntt.c:54-73)."""
    n = a.shape[-1]
    dim = a.shape[-2]
    batch = a.shape[:-2]
    p = ps.reshape((1,) * len(batch) + (dim, 1, 1))
    pv = pinv.reshape((1,) * len(batch) + (dim, 1, 1))
    length = 1
    while length <= n // 2:
        nblocks = n // (2 * length)
        x = a.reshape(batch + (dim, nblocks, 2, length))
        z = zetas_inv[:, nblocks:2 * nblocks].reshape((1,) * len(batch) + (dim, nblocks, 1))
        x0 = x[..., 0, :]
        x1 = x[..., 1, :]
        y0 = addmod(x0, x1, p)
        y1 = mont_mul(submod(x0, x1, p), z, p, pv)
        a = jnp.stack([y0, y1], axis=-2).reshape(batch + (dim, n))
        length *= 2
    pfull = ps.reshape((1,) * len(batch) + (dim, 1))
    pvfull = pinv.reshape((1,) * len(batch) + (dim, 1))
    nv = ninv_mont.reshape((1,) * len(batch) + (dim, 1))
    return mont_mul(a, nv, pfull, pvfull)
