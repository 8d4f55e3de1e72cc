"""Device modular arithmetic on u64 arrays (jnp, jit-friendly).

Equivalent of the reference's reduce.c (Montgomery with R = 2**64,
ref: src/reduce.c:36-66).  XLA has no 64x64 -> 128 multiply, so the
widening products are built here from explicit 32-bit splits; the same code
runs on every backend.
"""

from __future__ import annotations

import jax.numpy as jnp

_U32 = jnp.uint64(0xFFFFFFFF)
_32 = jnp.uint64(32)


def mulhilo64(a, b):
    """(hi, lo) of the full 128-bit product of u64 a and b."""
    a = a.astype(jnp.uint64) if hasattr(a, "astype") else jnp.uint64(a)
    b = b.astype(jnp.uint64) if hasattr(b, "astype") else jnp.uint64(b)
    al = a & _U32
    ah = a >> _32
    bl = b & _U32
    bh = b >> _32
    ll = al * bl
    lh = al * bh
    hl = ah * bl
    hh = ah * bh
    cross = (ll >> _32) + (lh & _U32) + (hl & _U32)
    hi = hh + (lh >> _32) + (hl >> _32) + (cross >> _32)
    lo = (cross << _32) | (ll & _U32)
    return hi, lo


def mulhi64(a, b):
    return mulhilo64(a, b)[0]


def mont_reduce(hi, lo, p, pinv):
    """Montgomery reduction of the 128-bit value (hi, lo): returns
    hi_lo * R^-1 mod p, R = 2**64 (ref: src/reduce.c:59-66).

    Requires hi < p (i.e. input < R*p).  Output in [0, p).
    """
    u = lo * pinv  # mod 2^64, wraps
    t = mulhi64(u, p)
    r = hi - t
    return jnp.where(hi < t, r + p, r)


def mont_mul(a, b, p, pinv):
    """a * b * R^-1 mod p.  Requires a*b < R*p (e.g. a < R=2^64 and b < p)."""
    hi, lo = mulhilo64(a, b)
    return mont_reduce(hi, lo, p, pinv)


def mulmod(a, b, p, pinv, r2):
    """Exact a*b mod p via two Montgomery multiplies (r2 = R^2 mod p).

    Semantically equal to the reference's Barrett pointwise product
    (ref: src/poly.c:77-82); the reduction algorithm itself is unobservable.
    """
    return mont_mul(mont_mul(a, b, p, pinv), r2, p, pinv)


def to_mont(a, p, pinv, r2):
    """a -> a*R mod p."""
    return mont_mul(a, r2, p, pinv)


def barrett_inv(q: int) -> int:
    """Host: 2^(2*nbits(q)) / q (ref: src/reduce.c:75-78)."""
    return (1 << (2 * q.bit_length())) // q


def barrett_reduce(hi, lo, q, qinv, qbits: int):
    """(hi,lo) 128-bit value mod q via Barrett (ref: src/reduce.c:88-106).

    qinv = floor(2^(2*qbits)/q); requires 2*qbits >= 64.  Semantically equal
    to the Montgomery-pair mulmod used on the hot path; kept for parity and
    for callers that have values (not products) to reduce."""
    t_hi1, t_lo1 = mulhilo64(lo, qinv)
    t2_hi, t2_lo = mulhilo64(hi, qinv)
    # t = (lo*qinv >> 64) + hi*qinv  as a 128-bit value
    t_lo = t_hi1 + t2_lo
    carry = (t_lo < t2_lo).astype(jnp.uint64)
    t_hi = t2_hi + carry
    shift = 2 * qbits - 64
    if shift > 0:
        t_shifted = (t_lo >> jnp.uint64(shift)) | (t_hi << jnp.uint64(64 - shift))
    else:
        t_shifted = t_lo
    r = lo - t_shifted * q
    return jnp.where(r >= q, r - q, r)


def addmod(a, b, p):
    """(a + b) mod p for a, b in [0, p) with p < 2^63."""
    s = a + b
    return jnp.where(s >= p, s - p, s)


def submod(a, b, p):
    """(a - b) mod p for a, b in [0, p)."""
    d = a - b
    return jnp.where(a < b, d + p, d)
