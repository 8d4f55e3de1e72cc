"""Four-step (Bailey) negacyclic NTT with matmul stages.

The butterfly NTT (ops/ntt.py) is elementwise u64 work.  This variant reshapes the transform into two modular matrix multiplies
(n = n1*n2; DFT_n1 columns, twiddle, DFT_n2 rows), where each modular matmul
runs as 16 exact f64 matmuls over 16-bit digit planes (every product
<= 2^32, every dot sum <= 2^42 << 2^53 — integer-exact in f64) followed by one short modular recombination per element.

Mathematically: negacyclic NTT(a)_k = sum_i a_i psi^(2ik+i); pre-twisting by
psi^i reduces it to a cyclic DFT with omega = psi^2 (ref equivalent:
src/ntt.c:37-73 computes the same evaluations in bit-reversed order; here the
order is the natural four-step order — internally consistent fwd/inv pairs,
pointwise products unaffected).

Evaluation-order note: ntt4's output ordering differs from ops/ntt.py's
bit-reversed ordering, so the two families must not be mixed on the same
NTT-resident data (e.g. evks built with one must be consumed with the same).
"""

from __future__ import annotations

from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

from .modmath import mont_mul, addmod

_D16 = 4  # 16-bit digit planes per <2^64 operand


@dataclass(frozen=True)
class Ntt4Plan:
    """Per-basis constants for the four-step NTT over dim primes."""
    n1: int
    n2: int
    dim: int
    ps: jnp.ndarray          # u64[dim]
    pinv: jnp.ndarray        # u64[dim]
    # forward
    w1dig: jnp.ndarray       # f64[dim, 4, n1, n1] digit planes of DFT_n1 matrix
    w2dig: jnp.ndarray       # f64[dim, 4, n2, n2]
    twid: jnp.ndarray        # u64[dim, n1, n2] Montgomery-domain omega^(i2*k1)
    twist: jnp.ndarray       # u64[dim, n] Montgomery psi^i (pre-twist)
    # inverse
    w1dig_i: jnp.ndarray
    w2dig_i: jnp.ndarray
    twid_i: jnp.ndarray
    twist_i: jnp.ndarray     # u64[dim, n] Montgomery psi^-i * n^-1 (post-twist)
    c_pow: jnp.ndarray       # u64[dim, 3]: (2^0, 2^64, 2^128)*R mod p


def _digits16_f64(m: np.ndarray) -> np.ndarray:
    """u64 matrix -> f64[4, ...] 16-bit digit planes."""
    out = np.empty((_D16,) + m.shape, dtype=np.float64)
    for t in range(_D16):
        out[t] = ((m >> np.uint64(16 * t)) & np.uint64(0xFFFF)).astype(np.float64)
    return out


def make_ntt4_plan(pctx, dim: int) -> Ntt4Plan:
    from ..context import mth_root_of_unity

    n = pctx.n
    n1 = 1 << (pctx.logn // 2)
    n2 = n // n1
    R = pctx.R
    w1dig, w2dig, twid, twist = [], [], [], []
    w1dig_i, w2dig_i, twid_i, twist_i = [], [], [], []
    c_pow = []
    i1 = np.arange(n1, dtype=object)
    i2 = np.arange(n2, dtype=object)
    for d in range(dim):
        p = pctx.primes[d]
        psi = mth_root_of_unity(2 * n, p)   # same root family as ntt tables
        omega = psi * psi % p
        w_n1 = pow(omega, n2, p)            # n1-th root
        w_n2 = pow(omega, n1, p)            # n2-th root

        def powmat(base, rows, cols):
            r = np.array([[pow(base, int(a * b), p) for b in range(cols)]
                          for a in range(rows)], dtype=np.uint64)
            return r

        W1 = powmat(w_n1, n1, n1)
        W2 = powmat(w_n2, n2, n2)
        W1i = powmat(pow(w_n1, p - 2, p), n1, n1)
        W2i = powmat(pow(w_n2, p - 2, p), n2, n2)
        w1dig.append(_digits16_f64(W1))
        w2dig.append(_digits16_f64(W2))
        w1dig_i.append(_digits16_f64(W1i))
        w2dig_i.append(_digits16_f64(W2i))
        # twiddle omega^(i2*k1) in Montgomery domain, laid out [k1(n1), i2(n2)]
        om_i = pow(omega, p - 2, p)
        tw = np.array([[pow(omega, int(k1 * j2), p) * R % p for j2 in range(n2)]
                       for k1 in range(n1)], dtype=np.uint64)
        twi = np.array([[pow(om_i, int(k1 * j2), p) * R % p for j2 in range(n2)]
                        for k1 in range(n1)], dtype=np.uint64)
        twid.append(tw)
        twid_i.append(twi)
        # twists psi^i (Montgomery); inverse twist folds in n^-1
        psii = pow(psi, p - 2, p)
        ninv = pow(n, p - 2, p)
        tws = np.empty(n, dtype=np.uint64)
        twsi = np.empty(n, dtype=np.uint64)
        cur = 1
        curi = ninv % p
        for i in range(n):
            tws[i] = cur * R % p
            twsi[i] = curi * R % p
            cur = cur * psi % p
            curi = curi * psii % p
        twist.append(tws)
        twist_i.append(twsi)
        c_pow.append([R % p, (1 << 64) * R % p, (1 << 128) * R % p])
    b = pctx.basis(dim)
    return Ntt4Plan(
        n1=n1, n2=n2, dim=dim,
        ps=jnp.array(b.ps), pinv=jnp.array(b.pinv_mont),
        w1dig=jnp.asarray(np.stack(w1dig)), w2dig=jnp.asarray(np.stack(w2dig)),
        twid=jnp.asarray(np.stack(twid)), twist=jnp.asarray(np.stack(twist)),
        w1dig_i=jnp.asarray(np.stack(w1dig_i)), w2dig_i=jnp.asarray(np.stack(w2dig_i)),
        twid_i=jnp.asarray(np.stack(twid_i)), twist_i=jnp.asarray(np.stack(twist_i)),
        c_pow=jnp.asarray(np.array(c_pow, dtype=np.uint64)),
    )


def _moddot(wdig, x, ps, pinv, c_pow, transpose_x: bool = False):
    """Modular matmul W @ X over [dim] batch: wdig f64[dim, 4, m, k],
    x u64[..., dim, k, j] -> u64[..., dim, m, j].

    16 exact f64 matmuls over digit planes, then one recombination mod p.
    """
    xd = [((x >> jnp.uint64(16 * u)) & jnp.uint64(0xFFFF)).astype(jnp.float64)
          for u in range(_D16)]
    # S_w = sum_{u+v=w} W_v @ X_u, w in 0..6; each S_w < 4 * 2^42
    s = [None] * (2 * _D16 - 1)
    for v in range(_D16):
        wv = wdig[:, v]
        for u in range(_D16):
            prod = jnp.einsum("dmk,...dkj->...dmj", wv, xd[u])
            w = u + v
            s[w] = prod if s[w] is None else s[w] + prod
    # carry-assemble sum_w S_w 2^16w into three u64 limbs (value < 2^150)
    digits = []
    carry = None
    for w in range(len(s)):
        cur = s[w].astype(jnp.uint64)
        if carry is not None:
            cur = cur + carry
        digits.append(cur & jnp.uint64(0xFFFF))
        carry = cur >> jnp.uint64(16)
    # remaining carry spans more 16-bit digits
    for _ in range(4):
        digits.append(carry & jnp.uint64(0xFFFF))
        carry = carry >> jnp.uint64(16)
    while len(digits) < 12:
        digits.append(jnp.zeros_like(digits[0]))
    L = []
    for g in range(3):
        limb = digits[4 * g]
        for t in range(1, 4):
            limb = limb | (digits[4 * g + t] << jnp.uint64(16 * t))
        L.append(limb)
    # value mod p = mont(L0, R) + mont(L1, 2^64 R) + mont(L2, 2^128 R)
    psb = ps[:, None, None]
    pvb = pinv[:, None, None]
    acc = mont_mul(L[0], c_pow[:, 0][:, None, None], psb, pvb)
    acc = addmod(acc, mont_mul(L[1], c_pow[:, 1][:, None, None], psb, pvb), psb)
    acc = addmod(acc, mont_mul(L[2], c_pow[:, 2][:, None, None], psb, pvb), psb)
    return acc


def ntt4(a, plan: Ntt4Plan):
    """Forward negacyclic NTT, natural four-step order.
    a: u64[..., dim, n] -> u64[..., dim, n]."""
    n1, n2 = plan.n1, plan.n2
    ps = plan.ps[:, None]
    pinv = plan.pinv[:, None]
    b = mont_mul(a, plan.twist, ps, pinv)                  # pre-twist psi^i
    A = b.reshape(b.shape[:-1] + (n1, n2))                 # A[i1, i2], i = i1*n2+i2
    psb = plan.ps[:, None, None]
    pvb = plan.pinv[:, None, None]
    C = _moddot(plan.w1dig, A, plan.ps, plan.pinv, plan.c_pow)   # [k1, i2]
    C = mont_mul(C, plan.twid, psb, pvb)                   # * omega^(i2 k1)
    # D[k1, k2] = sum_{i2} C[k1, i2] W2[i2, k2]  ==  (W2^T @ C^T)^T
    Ct = jnp.swapaxes(C, -1, -2)                           # [i2, k1]
    Dt = _moddot(plan.w2dig, Ct, plan.ps, plan.pinv, plan.c_pow)  # [k2, k1]
    # out[k1 + n1*k2] = D[k1, k2] = Dt[k2, k1] -> flatten Dt rows
    return Dt.reshape(Dt.shape[:-2] + (n1 * n2,))


def intt4(ahat, plan: Ntt4Plan):
    """Inverse of ntt4 (including the n^-1 and psi^-i untwist)."""
    n1, n2 = plan.n1, plan.n2
    ps = plan.ps[:, None]
    pinv = plan.pinv[:, None]
    psb = plan.ps[:, None, None]
    pvb = plan.pinv[:, None, None]
    # input index k = k1 + n1 k2 -> Dt[k2, k1]
    Dt = ahat.reshape(ahat.shape[:-1] + (n2, n1))
    Ct = _moddot(plan.w2dig_i, Dt, plan.ps, plan.pinv, plan.c_pow)  # [i2, k1]
    C = jnp.swapaxes(Ct, -1, -2)                            # [k1, i2]
    C = mont_mul(C, plan.twid_i, psb, pvb)
    A = _moddot(plan.w1dig_i, C, plan.ps, plan.pinv, plan.c_pow)    # [i1, i2]
    b = A.reshape(A.shape[:-2] + (n1 * n2,))
    return mont_mul(b, plan.twist_i, ps, pinv)              # untwist * n^-1
