"""RNS decompose / CRT reconstruct between limb tensors and residue stacks.

Device equivalents of the reference's rns.c (ref: src/rns.c:37-75) and the
CRT-lift half of poly_rns2mpi (ref: src/poly.c:109-120):

  decompose:    u32-limb poly [n, K]  ->  residues u64[dim, n]  (a mod p_d)
  reconstruct:  residues u64[dim, n]  ->  centered limbs [n, KS]
                (CRT lift, then smod P — the exact integer the product equals)

The reconstruct avoids per-coefficient big-int division: y_d = a_d*phat_d^-1
mod p_d, S = sum_d y_d*phat_d (exact, 16-bit digit accumulation), and the
CRT overflow multiple alpha = floor(S/P) < dim is estimated in f64 and
corrected exactly with limb compares (standard RNS lift; the reference instead
does dim big-int mulm/addm per coefficient, ref: src/rns.c:60-75).
"""

from __future__ import annotations

from dataclasses import dataclass

import jax.numpy as jnp
import numpy as np

from ..substrate import bigint
from .modmath import mont_mul
from . import limbs as lb


@dataclass(frozen=True)
class BasisArrays:
    """Device copies of per-basis constants (uploaded once per context)."""
    dim: int
    ps: jnp.ndarray            # u64[dim]
    pinv: jnp.ndarray          # u64[dim]
    ninv_mont: jnp.ndarray     # u64[dim]
    r2: jnp.ndarray            # u64[dim]
    phatinv_mont: jnp.ndarray  # u64[dim]
    ninvphat_mont: jnp.ndarray  # u64[dim] n^-1 phat^-1 (scaled-INTT constant)
    zetas: jnp.ndarray         # u64[dim, n]
    zetas_inv: jnp.ndarray     # u64[dim, n]


@dataclass(frozen=True)
class ReconPlan:
    """Constants for CRT reconstruction over one basis."""
    dim: int
    ds: int                 # digit width of the accumulator (16-bit digits)
    ks: int                 # output limb count = ds // 2
    phat16: np.ndarray      # u64[dim, ds] digits of phat_d
    negP16: np.ndarray      # u64[ds] digits of 2^(16 ds) - P
    P_limbs: np.ndarray     # u32[ks]
    Phalf_limbs: np.ndarray  # u32[ks] floor(P/2)
    MminusP_limbs: np.ndarray  # u32[ks] 2^(32 ks) - P
    inv_p: np.ndarray       # f64[dim]
    logP: int               # P.bit_length() (fast-path margin validation)
    nplanes: int = 8        # 8-bit digit planes covering one residue (< p)


def make_basis_arrays(poly_ctx, dim: int) -> BasisArrays:
    b = poly_ctx.basis(dim)
    return BasisArrays(
        dim=dim,
        ps=jnp.array(b.ps),
        pinv=jnp.array(b.pinv_mont),
        ninv_mont=jnp.array(b.ninv_mont),
        r2=jnp.array(b.r2),
        phatinv_mont=jnp.array(b.phatinv_mont),
        ninvphat_mont=jnp.array(b.ninvphat_mont),
        zetas=jnp.array(poly_ctx.zetas(dim)),
        zetas_inv=jnp.array(poly_ctx.zetas_inv(dim)),
    )


def make_recon_plan(poly_ctx, dim: int) -> ReconPlan:
    b = poly_ctx.basis(dim)
    ds = (b.P.bit_length() + 15) // 16 + 2
    if ds % 2:
        ds += 1
    ks = ds // 2
    M = 1 << (16 * ds)
    phat16 = np.stack([bigint.digits16(ph, ds) for ph in b.phat]).astype(np.uint64)
    negP16 = bigint.digits16(M - b.P, ds).astype(np.uint64)
    return ReconPlan(
        dim=dim, ds=ds, ks=ks,
        phat16=phat16,
        negP16=negP16,
        P_limbs=bigint.int_to_limbs(b.P, ks),
        Phalf_limbs=bigint.int_to_limbs(b.P_half, ks),
        MminusP_limbs=bigint.int_to_limbs((1 << (32 * ks)) - b.P, ks),
        inv_p=np.array([1.0 / p for p in b.primes], dtype=np.float64),
        logP=b.P.bit_length(),
        # residues are < p: short-prime chains (logp<=29 perf mode, TEST_CRT)
        # need fewer source digit planes, keeping the matmul contraction length
        # nplanes*dim roughly constant as dim grows with 1/logp
        nplanes=(max(b.primes).bit_length() + 7) // 8,
    )


def make_decomp_weights(poly_ctx, dim: int, k_limbs: int) -> np.ndarray:
    """u64[dim, J]: V_j = 2^(64(j+1)) mod p_d, J = ceil(K/2) (so that
    mont_mul(c_j, V_j) == c_j * 2^(64 j) mod p for u64 digits c_j)."""
    j_digits = (k_limbs + 1) // 2
    out = np.empty((dim, j_digits), dtype=np.uint64)
    for d, p in enumerate(poly_ctx.primes[:dim]):
        for j in range(j_digits):
            out[d, j] = pow(2, 64 * (j + 1), p)
    return out


def decompose_core(a, ps, pinv, weights) -> jnp.ndarray:
    """All-arrays decompose (shardable: pass per-shard ps/pinv/weights)."""
    k = a.shape[-1]
    j_digits = (k + 1) // 2
    if k % 2:
        a = lb.resize(a, k + 1)
    au = a.astype(jnp.uint64)
    # u64 digits c_j = limb[2j] | limb[2j+1] << 32 -> [..., n, J]
    c = au[..., 0::2] | (au[..., 1::2] << jnp.uint64(32))
    w = jnp.asarray(weights)  # [dim, J]
    # accumulate over digits, keeping partial sums < p
    acc = None
    for j in range(j_digits):
        cj = c[..., None, :, j]                     # [..., 1, n]
        term = mont_mul(cj, w[:, j][:, None], ps[:, None], pinv[:, None])
        if acc is None:
            acc = term
        else:
            s = acc + term
            acc = jnp.where(s >= ps[:, None], s - ps[:, None], s)
    return acc


def decompose(a, ba: BasisArrays, weights) -> jnp.ndarray:
    """u32[..., n, K] -> u64[..., dim, n]: a mod p_d per prime
    (ref: src/rns.c:37-48; input is a nonnegative representative)."""
    return decompose_core(a, ba.ps, ba.pinv, weights)


# Chunk size (primes) for the exact bf16 digit matmul: one chunk's
# contraction is 8 digit planes x _CHUNK_PRIMES primes, so every f32
# partial sum is <= 8 * 32 * 255^2 < 2^24.  Integers below 2^24 are exact
# in f32 whatever order the GEMM (cuBLAS tensor cores on the GPU) sums them
# in.  Chunk results are summed exactly in i32.
_CHUNK_PRIMES = 32


def phat_plane_table(plan: ReconPlan) -> np.ndarray:
    """f32[dim, nplanes, 2*ds]: 8-bit digit planes of phat_d, shifted by the
    source digit position t (row (d, t), col s holds phat8[d, s - t]).
    Operand of the exact bf16 digit matmul in reconstruct_core: 8-bit
    digits make both matmul inputs bf16-exact, so a bf16 x bf16 -> f32
    matrix product computes the digit convolution EXACTLY (every product
    < 2^16, chunked accumulation < 2^24).  nplanes = the source
    planes a residue (< p) actually occupies (8 for the 59-bit chain, 4 for
    the logp<=29 perf chain)."""
    ds8 = 2 * plan.ds
    phat8 = np.zeros((plan.dim, ds8), dtype=np.float32)
    phat8[:, 0::2] = (plan.phat16 & np.uint64(0xFF)).astype(np.float32)
    phat8[:, 1::2] = ((plan.phat16 >> np.uint64(8)) & np.uint64(0xFF)).astype(np.float32)
    out = np.zeros((plan.dim, plan.nplanes, ds8), dtype=np.float32)
    for t in range(plan.nplanes):
        out[:, t, t:] = phat8[:, :ds8 - t]
    return out


def digit_matmul_cols(y8, planes):
    """Exact digit convolution as a matrix product: y8 [..., K, n] bf16 (8-bit digit
    planes, K = 8 * dim), planes [K, kd8] bf16 (shifted 8-bit weight digits)
    -> i32 [..., n, kd8] per-column sums of 8-bit digit products.

    Every product < 2^16 and every chunk accumulates <= 8 * _CHUNK_PRIMES
    terms, so every f32 partial sum is integer-exact per chunk; chunks are
    summed exactly in i32.  Each column sum is bounded by
    8 * dim * 255^2 < 2^25 for any dim <= ~8000 — small enough that the
    sharded path can psum these columns in u32 exactly BEFORE the 16-bit
    fold (the folded sums are 257x larger and would wrap u32 at dim >= 37)."""
    K = y8.shape[-2]
    step = 8 * _CHUNK_PRIMES
    acc = None
    for c0 in range(0, K, step):
        part = jnp.einsum("...kn,ks->...ns", y8[..., c0:c0 + step, :],
                          planes[c0:c0 + step],
                          preferred_element_type=jnp.float32)
        pi = part.astype(jnp.int32)
        acc = pi if acc is None else acc + pi
    return acc


def fold_cols_u16(s8_cols):
    """i32/u32 8-bit column sums [..., n, kd8] -> u64 16-bit digit sums
    [..., n, kd8 // 2]: s[0::2] + 256 * s[1::2] (< 2^34 in u64)."""
    s8 = s8_cols.astype(jnp.uint64)
    return s8[..., 0::2] + (s8[..., 1::2] << jnp.uint64(8))


def digit_matmul_u16(y8, planes):
    """digit_matmul_cols followed by the 16-bit fold (single-device path)."""
    return fold_cols_u16(digit_matmul_cols(y8, planes))


def reconstruct_core(res, ps, pinv, phatinv_mont, phat_planes, inv_p, negP16,
                     MminusP_limbs, P_limbs, Phalf_limbs, ks: int, dim_total: int,
                     center: bool = True, axis_name: str | None = None,
                     k_out: int | None = None,
                     pre_scaled: bool = False):
    """All-arrays CRT reconstruction (shardable over the prime axis).

    When axis_name is given, `res`/constants hold only this shard's primes and
    the digit sums + alpha estimate are combined with a psum over that mesh
    axis (the CRT partial-sum collective, SURVEY.md §2).

    When k_out is given (center=True ONLY — reconstruct() enforces this),
    the TRUNCATED fast path runs: only the low 2*k_out digit columns of S
    are accumulated (the value is needed mod 2^(32 k_out) only — callers
    immediately mask to q_l).  Correctness argument: with v = S mod P and
    alpha_true = floor(S/P), the f64 estimate af = S/P + eps has
    |eps| < dim * 2^-51, so frac = af - floor(af) equals
    (alpha_true - floor(af)) + v/P + eps.  floor(af) can differ from
    alpha_true only when v/P is within |eps| of 0 or 1, and the caller's
    proven magnitude margin (reconstruct() checks logP - bound_bits >= 3,
    i.e. |value| <= P/4) keeps frac inside [0, 1/4+eps] u [3/4-eps, 1+eps];
    subtracting P exactly when frac > 1/2 therefore yields the centered
    value mod 2^(32 k_out) and absorbs the floor off-by-one in one step.
    center=False has no such self-correcting decision at truncated width,
    so it always takes the exact full-width-compare path below.
    """
    psb = ps[:, None]
    pinvb = pinv[:, None]
    fast = k_out is not None
    if pre_scaled:
        # the INTT already multiplied by phatinv (scaled-INTT fusion)
        y = res
    else:
        y = mont_mul(res, phatinv_mont[:, None], psb, pinvb)  # [..., dim, n]
    # S = sum_d y_d * phat_d via the exact bf16 digit matmul (8-bit
    # digit planes; see digit_matmul_cols for the exactness argument).
    dim_here = res.shape[-2]
    n_here = res.shape[-1]
    kd8_full = phat_planes.shape[-1]
    npl = phat_planes.shape[-2]
    kd8 = min(4 * k_out, kd8_full) if fast else kd8_full
    kd = kd8 // 2
    y8 = jnp.stack(
        [((y >> jnp.uint64(8 * t)) & jnp.uint64(0xFF)).astype(jnp.bfloat16)
         for t in range(npl)], axis=-2)                   # [..., dim, npl, n]
    Y = y8.reshape(y.shape[:-2] + (npl * dim_here, n_here))
    W = phat_planes[..., :kd8].reshape(npl * dim_here, kd8).astype(jnp.bfloat16)
    s_cols = digit_matmul_cols(Y, W)                      # i32[..., n, kd8]
    # alpha = floor(S / P) estimated in f64, corrected exactly below.  An
    # f64 contraction is native on the GPU (DGEMM) and never runs in TF32,
    # which only ever replaces f32 products.
    af = jnp.einsum("...dn,d->...n", y.astype(jnp.float64), inv_p)
    if axis_name is not None:
        import jax
        # The collectives carry 32-bit types: an exact u32 sum of the digit
        # columns and an f32 sum of the alpha estimate (half the bytes of
        # u64/f64).  The psum runs on the PRE-FOLD 8-bit column sums: each
        # column is < 8*dim_total*255^2 < 2^25 at any security-table dim (u32-exact up
        # to dim_total ~8000).  The folded 16-bit sums would be 257x larger
        # and wrap u32 at dim_total >= 37 (the bootstrap-scale key-switch
        # basis is ~48), so the fold happens AFTER the psum.  The alpha
        # estimate tolerates f32: per-shard rounding <= 2^-24 * dim_total
        # stays far inside both the exact path's +/-1 alpha correction and
        # the fast path's 1/4 frac margin.
        s_cols = jax.lax.psum(
            s_cols.astype(jnp.uint32), axis_name).astype(jnp.int32)
        af = jax.lax.psum(
            af.astype(jnp.float32), axis_name).astype(jnp.float64)
    s_digits = fold_cols_u16(s_cols)                      # u64[..., n, kd]
    alpha = jnp.clip(jnp.floor(af), 0.0, float(dim_total))
    # S - alpha*P == S + alpha*(M - P) mod M: digit sums stay < 2^34 + 2^23
    s_digits = s_digits + alpha.astype(jnp.uint64)[..., None] * negP16[:kd]
    if not fast:
        r = lb.from_digits16(s_digits, ks)                # u32[..., n, ks]
        # correct alpha off-by-one: E in (-P, 2P)
        r = lb.select(lb.geq_const(r, MminusP_limbs),
                      lb.add(r, jnp.broadcast_to(P_limbs, r.shape)), r)
        r = lb.select(lb.geq_const(r, P_limbs),
                      lb.sub(r, jnp.broadcast_to(P_limbs, r.shape)), r)
        if center:
            # smod P (ref: src/types.c:108-113 with q=P)
            r = lb.select(lb.geq_const(r, Phalf_limbs),
                          lb.sub(r, jnp.broadcast_to(P_limbs, r.shape)), r)
        return r
    # fast truncated path (center=True only): the frac > 1/2 decision
    # absorbs the alpha floor off-by-one under the caller's magnitude
    # margin (see docstring)
    r = lb.from_digits16(s_digits, k_out)
    Plow = jnp.broadcast_to(P_limbs[:k_out], r.shape)
    frac = af - alpha
    return lb.select(frac > 0.5, lb.sub(r, Plow), r)


def reconstruct(res, ba: BasisArrays, plan: ReconPlan, center: bool = True,
                k_out: int | None = None,
                bound_bits: int | None = None,
                pre_scaled: bool = False) -> jnp.ndarray:
    """u64[..., dim, n] -> u32[..., n, ks] limbs mod 2^(32 ks).

    center=True: the exact centered integer (CRT lift then smod P,
    ref: src/poly.c:109-120 first smod), two's complement.
    center=False: the nonnegative residue in [0, P) (used by the key-switch
    divide-by-P path, which needs r = c mod P exactly).

    k_out (optional): compute the value mod 2^(32 k_out) only (truncated
    digit accumulation; the alpha floor off-by-one is absorbed by the f64
    frac decision).  Engages for center=True only: the caller must pass
    bound_bits — a proven bound |value| < 2^bound_bits — and the fast path
    runs only when the basis leaves >= 3 bits of margin (it always does for
    the dim_* formulas in context.py, which overshoot by most of one 59-bit
    prime).  center=False always takes the exact full-width path (its
    corrections need full-width compares; the key-switch call site uses the
    full ks width anyway)."""
    fast_ok = (k_out is not None and k_out <= plan.ks
               and center
               and bound_bits is not None
               and plan.logP - bound_bits >= 3)
    return reconstruct_core(
        res, ba.ps, ba.pinv, ba.phatinv_mont,
        jnp.asarray(phat_plane_table(plan)),
        jnp.asarray(plan.inv_p),
        jnp.asarray(plan.negP16),
        jnp.asarray(plan.MminusP_limbs), jnp.asarray(plan.P_limbs),
        jnp.asarray(plan.Phalf_limbs),
        ks=plan.ks, dim_total=plan.dim, center=center,
        k_out=k_out if fast_ok else None,
        pre_scaled=pre_scaled)
