"""Multi-chip parallelism: (limb[, coeff], batch) device meshes for the RNS
pipeline.

The reference exposes four natural parallel axes but implements none
(SURVEY.md §2: pthread code compiled out, ref: src/rns.c:79-216).  Here they
become jax.sharding mesh axes:

  limb  — the per-prime d-loop of every heavy op (ref: src/poly.c:94-102):
          decompose / NTT / pointwise / INTT are embarrassingly parallel per
          prime; only the CRT reconstruction needs a psum over this axis
          (digit partial sums — reconstruct_core(axis_name=...)).
  coeff — the polynomial-coefficient axis (the reference's n-loops,
          ref: src/ntt.c:42-51): the long-sequence analogue.  The NTT's
          first log2(S) stages pair whole shards (one ppermute block swap
          per stage); all remaining stages are shard-local.
  batch — independent ciphertexts (pure data parallelism).

Collectives: log2(S) ppermutes per NTT on 'coeff'; per CRT reconstruct on
'limb', one u32 psum of the 8-bit digit-column sums and one f32 psum of the
alpha estimate (ops/rns.py reconstruct_core).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from ..context import PolyContext
from ..ops import limbs as lb
from ..ops import rns as rns_ops
from ..ops.modmath import addmod, mont_mul, mulmod, submod
from ..ops.ntt import intt, ntt


def make_he_mesh(n_devices: int | None = None, limb: int | None = None) -> Mesh:
    """Create a (limb, batch) mesh over available devices."""
    devs = jax.devices()
    if n_devices is None:
        n_devices = len(devs)
    if limb is None:
        limb = n_devices
        batch = 1
        while limb > 4 and limb % 2 == 0:
            limb //= 2
            batch *= 2
    else:
        batch = n_devices // limb
    mesh_devs = np.array(devs[:n_devices]).reshape(limb, batch)
    return Mesh(mesh_devs, axis_names=("limb", "batch"))


def build_sharded_poly_mul(pctx: PolyContext, dim: int, k_in: int,
                           mask_to_bits: int, k_out: int, mesh: Mesh):
    """Jitted batched negacyclic product sharded over (limb, batch).

    Returns fn(a, b) for u32[B, n, k_in] inputs (B sharded over 'batch');
    the dim primes are sharded over 'limb'.  dim must divide by the limb
    axis size.
    """
    nlimb = mesh.shape["limb"]
    assert dim % nlimb == 0, (dim, nlimb)
    b = pctx.basis(dim)
    plan = rns_ops.make_recon_plan(pctx, dim)
    w = rns_ops.make_decomp_weights(pctx, dim, k_in)

    consts = dict(
        ps=jnp.array(b.ps), pinv=jnp.array(b.pinv_mont),
        ninv=jnp.array(b.ninv_mont), r2=jnp.array(b.r2),
        phinv=jnp.array(b.phatinv_mont),
        w=jnp.asarray(w),
        zetas=jnp.array(pctx.zetas(dim)), zetas_inv=jnp.array(pctx.zetas_inv(dim)),
        phat_shift=jnp.asarray(rns_ops.phat_plane_table(plan)),
        inv_p=jnp.asarray(plan.inv_p),
        negP16=jnp.asarray(plan.negP16),
        mmp=jnp.asarray(plan.MminusP_limbs), plimbs=jnp.asarray(plan.P_limbs),
        phalf=jnp.asarray(plan.Phalf_limbs),
    )
    const_specs = dict(
        ps=P("limb"), pinv=P("limb"), ninv=P("limb"), r2=P("limb"),
        phinv=P("limb"), w=P("limb", None),
        zetas=P("limb", None), zetas_inv=P("limb", None),
        phat_shift=P("limb", None, None),
        inv_p=P("limb"),
        negP16=P(), mmp=P(), plimbs=P(), phalf=P(),
    )

    def kernel(a, bb, ps, pinv, ninv, r2, phinv, w, zetas, zetas_inv,
               phat_shift, inv_p, negP16, mmp, plimbs, phalf):
        # local primes of this shard
        ra = ntt(rns_ops.decompose_core(a, ps, pinv, w), zetas, ps, pinv)
        rb = ntt(rns_ops.decompose_core(bb, ps, pinv, w), zetas, ps, pinv)
        ch = mulmod(ra, rb, ps[:, None], pinv[:, None], r2[:, None])
        res = intt(ch, zetas_inv, ps, pinv, ninv)
        c = rns_ops.reconstruct_core(
            res, ps, pinv, phinv, phat_shift, inv_p, negP16,
            mmp, plimbs, phalf, ks=plan.ks, dim_total=dim,
            center=True, axis_name="limb")
        return lb.fit_signed(c, mask_to_bits, k_out)

    smapped = shard_map(
        kernel, mesh=mesh,
        in_specs=(P("batch", None, None), P("batch", None, None),
                  *const_specs.values()),
        out_specs=P("batch", None, None),
        check_vma=False,
    )

    @jax.jit
    def f(a, bb):
        return smapped(a, bb, *consts.values())
    return f


def shard_ciphertext_batch(mesh: Mesh, arr):
    """Place a [B, n, K] batch with B sharded over 'batch', replicated on 'limb'."""
    return jax.device_put(arr, NamedSharding(mesh, P("batch", None, None)))


# ---------------------------------------------------------------------------
# coefficient-axis NTT sharding (the long-sequence analogue, SURVEY.md §5)
# ---------------------------------------------------------------------------

def make_coeff_ntt_plan(pctx: PolyContext, dim: int, S: int) -> dict:
    """Host precompute for the coefficient-sharded NTT over S shards.

    Shard s holds the contiguous coefficient block [s*L, (s+1)*L), L = n/S.
    Stages with butterfly length >= L pair whole shards (partner = s XOR
    length/L, since blocks are shard-aligned) and use ONE zeta per
    (prime, stage, shard); stages with length < L are local and run the
    unmodified ntt()/intt() kernels over per-shard repacked zeta tables
    laid out exactly like the global ones (zl[nb:2nb] = stage-nb zetas).
    Twiddle indexing follows the reference tables (ref: src/ntt.c:37-73,
    src/precomp.c:244-264).
    """
    n = pctx.n
    assert S & (S - 1) == 0 and S >= 1
    L = n // S
    assert L >= 2, "need at least one local butterfly stage per shard"
    z = np.asarray(pctx.zetas(dim))          # [dim, n]
    zi = np.asarray(pctx.zetas_inv(dim))
    logS = S.bit_length() - 1

    # local tables: zl[d, s, j], layout zl[..., nb:2nb] = shard-s stage zetas
    def local_tables(tab):
        out = np.zeros((dim, S, L), dtype=np.uint64)
        nb = 1
        while nb <= L // 2:
            for s in range(S):
                out[:, s, nb:2 * nb] = tab[:, S * nb + s * nb: S * nb + (s + 1) * nb]
            nb *= 2
        return out

    # cross-stage zetas: forward lengths n/2 ... L (descending),
    # inverse lengths L ... n/2 (ascending); block(s) = s*L // (2*length)
    def cross_tables(tab, lengths):
        out = np.zeros((dim, max(1, logS), S), dtype=np.uint64)
        for t, length in enumerate(lengths):
            nblocks = n // (2 * length)
            for s in range(S):
                out[:, t, s] = tab[:, nblocks + (s * L) // (2 * length)]
        return out

    f_lengths = [n >> (1 + t) for t in range(logS)]          # n/2 ... L
    i_lengths = f_lengths[::-1]                              # L ... n/2
    return dict(
        S=S, L=L, logS=logS,
        f_lengths=f_lengths, i_lengths=i_lengths,
        zl_f=local_tables(z), zl_i=local_tables(zi),
        zc_f=cross_tables(z, f_lengths), zc_i=cross_tables(zi, i_lengths),
    )


def _ntt_coeff_sharded(x, zl, zc, ps, pinv, plan, axis: str):
    """Forward NTT on a local [dim, L] coefficient block under shard_map.
    Cross stages first (one ppermute block swap each), then local stages."""
    S = plan["S"]
    p = ps[:, None]
    pv = pinv[:, None]
    s_idx = jax.lax.axis_index(axis)
    for t, length in enumerate(plan["f_lengths"]):
        d = length // plan["L"]
        recv = jax.lax.ppermute(x, axis, [(i, i ^ d) for i in range(S)])
        lower = (s_idx & d) == 0
        zt = zc[:, t, 0][:, None]
        tmul = mont_mul(jnp.where(lower, recv, x), zt, p, pv)
        x = jnp.where(lower, addmod(x, tmul, p), submod(recv, tmul, p))
    return ntt(x, zl[:, 0], ps, pinv)


def _intt_coeff_sharded(x, zl, zc, ps, pinv, ninv, plan, axis: str):
    """Inverse NTT on a local [dim, L] block: local GS stages (with the
    global n^-1 scale — a scalar multiply commutes with later butterflies),
    then cross stages ascending."""
    S = plan["S"]
    p = ps[:, None]
    pv = pinv[:, None]
    x = intt(x, zl[:, 0], ps, pinv, ninv)
    s_idx = jax.lax.axis_index(axis)
    for t, length in enumerate(plan["i_lengths"]):
        d = length // plan["L"]
        recv = jax.lax.ppermute(x, axis, [(i, i ^ d) for i in range(S)])
        lower = (s_idx & d) == 0
        zt = zc[:, t, 0][:, None]
        y_add = addmod(x, recv, p)
        y_sub = mont_mul(submod(recv, x, p), zt, p, pv)
        x = jnp.where(lower, y_add, y_sub)
    return x


def make_he_mesh3(n_devices: int | None = None, limb: int = 1,
                  coeff: int = 1, devices=None) -> Mesh:
    """Create a (limb, coeff, batch) mesh.

    devices: explicit GLOBAL device list (defaults to jax.devices(), which
    under a jax.distributed multi-process setup already enumerates every
    process's devices — so one mesh can span processes/hosts; collectives
    then ride the cross-process fabric, the DCN analogue).  Process-local
    devices come first per process index, so a (limb, coeff, batch) reshape
    puts the limb axis across processes when limb is the slowest axis."""
    devs = list(devices) if devices is not None else jax.devices()
    if n_devices is None:
        n_devices = len(devs)
    batch = n_devices // (limb * coeff)
    assert limb * coeff * batch == n_devices, (n_devices, limb, coeff)
    mesh_devs = np.array(devs[:n_devices]).reshape(limb, coeff, batch)
    return Mesh(mesh_devs, axis_names=("limb", "coeff", "batch"))


def _pad_dim(dim: int, nlimb: int, dimub: int) -> int:
    """Round a basis size up to a multiple of the limb-axis size (extra chain
    primes only enlarge the CRT range — exactness is preserved)."""
    p = ((dim + nlimb - 1) // nlimb) * nlimb
    assert p <= dimub, (dim, nlimb, dimub)
    return p


def _recon_consts(pctx: PolyContext, dim_basis: int, dim_padded: int,
                  prefix: str):
    """(consts, specs) for a limb-sharded reconstruct_core over the first
    dim_basis primes of a dim_padded-prime residue stack.  When dim_basis <
    dim_padded (sub-basis reconstruction, e.g. r = c mod P in the key-switch
    divide-round), the out-of-basis primes get phatinv = 0 so their digit and
    alpha contributions vanish under the limb psum."""
    plan = rns_ops.make_recon_plan(pctx, dim_basis)
    b = pctx.basis(dim_basis)
    phinv = np.zeros(dim_padded, dtype=np.uint64)
    phinv[:dim_basis] = b.phatinv_mont
    planes = rns_ops.phat_plane_table(plan)          # [dim_basis, 8, 2*ds]
    planes_p = np.zeros((dim_padded,) + planes.shape[1:], dtype=np.float32)
    planes_p[:dim_basis] = planes
    inv_p = np.zeros(dim_padded, dtype=np.float64)
    inv_p[:dim_basis] = plan.inv_p
    consts = {
        f"{prefix}_phinv": jnp.asarray(phinv),
        f"{prefix}_shift": jnp.asarray(planes_p),
        f"{prefix}_invp": jnp.asarray(inv_p),
        f"{prefix}_negP16": jnp.asarray(plan.negP16),
        f"{prefix}_mmp": jnp.asarray(plan.MminusP_limbs),
        f"{prefix}_plimbs": jnp.asarray(plan.P_limbs),
        f"{prefix}_phalf": jnp.asarray(plan.Phalf_limbs),
    }
    specs = {
        f"{prefix}_phinv": P("limb"),
        f"{prefix}_shift": P("limb", None, None),
        f"{prefix}_invp": P("limb"),
        f"{prefix}_negP16": P(),
        f"{prefix}_mmp": P(), f"{prefix}_plimbs": P(), f"{prefix}_phalf": P(),
    }
    return plan, consts, specs


def _basis_consts(pctx: PolyContext, dim: int, k_in: int, S: int, prefix: str):
    """(static plan, consts, specs) for a limb+coeff-sharded NTT basis."""
    b = pctx.basis(dim)
    cp = make_coeff_ntt_plan(pctx, dim, S)
    splan = dict(S=S, L=cp["L"], logS=cp["logS"],
                 f_lengths=cp["f_lengths"], i_lengths=cp["i_lengths"])
    consts = {
        f"{prefix}_ps": jnp.array(b.ps),
        f"{prefix}_pinv": jnp.array(b.pinv_mont),
        f"{prefix}_ninv": jnp.array(b.ninv_mont),
        f"{prefix}_r2": jnp.array(b.r2),
        f"{prefix}_w": jnp.asarray(rns_ops.make_decomp_weights(pctx, dim, k_in)),
        f"{prefix}_zlf": jnp.asarray(cp["zl_f"]),
        f"{prefix}_zli": jnp.asarray(cp["zl_i"]),
        f"{prefix}_zcf": jnp.asarray(cp["zc_f"]),
        f"{prefix}_zci": jnp.asarray(cp["zc_i"]),
    }
    specs = {
        f"{prefix}_ps": P("limb"), f"{prefix}_pinv": P("limb"),
        f"{prefix}_ninv": P("limb"), f"{prefix}_r2": P("limb"),
        f"{prefix}_w": P("limb", None),
        f"{prefix}_zlf": P("limb", "coeff", None),
        f"{prefix}_zli": P("limb", "coeff", None),
        f"{prefix}_zcf": P("limb", None, "coeff"),
        f"{prefix}_zci": P("limb", None, "coeff"),
    }
    return splan, consts, specs


def _ks_post_factory(eng, l: int, dim_s: int, plan_sr, plan_8r):
    """Shared sharded divide-round-by-P pipeline: NTT-domain product stack
    res (one key-switch half, local primes) -> u = rdiv(c, P) mod q_l limbs.
    Mirrors CKKS._keyswitch_core's post() (ref: src/he-mult.c:67-77,
    he-automorphism.c:62-77): full-basis centered reconstruct + sub-basis
    r = c mod P (zero-masked out-of-basis primes under the limb psum),
    then (c - r) * P^-1 mod 2^(32 kq) + round bit."""
    ctx = eng.ctx
    qb, klv, kq = eng.qbits(l), eng.kl(l), eng.kq
    pinv16 = eng.pinv16
    p_half_up = jnp.asarray(eng.p_half_up)
    rk8 = eng.rk8

    def ks_post(res, C):
        c = rns_ops.reconstruct_core(
            res, C["s_ps"], C["s_pinv"], C["sr_phinv"], C["sr_shift"],
            C["sr_invp"], C["sr_negP16"], C["sr_mmp"], C["sr_plimbs"],
            C["sr_phalf"], ks=plan_sr.ks, dim_total=dim_s,
            center=True, axis_name="limb")
        r = rns_ops.reconstruct_core(
            res, C["s_ps"], C["s_pinv"], C["r8_phinv"], C["r8_shift"],
            C["r8_invp"], C["r8_negP16"], C["r8_mmp"], C["r8_plimbs"],
            C["r8_phalf"], ks=plan_8r.ks, dim_total=ctx.dim,
            center=False, axis_name="limb")
        u = lb.mul_const_mod2k(lb.sub(lb.resize(c, kq), lb.resize(r, kq)),
                               pinv16, kq)
        round_bit = lb.geq_const(lb.resize(r, rk8), p_half_up)
        u = lb.add_scalar_bit(u, round_bit.astype(jnp.uint32))
        return lb.resize(lb.mask_bits(u, qb), klv)
    return ks_post


def build_sharded_rot(eng, l: int, mesh: Mesh, rot: int | None):
    """Slot rotation / conjugation (rot=None) sharded over the full
    (limb, coeff, batch) mesh — the key-switch path of
    CKKS.rot/conj/_apply_swk (ref: src/he-automorphism.c:40-115).

    The Galois permutation is a global coefficient gather (it crosses coeff
    shards), so it runs OUTSIDE shard_map on the jit-level global view (XLA
    inserts the resharding collectives); the key-switch pipeline itself —
    decompose + coeff-sharded NTT of d1, x swk halves (swk sharded over
    (limb, coeff)), INTT, the two limb-psum reconstructs and the
    divide-round — runs under shard_map exactly like the relin block of
    build_sharded_mul_rs.

    Returns fn(c0, c1, swk0, swk1) -> (c0', c1') for u32[B, n, klv] inputs
    (B over 'batch', n over 'coeff'); swk halves are the engine's
    NTT-resident u64[>=dim_s, n].  Bit-exact vs the single-device engine op
    (tests/test_parallel.py)."""
    ctx = eng.ctx
    pctx = ctx.poly
    nlimb, S = mesh.shape["limb"], mesh.shape["coeff"]
    qb, klv = eng.qbits(l), eng.kl(l)
    dim_s = _pad_dim(ctx.dim_swk(l), nlimb, pctx.dimub)
    assert dim_s <= eng.dimswk_h, (dim_s, eng.dimswk_h)

    splan_s, cs, ss = _basis_consts(pctx, dim_s, klv, S, "s")
    plan_sr, csr, ssr = _recon_consts(pctx, dim_s, dim_s, "sr")
    plan_8r, c8r, s8r = _recon_consts(pctx, ctx.dim, dim_s, "r8")
    consts = {**cs, **csr, **c8r}
    specs = {**ss, **ssr, **s8r}
    ks_post = _ks_post_factory(eng, l, dim_s, plan_sr, plan_8r)

    src, negf = eng.ring.galois_map(rot)
    srcj = jnp.asarray(src)
    negj = jnp.asarray(negf)

    def kernel(d0, d1, ek0, ek1, C):
        res = rns_ops.decompose_core(d1, C["s_ps"], C["s_pinv"], C["s_w"])
        dhat = _ntt_coeff_sharded(res, C["s_zlf"], C["s_zcf"],
                                  C["s_ps"], C["s_pinv"], splan_s, "coeff")
        pss, pinvs = C["s_ps"][:, None], C["s_pinv"][:, None]
        r2s = C["s_r2"][:, None]
        u0h = mulmod(dhat, ek0, pss, pinvs, r2s)
        u1h = mulmod(dhat, ek1, pss, pinvs, r2s)

        def back(uh):
            return _intt_coeff_sharded(uh, C["s_zli"], C["s_zci"],
                                       C["s_ps"], C["s_pinv"], C["s_ninv"],
                                       splan_s, "coeff")
        u0 = ks_post(back(u0h), C)
        u1 = ks_post(back(u1h), C)
        c0 = lb.mask_bits(lb.add(u0, d0), qb)
        return c0, u1

    cnames = list(consts.keys())

    def vkernel(d0, d1, ek0, ek1, *cs_):
        C = dict(zip(cnames, cs_))
        return jax.vmap(lambda x, y: kernel(x, y, ek0, ek1, C))(d0, d1)

    smapped = shard_map(
        vkernel, mesh=mesh,
        in_specs=(P("batch", "coeff", None),) * 2
        + (P("limb", "coeff"), P("limb", "coeff"))
        + tuple(specs[k] for k in cnames),
        out_specs=(P("batch", "coeff", None), P("batch", "coeff", None)),
        check_vma=False,
    )

    @jax.jit
    def f(c0, c1, ek0, ek1):
        # Galois on the global view (gathers cross coeff shards)
        def gal(x):
            g = x[:, srcj, :]
            neg = lb.mask_bits(lb.neg(g), qb)
            pos = lb.mask_bits(g, qb)
            return jnp.where(negj[None, :, None], neg, pos)
        return smapped(gal(c0), gal(c1), ek0[:dim_s], ek1[:dim_s],
                       *consts.values())
    return f


def build_sharded_gemv_step(eng, l: int, n1: int, dims_h: int, dimc: int,
                            mesh: Mesh):
    """One double-hoisted BSGS gemv giant step sharded over (limb, coeff)
    — the lax.scan body of CKKS.hoisted_gemv_step_fn (pointwise per prime,
    so the scan runs UNCHANGED on local shards; only the key-switch
    divide-round needs the limb psum) plus the sharded key-switch epilogue.
    The rotation-key slab rk0/rk1 [n1, dims_h, n] — the largest object in
    the system at production scale (ref: src/he-kem.c:154-169) — shards
    over (limb, coeff) like the evk.

    dims_h and dimc must be multiples of the limb axis (pad with extra
    chain primes — any dims >= the engine's formulas are valid CRT ranges).

    f(c1p [n1,dims_h,n], c0p [n1,dimc,n], ptx_i, ptb_i, rk0, rk1)
      -> (c0_i, c1_i) [n, klv], bit-exact vs the engine step
    (tests/test_parallel.py)."""
    ctx = eng.ctx
    pctx = ctx.poly
    nlimb, S = mesh.shape["limb"], mesh.shape["coeff"]
    qb, klv = eng.qbits(l), eng.kl(l)
    assert dims_h % nlimb == 0 and dimc % nlimb == 0, (dims_h, dimc, nlimb)
    assert dims_h <= eng.dimswk_h, (dims_h, eng.dimswk_h)

    splan_s, cs, ss = _basis_consts(pctx, dims_h, klv, S, "s")
    splan_c, cc, sc = _basis_consts(pctx, dimc, klv, S, "c")
    plan_sr, csr, ssr = _recon_consts(pctx, dims_h, dims_h, "sr")
    plan_8r, c8r, s8r = _recon_consts(pctx, ctx.dim, dims_h, "r8")
    plan_cr, ccr, scr = _recon_consts(pctx, dimc, dimc, "cr")
    consts = {**cs, **cc, **csr, **c8r, **ccr}
    specs = {**ss, **sc, **ssr, **s8r, **scr}
    ks_post = _ks_post_factory(eng, l, dims_h, plan_sr, plan_8r)

    def kernel(c1p, c0p, ptx, ptb, r0, r1, C):
        pss, pinvs = C["s_ps"][:, None], C["s_pinv"][:, None]
        pcc, pinvc = C["c_ps"][:, None], C["c_pinv"][:, None]
        r2s, r2c = C["s_r2"][:, None], C["c_r2"][:, None]
        nloc = c1p.shape[-1]

        def body(carry, xs):
            acc0, acc1, accb = carry
            c1j, c0j, px, pb, rr0, rr1 = xs
            t = mulmod(c1j, px, pss, pinvs, r2s)
            u0 = mulmod(t, rr0, pss, pinvs, r2s)
            u1 = mulmod(t, rr1, pss, pinvs, r2s)
            b = mulmod(c0j, pb, pcc, pinvc, r2c)
            return (addmod(acc0, u0, pss), addmod(acc1, u1, pss),
                    addmod(accb, b, pcc)), None
        init = (jnp.zeros((dims_h // nlimb, nloc), dtype=jnp.uint64),
                jnp.zeros((dims_h // nlimb, nloc), dtype=jnp.uint64),
                jnp.zeros((dimc // nlimb, nloc), dtype=jnp.uint64))
        (acc0, acc1, accb), _ = jax.lax.scan(
            body, init, (c1p, c0p, ptx, ptb, r0, r1))

        def back_s(uh):
            return _intt_coeff_sharded(uh, C["s_zli"], C["s_zci"],
                                       C["s_ps"], C["s_pinv"], C["s_ninv"],
                                       splan_s, "coeff")
        k0 = ks_post(back_s(acc0), C)
        k1 = ks_post(back_s(acc1), C)
        resb = _intt_coeff_sharded(accb, C["c_zli"], C["c_zci"],
                                   C["c_ps"], C["c_pinv"], C["c_ninv"],
                                   splan_c, "coeff")
        db = rns_ops.reconstruct_core(
            resb, C["c_ps"], C["c_pinv"], C["cr_phinv"], C["cr_shift"],
            C["cr_invp"], C["cr_negP16"], C["cr_mmp"], C["cr_plimbs"],
            C["cr_phalf"], ks=plan_cr.ks, dim_total=dimc,
            center=True, axis_name="limb")
        db = lb.resize(lb.mask_bits(db, qb), klv)
        return lb.mask_bits(lb.add(k0, db), qb), k1

    cnames = list(consts.keys())

    def vkernel(c1p, c0p, ptx, ptb, r0, r1, *cs_):
        C = dict(zip(cnames, cs_))
        return kernel(c1p, c0p, ptx, ptb, r0, r1, C)

    smapped = shard_map(
        vkernel, mesh=mesh,
        in_specs=(P(None, "limb", "coeff"),) * 6
        + tuple(specs[k] for k in cnames),
        out_specs=(P("coeff", None), P("coeff", None)),
        check_vma=False,
    )

    @jax.jit
    def f(c1p, c0p, ptx_i, ptb_i, rk0, rk1):
        return smapped(c1p, c0p, ptx_i, ptb_i,
                       rk0[:, :dims_h], rk1[:, :dims_h], *consts.values())
    return f


def build_sharded_mul_rs(eng, l: int, mesh: Mesh):
    """The north-star scheme op — fused ciphertext multiply + relinearize +
    rescale (engine mul_rs) — sharded over the full (limb, coeff, batch) mesh.

    Mirrors CKKS.mul_step_fn exactly (ref: src/he-mult.c:88-156 pipeline):
      - cross terms d0/d1/d2 over the dim_mul basis: decompose + NTT local
        per limb shard (the reference's d-loop, ref: src/he-mult.c:116-138),
        coeff-axis ppermute block swaps inside each NTT, one limb-axis psum
        per CRT reconstruct;
      - relinearization over the dim_swk basis with the evk sharded
        (limb = prime axis, coeff = NTT position axis);
      - divide-round by P via the small-CRT remainder (a SECOND, sub-basis
        psum with zero-masked out-of-basis primes), then the rescale
        shift+round — all coefficient-local.

    Returns fn(c10, c11, c20, c21) -> (c0, c1) for [B, n, klv] u32 inputs
    (B over 'batch', n over 'coeff'), plus the evk is closed over (sliced
    and device_put with the right sharding once at build time).

    Bit-exact vs the single-device engine program (tests/test_parallel.py).
    """
    ctx = eng.ctx
    pctx = ctx.poly
    nlimb, S = mesh.shape["limb"], mesh.shape["coeff"]
    qb, klv = eng.qbits(l), eng.kl(l)
    qbn, kln = eng.qbits(l - 1), eng.kl(l - 1)
    logD = ctx.p.bit_length() - 1
    kq = eng.kq
    dim_m = _pad_dim(ctx.dim_mul(l), nlimb, pctx.dimub)
    dim_s = _pad_dim(ctx.dim_swk(l), nlimb, pctx.dimub)
    assert dim_s <= eng.dimswk_h, \
        (f"padded relin basis {dim_s} exceeds switch-key limbs "
         f"{eng.dimswk_h}; raise hoist_bits at engine construction")

    splan_m, cm, sm = _basis_consts(pctx, dim_m, klv, S, "m")
    splan_s, cs, ss = _basis_consts(pctx, dim_s, klv, S, "s")
    plan_mr, cmr, smr = _recon_consts(pctx, dim_m, dim_m, "mr")
    plan_sr, csr, ssr = _recon_consts(pctx, dim_s, dim_s, "sr")
    plan_8r, c8r, s8r = _recon_consts(pctx, ctx.dim, dim_s, "r8")
    ks_post_f = _ks_post_factory(eng, l, dim_s, plan_sr, plan_8r)

    consts = {**cm, **cs, **cmr, **csr, **c8r}
    specs = {**sm, **ss, **smr, **ssr, **s8r}

    def kernel(c10, c11, c20, c21, ek0, ek1, C):
        psm, pinvm = C["m_ps"][:, None], C["m_pinv"][:, None]
        pss, pinvs = C["s_ps"][:, None], C["s_pinv"][:, None]

        def fwd_m(x):
            res = rns_ops.decompose_core(x, C["m_ps"], C["m_pinv"], C["m_w"])
            return _ntt_coeff_sharded(res, C["m_zlf"], C["m_zcf"],
                                      C["m_ps"], C["m_pinv"], splan_m, "coeff")
        x0, x1, y0, y1 = fwd_m(c10), fwd_m(c11), fwd_m(c20), fwd_m(c21)
        r2m = C["m_r2"][:, None]
        d0h = mulmod(x0, y0, psm, pinvm, r2m)
        d2h = mulmod(x1, y1, psm, pinvm, r2m)
        d1h = addmod(mulmod(x0, y1, psm, pinvm, r2m),
                     mulmod(x1, y0, psm, pinvm, r2m), psm)

        def back_m(dh):
            res = _intt_coeff_sharded(dh, C["m_zli"], C["m_zci"],
                                      C["m_ps"], C["m_pinv"], C["m_ninv"],
                                      splan_m, "coeff")
            c = rns_ops.reconstruct_core(
                res, C["m_ps"], C["m_pinv"], C["mr_phinv"], C["mr_shift"],
                C["mr_invp"], C["mr_negP16"], C["mr_mmp"], C["mr_plimbs"],
                C["mr_phalf"], ks=plan_mr.ks, dim_total=dim_m,
                center=True, axis_name="limb")
            return lb.resize(lb.mask_bits(c, qb), klv)
        d0, d1, d2 = back_m(d0h), back_m(d1h), back_m(d2h)

        # relinearize d2 over the padded dim_swk basis
        res2 = rns_ops.decompose_core(d2, C["s_ps"], C["s_pinv"], C["s_w"])
        d2hat = _ntt_coeff_sharded(res2, C["s_zlf"], C["s_zcf"],
                                   C["s_ps"], C["s_pinv"], splan_s, "coeff")
        r2s = C["s_r2"][:, None]
        u0h = mulmod(d2hat, ek0, pss, pinvs, r2s)
        u1h = mulmod(d2hat, ek1, pss, pinvs, r2s)

        def ks_post(uh):
            res = _intt_coeff_sharded(uh, C["s_zli"], C["s_zci"],
                                      C["s_ps"], C["s_pinv"], C["s_ninv"],
                                      splan_s, "coeff")
            return ks_post_f(res, C)
        u0, u1 = ks_post(u0h), ks_post(u1h)
        c0 = lb.mask_bits(lb.add(u0, d0), qb)
        c1 = lb.mask_bits(lb.add(u1, d1), qb)

        def rs1(x):
            return lb.resize(lb.mask_bits(lb.rshift_round(x, logD), qbn), kln)
        return rs1(c0), rs1(c1)

    cnames = list(consts.keys())

    def vkernel(a0, a1, b0, b1, ek0, ek1, *cs):
        C = dict(zip(cnames, cs))
        return jax.vmap(lambda w, x, y, z: kernel(w, x, y, z, ek0, ek1, C))(
            a0, a1, b0, b1)

    smapped = shard_map(
        vkernel, mesh=mesh,
        in_specs=(P("batch", "coeff", None),) * 4
        + (P("limb", "coeff"), P("limb", "coeff"))
        + tuple(specs[k] for k in cnames),
        out_specs=(P("batch", "coeff", None), P("batch", "coeff", None)),
        check_vma=False,
    )

    @jax.jit
    def f(c10, c11, c20, c21, ek0, ek1):
        return smapped(c10, c11, c20, c21, ek0[:dim_s], ek1[:dim_s],
                       *consts.values())
    return f


def build_sharded_poly_mul_3d(pctx: PolyContext, dim: int, k_in: int,
                              mask_to_bits: int, k_out: int, mesh: Mesh):
    """Negacyclic product sharded over the full (limb, coeff, batch) mesh.

    fn(a, b) for u32[B, n, k_in] inputs; B shards over 'batch', the n
    coefficients over 'coeff', the dim primes over 'limb'.  Per NTT the
    'coeff' axis exchanges log2(S) ppermuted blocks; the CRT lift psums
    digit partials over 'limb'; everything else is local.
    """
    nlimb = mesh.shape["limb"]
    S = mesh.shape["coeff"]
    assert dim % nlimb == 0, (dim, nlimb)
    b = pctx.basis(dim)
    plan = rns_ops.make_recon_plan(pctx, dim)
    w = rns_ops.make_decomp_weights(pctx, dim, k_in)
    cp = make_coeff_ntt_plan(pctx, dim, S)
    splan = dict(S=S, L=cp["L"], logS=cp["logS"],
                 f_lengths=cp["f_lengths"], i_lengths=cp["i_lengths"])

    consts = dict(
        ps=jnp.array(b.ps), pinv=jnp.array(b.pinv_mont),
        ninv=jnp.array(b.ninv_mont), r2=jnp.array(b.r2),
        phinv=jnp.array(b.phatinv_mont),
        w=jnp.asarray(w),
        zl_f=jnp.asarray(cp["zl_f"]), zl_i=jnp.asarray(cp["zl_i"]),
        zc_f=jnp.asarray(cp["zc_f"]), zc_i=jnp.asarray(cp["zc_i"]),
        phat_shift=jnp.asarray(rns_ops.phat_plane_table(plan)),
        inv_p=jnp.asarray(plan.inv_p),
        negP16=jnp.asarray(plan.negP16),
        mmp=jnp.asarray(plan.MminusP_limbs), plimbs=jnp.asarray(plan.P_limbs),
        phalf=jnp.asarray(plan.Phalf_limbs),
    )
    const_specs = dict(
        ps=P("limb"), pinv=P("limb"), ninv=P("limb"), r2=P("limb"),
        phinv=P("limb"), w=P("limb", None),
        zl_f=P("limb", "coeff", None), zl_i=P("limb", "coeff", None),
        zc_f=P("limb", None, "coeff"), zc_i=P("limb", None, "coeff"),
        phat_shift=P("limb", None, None),
        inv_p=P("limb"),
        negP16=P(), mmp=P(), plimbs=P(), phalf=P(),
    )

    def kernel(a, bb, ps, pinv, ninv, r2, phinv, w, zl_f, zl_i, zc_f, zc_i,
               phat_shift, inv_p, negP16, mmp, plimbs, phalf):
        def fwd(x):
            res = rns_ops.decompose_core(x, ps, pinv, w)
            return _ntt_coeff_sharded(res, zl_f, zc_f, ps, pinv, splan, "coeff")
        ra, rb = fwd(a), fwd(bb)
        ch = mulmod(ra, rb, ps[:, None], pinv[:, None], r2[:, None])
        res = _intt_coeff_sharded(ch, zl_i, zc_i, ps, pinv, ninv, splan, "coeff")
        c = rns_ops.reconstruct_core(
            res, ps, pinv, phinv, phat_shift, inv_p, negP16,
            mmp, plimbs, phalf, ks=plan.ks, dim_total=dim,
            center=True, axis_name="limb")
        return lb.fit_signed(c, mask_to_bits, k_out)

    def vkernel(a, bb, *cs):
        # batch loop stays on-device: map the per-ciphertext kernel
        return jax.vmap(lambda x, y: kernel(x, y, *cs))(a, bb)

    smapped = shard_map(
        vkernel, mesh=mesh,
        in_specs=(P("batch", "coeff", None), P("batch", "coeff", None),
                  *const_specs.values()),
        out_specs=P("batch", "coeff", None),
        check_vma=False,
    )

    @jax.jit
    def f(a, bb):
        return smapped(a, bb, *consts.values())
    return f
