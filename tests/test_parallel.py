"""Multi-device tests on the virtual 8-device CPU mesh.

The sharded (limb, batch) poly_mul must agree bit-for-bit with the
single-device path (the multi-node analogue of the reference's determinism
requirement, SURVEY.md §4)."""

import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gpqhe_jax.context import PolyContext
from gpqhe_jax.parallel.mesh import build_sharded_poly_mul, make_he_mesh
from gpqhe_jax.ring.poly import RingEngine
from gpqhe_jax.substrate import bigint


@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 virtual devices")
def test_sharded_poly_mul_matches_single():
    random.seed(7)
    logn, dim, K = 6, 4, 4
    n = 1 << logn
    pctx = PolyContext(logn, q=1 << 100, dim_cap=dim)
    mesh = make_he_mesh(8, limb=4)  # (limb=4, batch=2)
    B = 4
    mask_bits = 32 * K
    f = build_sharded_poly_mul(pctx, dim, K, mask_bits, K, mesh)
    a_ints = [[random.getrandbits(100) for _ in range(n)] for _ in range(B)]
    b_ints = [[random.getrandbits(100) for _ in range(n)] for _ in range(B)]
    a = jnp.asarray(np.stack([bigint.ints_to_limbs(x, K) for x in a_ints]))
    b = jnp.asarray(np.stack([bigint.ints_to_limbs(x, K) for x in b_ints]))
    got = np.asarray(f(a, b))
    ring = RingEngine(pctx)
    for i in range(B):
        single = np.asarray(ring.poly_mul(a[i], b[i], dim, mask_bits, K))
        assert np.array_equal(got[i], single), f"batch element {i} differs"


def test_mesh_shapes():
    mesh = make_he_mesh(8)
    assert mesh.shape["limb"] * mesh.shape["batch"] == 8


@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 virtual devices")
def test_sharded_poly_mul_3d_matches_single():
    """Full (limb=2, coeff=2, batch=2) mesh: the coefficient-sharded NTT
    (ppermute cross stages + local stages) must reproduce the single-device
    product bit-for-bit."""
    from gpqhe_jax.parallel.mesh import build_sharded_poly_mul_3d, make_he_mesh3

    random.seed(11)
    logn, dim, K = 6, 4, 4
    n = 1 << logn
    pctx = PolyContext(logn, q=1 << 100, dim_cap=dim)
    mesh = make_he_mesh3(8, limb=2, coeff=2)  # batch=2
    B = 4
    mask_bits = 32 * K
    f = build_sharded_poly_mul_3d(pctx, dim, K, mask_bits, K, mesh)
    a_ints = [[random.getrandbits(100) for _ in range(n)] for _ in range(B)]
    b_ints = [[random.getrandbits(100) for _ in range(n)] for _ in range(B)]
    a = jnp.asarray(np.stack([bigint.ints_to_limbs(x, K) for x in a_ints]))
    b = jnp.asarray(np.stack([bigint.ints_to_limbs(x, K) for x in b_ints]))
    got = np.asarray(f(a, b))
    ring = RingEngine(pctx)
    for i in range(B):
        single = np.asarray(ring.poly_mul(a[i], b[i], dim, mask_bits, K))
        assert np.array_equal(got[i], single), f"batch element {i} differs"


def _run_sharded_mul_rs(logn: int, logq: int) -> None:
    """Sharded fused multiply+relin+rescale == single-device engine program,
    bit for bit, on the full (limb=2, coeff=2, batch=2) mesh."""
    from gpqhe_jax.context import HeContext
    from gpqhe_jax.parallel.mesh import build_sharded_mul_rs, make_he_mesh3
    from gpqhe_jax.ring import sample as smp
    from gpqhe_jax.scheme.engine import CKKS
    from gpqhe_jax.substrate.surf import Surf

    ctx = HeContext(logn=logn, q=1 << logq, slots=4, Delta=1 << 30)
    eng = CKKS(ctx, rng=Surf())
    pk, sk = eng.keypair()
    rlk = eng.genrlk(sk)
    m0 = smp.sample_z01vec(eng.rng, ctx.slots)
    m1 = smp.sample_z01vec(eng.rng, ctx.slots)
    ct1 = eng.enc_pk(eng.ecd(m0), pk)
    ct2 = eng.enc_pk(eng.ecd(m1), pk)
    ref = eng.mul_rs(ct1, ct2, rlk)
    mesh = make_he_mesh3(8, limb=2, coeff=2)
    f = build_sharded_mul_rs(eng, ctx.L, mesh)
    B = 2

    def bat(x):
        return jnp.broadcast_to(x[None], (B,) + x.shape)
    c0, c1 = f(bat(ct1.c0), bat(ct1.c1), bat(ct2.c0), bat(ct2.c1),
               rlk.p0hat, rlk.p1hat)
    ref0, ref1 = np.asarray(ref.c0), np.asarray(ref.c1)
    for i in range(B):
        assert np.array_equal(np.asarray(c0[i]), ref0), f"c0[{i}] differs"
        assert np.array_equal(np.asarray(c1[i]), ref1), f"c1[{i}] differs"
    # sanity: the sharded result decodes correctly too
    from gpqhe_jax.scheme.types import Ciphertext
    out = Ciphertext(l=ref.l, nu=ref.nu, B=ref.B, c0=c0[0], c1=c1[0])
    got = eng.dcd(eng.dec(out, sk))
    assert np.max(np.abs(got - m0 * m1)) < 1e-5


@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 virtual devices")
def test_sharded_mul_rs_matches_engine():
    _run_sharded_mul_rs(logn=6, logq=110)


@pytest.mark.slow
@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 virtual devices")
def test_sharded_mul_rs_matches_engine_logn12():
    """Real ladder dims at logn=12 (security-table logq=109)."""
    _run_sharded_mul_rs(logn=12, logq=109)


@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 virtual devices")
def test_coeff_sharded_ntt_roundtrip_deep():
    """8-way coefficient sharding (3 ppermute stages) of the bare NTT:
    forward matches the single-device NTT bit-for-bit, and fwd->inv is the
    identity."""
    from functools import partial

    from jax.sharding import Mesh, PartitionSpec as P
    from jax import shard_map

    from gpqhe_jax.ops import rns as rns_ops
    from gpqhe_jax.ops.ntt import ntt
    from gpqhe_jax.parallel.mesh import (
        _intt_coeff_sharded, _ntt_coeff_sharded, make_coeff_ntt_plan)

    logn, dim, S = 8, 2, 8
    n = 1 << logn
    pctx = PolyContext(logn, q=1 << 100, dim_cap=dim)
    ba = rns_ops.make_basis_arrays(pctx, dim)
    cp = make_coeff_ntt_plan(pctx, dim, S)
    splan = dict(S=S, L=cp["L"], logS=cp["logS"],
                 f_lengths=cp["f_lengths"], i_lengths=cp["i_lengths"])
    mesh = Mesh(np.array(jax.devices()[:S]), axis_names=("coeff",))

    def fwd_k(x, zl, zc):
        return _ntt_coeff_sharded(x, zl, zc, jnp.asarray(ba.ps),
                                  jnp.asarray(ba.pinv), splan, "coeff")

    def inv_k(x, zl, zc):
        return _intt_coeff_sharded(x, zl, zc, jnp.asarray(ba.ps),
                                   jnp.asarray(ba.pinv),
                                   jnp.asarray(ba.ninv_mont), splan, "coeff")

    specs = dict(
        in_specs=(P(None, "coeff"), P(None, "coeff", None),
                  P(None, None, "coeff")),
        out_specs=P(None, "coeff"))
    fwd = jax.jit(shard_map(fwd_k, mesh=mesh, check_vma=False, **specs))
    inv = jax.jit(shard_map(inv_k, mesh=mesh, check_vma=False, **specs))

    rng = np.random.default_rng(3)
    a = jnp.asarray(np.stack([rng.integers(0, p, n, dtype=np.uint64)
                              for p in pctx.primes[:dim]]))
    ref = ntt(a, ba.zetas, ba.ps, ba.pinv)
    got = fwd(a, jnp.asarray(cp["zl_f"]), jnp.asarray(cp["zc_f"]))
    assert jnp.array_equal(ref, got)
    back = inv(got, jnp.asarray(cp["zl_i"]), jnp.asarray(cp["zc_i"]))
    assert jnp.array_equal(a, back)


@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 virtual devices")
def test_sharded_rot_conj_matches_engine():
    """Sharded key-switch path (rot + conj) == single-device engine ops,
    bit for bit, on the full (limb=2, coeff=2, batch=2) mesh — the swk
    halves shard over (limb, coeff) like the evk (VERDICT r2 #5)."""
    from gpqhe_jax.context import HeContext
    from gpqhe_jax.parallel.mesh import build_sharded_rot, make_he_mesh3
    from gpqhe_jax.ring import sample as smp
    from gpqhe_jax.scheme.engine import CKKS
    from gpqhe_jax.scheme.types import Ciphertext
    from gpqhe_jax.substrate.surf import Surf

    ctx = HeContext(logn=6, q=1 << 110, slots=4, Delta=1 << 30)
    eng = CKKS(ctx, rng=Surf())
    pk, sk = eng.keypair()
    ck = eng.genck(sk)
    rk = eng.genrk(sk, rotations=[1])
    m0 = smp.sample_z01vec(eng.rng, ctx.slots)
    ct = eng.enc_pk(eng.ecd(m0), pk)
    mesh = make_he_mesh3(8, limb=2, coeff=2)
    B = 2

    def bat(x):
        return jnp.broadcast_to(x[None], (B,) + x.shape)
    for name, r, swk, ref in [
            ("rot1", 1, rk[1], eng.rot(ct.copy(), 1, rk)),
            ("conj", None, ck, eng.conj(ct.copy(), ck))]:
        f = build_sharded_rot(eng, ct.l, mesh, r)
        c0, c1 = f(bat(ct.c0), bat(ct.c1), swk.p0hat, swk.p1hat)
        for i in range(B):
            assert np.array_equal(np.asarray(c0[i]), np.asarray(ref.c0)), \
                f"{name}: c0[{i}] differs"
            assert np.array_equal(np.asarray(c1[i]), np.asarray(ref.c1)), \
                f"{name}: c1[{i}] differs"
        out = Ciphertext(l=ref.l, nu=ref.nu, B=ref.B, c0=c0[0], c1=c1[0])
        got = eng.dcd(eng.dec(out, sk))
        want = np.roll(m0, -1) if r == 1 else np.conj(m0)
        assert np.max(np.abs(got - want)) < 1e-5, name


@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 virtual devices")
def test_sharded_gemv_step_matches_engine():
    """One double-hoisted gemv giant step on the (limb=2, coeff=2) mesh ==
    the engine's hoisted_gemv_step_fn, bit for bit; the rotation-key slab
    shards over (limb, coeff) (VERDICT r2 #5)."""
    from gpqhe_jax.algo.linalg import HoistedGemvPlan
    from gpqhe_jax.context import HeContext
    from gpqhe_jax.parallel.mesh import build_sharded_gemv_step, make_he_mesh3
    from gpqhe_jax.ring import sample as smp
    from gpqhe_jax.scheme.engine import CKKS
    from gpqhe_jax.substrate.surf import Surf

    ctx = HeContext(logn=6, q=1 << 110, slots=4, Delta=1 << 30)
    # extra hoist margin so the limb-padded dims_h still fits the swk limbs
    eng = CKKS(ctx, rng=Surf(), hoist_bits=160)
    pk, sk = eng.keypair()
    rk = eng.genrk(sk)
    m0 = smp.sample_z01vec(eng.rng, ctx.slots)
    ct = eng.enc_pk(eng.ecd(m0), pk)
    rng = np.random.default_rng(3)
    A = (rng.standard_normal(ctx.slots * ctx.slots)
         + 1j * rng.standard_normal(ctx.slots * ctx.slots))
    plan = HoistedGemvPlan(eng, A)
    l = ct.l
    dims_h, dimc, _ = plan.dims(eng, l)
    # pad both bases up to the limb-axis multiple (still valid CRT ranges)
    dims_h += dims_h % 2
    dimc += dimc % 2
    bnd_sum = plan.bound_max() * plan.n1
    prep = eng.hoisted_gemv_prep_fn(l, plan.n1, dims_h, dimc)
    step = eng.hoisted_gemv_step_fn(l, dims_h, dimc,
                                    bits_h=eng.bits_hoist(l, bnd_sum),
                                    bits_c=eng.ctx.bits_mulpt(l, bnd_sum))
    c1p, c0p = prep(ct.c0, ct.c1)
    rk0, rk1 = plan.rk_stack(rk)
    ptx_0, ptb_0 = plan.pack_slab(eng, l, 0, dims=(dims_h, dimc))
    ref0, ref1 = step(c1p, c0p, ptx_0, ptb_0, rk0, rk1)

    mesh = make_he_mesh3(8, limb=2, coeff=2)
    fsh = build_sharded_gemv_step(eng, l, plan.n1, dims_h, dimc, mesh)
    got0, got1 = fsh(c1p, c0p, ptx_0, ptb_0, rk0, rk1)
    assert np.array_equal(np.asarray(got0), np.asarray(ref0))
    assert np.array_equal(np.asarray(got1), np.asarray(ref1))


@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 virtual devices")
def test_sharded_reconstruct_large_basis_psum_exact():
    """Limb-psum CRT reconstruct at dim=80 with adversarial max-digit
    residues (ADVICE r3, high): the psum must run on the PRE-fold 8-bit
    column sums — the folded 16-bit digit sums are 257x larger and wrap
    u32 once dim_total >= ~37 (the bootstrap-scale key-switch basis is
    ~48).  Verified against both the single-device reconstruct and a
    python-int CRT oracle."""
    from functools import partial

    from jax.sharding import Mesh, PartitionSpec as P
    from jax import shard_map

    from gpqhe_jax.ops import rns as rns_ops

    logn, dim, nloc = 6, 80, 8
    pctx = PolyContext(logn, q=1 << 100, dim_cap=dim)
    b = pctx.basis(dim)
    plan = rns_ops.make_recon_plan(pctx, dim)

    # adversarial y (pre_scaled path: res IS y): all-0xFF low 7 bytes,
    # < every 59-bit prime, maximizing every 8-bit digit plane product
    y_np = np.full((dim, nloc), (1 << 56) - 1, dtype=np.uint64)
    rng = np.random.default_rng(5)
    y_np[:, -2:] = np.stack(
        [rng.integers(0, p, 2, dtype=np.uint64) for p in b.primes], axis=0)
    y = jnp.asarray(y_np)

    common = dict(
        ps=jnp.array(b.ps), pinv=jnp.array(b.pinv_mont),
        phinv=jnp.array(b.phatinv_mont),
        planes=jnp.asarray(rns_ops.phat_plane_table(plan)),
        inv_p=jnp.asarray(plan.inv_p),
        negP16=jnp.asarray(plan.negP16),
        mmp=jnp.asarray(plan.MminusP_limbs),
        plimbs=jnp.asarray(plan.P_limbs),
        phalf=jnp.asarray(plan.Phalf_limbs))

    def recon(res, ps, pinv, phinv, planes, inv_p, negP16, mmp, plimbs,
              phalf, axis_name=None):
        return rns_ops.reconstruct_core(
            res, ps, pinv, phinv, planes, inv_p, negP16, mmp, plimbs,
            phalf, ks=plan.ks, dim_total=dim, center=True,
            axis_name=axis_name, pre_scaled=True)

    single = np.asarray(recon(y, *common.values()))

    mesh = Mesh(np.array(jax.devices()[:8]), axis_names=("limb",))
    smapped = shard_map(
        partial(recon, axis_name="limb"), mesh=mesh,
        in_specs=(P("limb", None), P("limb"), P("limb"), P("limb"),
                  P("limb", None, None), P("limb"), P(), P(), P(), P()),
        out_specs=P(None, None), check_vma=False)
    sharded = np.asarray(jax.jit(smapped)(y, *common.values()))
    assert np.array_equal(sharded, single)

    # python-int CRT oracle: S = sum y_d phat_d; centered mod P
    for i in range(nloc):
        S = sum(int(y_np[d, i]) * b.phat[d] for d in range(dim))
        v = S % b.P
        if v > b.P // 2:
            v -= b.P
        want = bigint.int_to_limbs(v, plan.ks)
        assert np.array_equal(single[i], want), f"coefficient {i}"


@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 virtual devices")
def test_mesh_engine_coeff2slot_matches_single():
    """Whole-composition mesh execution (VERDICT r3 #4): coeff2slot —
    SubSum rotations + conj + 4 hoisted gemvs (sharded giant steps + outer
    rotations) + mulpt/rs — on MeshCKKS over the (limb=2, coeff=2, batch=2)
    mesh, BIT-exact vs the single-device engine composition."""
    from gpqhe_jax import bootstrap as bs
    from gpqhe_jax.context import HeContext
    from gpqhe_jax.parallel.engine import MeshCKKS
    from gpqhe_jax.parallel.mesh import make_he_mesh3
    from gpqhe_jax.ring import sample as smp
    from gpqhe_jax.scheme.engine import CKKS
    from gpqhe_jax.substrate.surf import Surf

    ctx = HeContext(logn=6, q=1 << 400, slots=4, Delta=1 << 30)

    def run(eng):
        pk, sk = eng.keypair()
        ck = eng.genck(sk)
        rk = eng.genrk(sk, bs.bootstrap_rotations(ctx))
        m0 = smp.sample_z01vec(eng.rng, ctx.slots) / (1 << 30)
        ct = eng.enc_pk(eng.ecd(m0), pk)
        bctx = bs.BootstrapContext(eng)
        ct0, ct1 = bs.coeff2slot(eng, bctx, ct, ck, rk)
        return ct0, ct1, sk, eng

    ct0_s, ct1_s, sk, eng_s = run(CKKS(ctx, rng=Surf(), hoist_bits=160))
    mesh = make_he_mesh3(8, limb=2, coeff=4)   # batch=1: single-ct workload
    ct0_m, ct1_m, _, eng_m = run(
        MeshCKKS(ctx, mesh, rng=Surf(), hoist_bits=160))
    assert eng_m._mesh_jit, "mesh engine never built a sharded program"
    for nm, a, b in [("ct0.c0", ct0_s.c0, ct0_m.c0),
                     ("ct0.c1", ct0_s.c1, ct0_m.c1),
                     ("ct1.c0", ct1_s.c0, ct1_m.c0),
                     ("ct1.c1", ct1_s.c1, ct1_m.c1)]:
        assert np.array_equal(np.asarray(a), np.asarray(b)), f"{nm} differs"


@pytest.mark.slow   # ~10 min: two full bootstrap compositions
@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 virtual devices")
def test_mesh_engine_full_bootstrap_matches_single():
    """The DEEPEST whole composition on the mesh engine: full bootstrap
    (raise -> SubSum -> coeff2slot -> EvalSin -> slot2coeff -> rs, dozens
    of rot/conj/mul_rs programs) on MeshCKKS, BIT-exact vs the single-device
    engine and decode-correct (ref: src/he-bootstrap.c:477-546)."""
    from gpqhe_jax import bootstrap as bs
    from gpqhe_jax.context import HeContext
    from gpqhe_jax.parallel.engine import MeshCKKS
    from gpqhe_jax.parallel.mesh import make_he_mesh3
    from gpqhe_jax.ring import sample as smp
    from gpqhe_jax.scheme.engine import CKKS
    from gpqhe_jax.substrate.surf import Surf

    # tiny-ring deep ladder (see tests/test_bootstrap.py): h=16 -> iter=7,
    # logq mod 30 = 10 keeps q_0 = 2^10
    ctx = HeContext(logn=5, q=1 << 790, slots=4, Delta=1 << 30)

    def run(eng):
        pk, sk = eng.keypair()
        rlk = eng.genrlk(sk)
        ck = eng.genck(sk)
        rk = eng.genrk(sk, bs.bootstrap_rotations(ctx))
        m0 = smp.sample_z01vec(eng.rng, ctx.slots) * 0.1
        ct = eng.enc_pk(eng.ecd(m0), pk)
        while ct.l > 1:
            ct = eng.moddown(ct)
        bctx = bs.BootstrapContext(eng)
        out = bs.bootstrap(eng, bctx, ct, rlk, ck, rk, iter=7)
        return out, m0, sk, eng

    out_s, m0, sk, eng_s = run(CKKS(ctx, rng=Surf()))
    mesh = make_he_mesh3(8, limb=2, coeff=4)   # batch=1: single-ct workload
    out_m, _, _, eng_m = run(MeshCKKS(ctx, mesh, rng=Surf()))
    assert eng_m._mesh_jit, "mesh engine never built a sharded program"
    assert np.array_equal(np.asarray(out_s.c0), np.asarray(out_m.c0))
    assert np.array_equal(np.asarray(out_s.c1), np.asarray(out_m.c1))
    got = eng_s.dcd(eng_s.dec(out_m, sk))
    assert np.max(np.abs(got - m0)) < 1e-2


@pytest.mark.slow   # ~5 min: two coeff2slot compositions at logn=12
@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 virtual devices")
def test_mesh_engine_coeff2slot_security_ring():
    """Mesh composition witnessed at a SECURITY-TABLE ring (VERDICT r4 #6):
    coeff2slot through MeshCKKS at logn=12/logq=109 over the (2,2,2) mesh,
    bit-exact vs the single-device engine (the default-suite variant of this
    test runs at logn=6; __graft_entry__.dryrun_multichip runs the same
    composition for the driver artifact)."""
    from gpqhe_jax import bootstrap as bs
    from gpqhe_jax.context import HeContext
    from gpqhe_jax.parallel.engine import MeshCKKS
    from gpqhe_jax.parallel.mesh import make_he_mesh3
    from gpqhe_jax.ring import sample as smp
    from gpqhe_jax.scheme.engine import CKKS
    from gpqhe_jax.substrate import surf as surf_mod
    from gpqhe_jax.substrate.surf import Surf

    ctx = HeContext(logn=12, q=1 << 109, slots=4, Delta=1 << 30)

    def run(eng):
        surf_mod.reset_default_rng()
        pk, sk = eng.keypair()
        ck = eng.genck(sk)
        rk = eng.genrk(sk, bs.bootstrap_rotations(ctx))
        m0 = smp.sample_z01vec(eng.rng, ctx.slots) / (1 << 10)
        ct = eng.enc_pk(eng.ecd(m0), pk)
        bctx = bs.BootstrapContext(eng)
        return bs.coeff2slot(eng, bctx, ct, ck, rk)

    s0, s1 = run(CKKS(ctx, rng=Surf(), hoist_bits=80))
    mesh = make_he_mesh3(8, limb=2, coeff=2)
    m0c, m1c = run(MeshCKKS(ctx, mesh, rng=Surf(), hoist_bits=80))
    for nm, a, b in [("ct0.c0", s0.c0, m0c.c0), ("ct0.c1", s0.c1, m0c.c1),
                     ("ct1.c0", s1.c0, m1c.c0), ("ct1.c1", s1.c1, m1c.c1)]:
        assert np.array_equal(np.asarray(a), np.asarray(b)), f"{nm} differs"
