#!/usr/bin/env python
"""On-device smoke test of the CKKS engine's main path, in one process.

    python chip_smoke.py               # phases ntt, scheme, bootstrap: one GPU
    python chip_smoke.py --four-cards  # the mesh phase only: four GPUs

The first thing it does is require that JAX's first device is a GPU; on any
other platform it exits non-zero and prints no result.  Every phase checks
its outputs against an independent reference and raises on any mismatch, so
the script exits 0 only when every check passed.  The last line of stdout is
one JSON object:

    {"ok": true, "device": {"platform": "gpu", "kind": "...", "count": 1}}

Phases (each a function that the CPU test suite also runs at a small size):

  ntt        RingEngine.ntt_f / ntt_i at n=2^16, dim=16, batch=8 and at
             n=2^14 over the mul_rs basis: bit-exact against the numpy
             butterfly oracle, exact round trip, warm us/NTT beside the
             device-memory floor.
  scheme     the reference's linear-op deployment, logn=14, logq=438,
             slots=16, Delta=2^50 (tests/gpqhe.c:1296-1299): full key set,
             the golden replay of the compiled reference binary
             (tests/golden/golden_algo_linear.json, gate 1e-9), mul_rs,
             mul_rs_batch (B=8, each output bit-identical to mul_rs),
             rot/conj, and rns.reconstruct bit-exact against a Python-int
             CRT oracle at the key-switch bases.
  bootstrap  the logn=9 proxy at the reference depth (h=64, iter=9).
  mesh       (--four-cards) sharded mul_rs and rot on a (limb=2, coeff=2)
             mesh, through build_sharded_* and MeshCKKS, bit-identical to
             the single-device engine.
"""

from __future__ import annotations

import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# configurations: the deployment sizes the script runs at on the card
NTT_SHAPES = ((16, 16, 8), (14, "mul_rs", 4))       # (logn, dim, batch)
SCHEME = dict(logn=14, logq=438, slots=16, logDelta=50, golden="linear",
              tol=1e-5, batch=8, reps=10)
BOOTSTRAP = dict(logn=9, logq=640, iter=9)
MESH = dict(logn=14, logq=438, slots=16, logDelta=50, tol=1e-5, reps=10)

# device-memory bandwidth by device_kind (NVIDIA H100 SXM data sheet)
HBM_BYTES_PER_S = {"NVIDIA H100 80GB HBM3": 3.35e12}


def log(msg: str) -> None:
    print(msg, flush=True)


def gate():
    """Require a GPU before anything else; returns jax's device list."""
    import jax
    devs = jax.devices()
    if devs[0].platform != "gpu":
        print(f"chip_smoke.py needs a GPU; JAX found platform "
              f"{devs[0].platform!r}", file=sys.stderr)
        sys.exit(2)
    return devs


# ---------------------------------------------------------------------------
# timing helpers
# ---------------------------------------------------------------------------

def report(phase: str, name: str, cold: float, warm, scale=1e3, unit="ms"):
    from gpqhe_jax.utils.pmu import quartiles
    q1, med, q3 = quartiles(warm)
    log(f"[{phase}] {name}: compile+first {cold:.2f} s, warm median "
        f"{med*scale:.4f} {unit} (q1 {q1*scale:.4f}, q3 {q3*scale:.4f}, "
        f"n={len(warm)})")
    return med


# ---------------------------------------------------------------------------
# phase: ntt
# ---------------------------------------------------------------------------

def phase_ntt(shapes=NTT_SHAPES, reps: int = 30) -> dict:
    """Forward/inverse NTT through RingEngine at each (logn, dim, batch);
    dim "mul_rs" is the logn=14/logq=438 mul_rs basis (ctx.dim_mul(L))."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from gpqhe_jax.context import HeContext, PolyContext
    from gpqhe_jax.ops.ntt import ntt_numpy
    from gpqhe_jax.ring.poly import RingEngine
    from gpqhe_jax.utils.pmu import run_timed

    out = {}
    for logn, dim, batch in shapes:
        if dim == "mul_rs":
            ctx = HeContext(logn=logn, q=1 << SCHEME["logq"],
                            slots=SCHEME["slots"], Delta=1 << SCHEME["logDelta"])
            pctx, dim = ctx.poly, ctx.dim_mul(ctx.L)
        else:
            pctx = PolyContext(logn, q=1 << 900, dim_cap=dim)
        n = pctx.n
        ring = RingEngine(pctx)
        ring.prepare(dim)
        rng = np.random.default_rng(logn)
        a_np = np.stack([np.stack([rng.integers(0, p, n, dtype=np.uint64)
                                   for p in pctx.primes[:dim]])
                         for _ in range(batch)])               # [B, dim, n]
        a = jnp.asarray(a_np)
        fwd = jax.jit(lambda x: ring.ntt_f(x, dim))
        inv = jax.jit(lambda x: ring.ntt_i(x, dim))
        label = f"n=2^{logn} dim={dim} batch={batch}"
        ahat, cold_f, warm_f = run_timed(lambda: fwd(a), reps)
        back, cold_i, warm_i = run_timed(lambda: inv(ahat), reps)
        ahat_np = np.asarray(ahat)
        for d in range(dim):
            ref = ntt_numpy(a_np[:, d], pctx.prime_ctx[d].zetas,
                            np.uint64(pctx.primes[d]),
                            np.uint64(pctx.prime_ctx[d].pinv_mont))
            assert np.array_equal(ahat_np[:, d], ref), \
                f"NTT {label}: prime {d} differs from the numpy oracle"
        assert np.array_equal(np.asarray(back), a_np), \
            f"NTT {label}: inverse(forward(a)) != a"
        nts = batch * dim
        med_f = report("ntt", f"forward {label}", cold_f,
                       [w / nts for w in warm_f], 1e6, "us/NTT")
        med_i = report("ntt", f"inverse {label}", cold_i,
                       [w / nts for w in warm_i], 1e6, "us/NTT")
        # floor: every stage reads and writes the whole u64 vector once
        floor_bytes = logn * 2 * 8 * n
        bw = HBM_BYTES_PER_S.get(jax.devices()[0].device_kind)
        floor = (f"{floor_bytes / bw * 1e6:.2f} us at {bw / 1e12:.2f} TB/s"
                 if bw else "no bandwidth entry for this device kind")
        log(f"[ntt] {label}: bit-exact vs numpy oracle, round trip exact; "
            f"device-memory floor {floor_bytes / 1e6:.1f} MB/NTT = {floor}")
        out[label] = dict(fwd_us=med_f * 1e6, inv_us=med_i * 1e6,
                          floor_bytes=floor_bytes)
    return out


# ---------------------------------------------------------------------------
# phase: scheme
# ---------------------------------------------------------------------------

def check_reconstruct(eng, dim: int, seed: int) -> None:
    """rns.reconstruct vs a Python-int CRT oracle, bit for bit, over the
    first `dim` primes: the exact path (center False/True) on uniformly
    random residues, and the truncated fast path on random integers of a
    bounded magnitude (3 bits of margin below P, as the engine's callers
    guarantee)."""
    import random

    import jax
    import jax.numpy as jnp
    import numpy as np
    from gpqhe_jax.ops import rns as rns_ops
    from gpqhe_jax.substrate import bigint

    pctx = eng.ctx.poly
    n = pctx.n
    b = pctx.basis(dim)
    ba, plan = eng.ring.ba(dim), eng.ring.recon(dim)
    P = b.P
    crt = [(P // p) * pow(P // p, -1, p) % P for p in b.primes]
    rng = np.random.default_rng(seed)
    res = np.stack([rng.integers(0, p, n, dtype=np.uint64) for p in b.primes])
    cols = res.T.tolist()
    vals = [sum(r * c for r, c in zip(col, crt)) % P for col in cols]
    for center in (False, True):
        want = [v - P if center and v >= b.P_half else v for v in vals]
        f = jax.jit(lambda r, c=center: rns_ops.reconstruct(r, ba, plan,
                                                            center=c))
        got = np.asarray(f(jnp.asarray(res)))
        assert np.array_equal(got, bigint.ints_to_limbs(want, plan.ks)), \
            f"reconstruct dim={dim} center={center} differs from the oracle"
    # truncated fast path (the key-switch call shape: k_out = eng.kq)
    bound = plan.logP - 3
    k_out = min(eng.kq, plan.ks)
    pr = random.Random(seed)
    xs = [pr.getrandbits(bound) * (1 if pr.getrandbits(1) else -1)
          for _ in range(n)]
    res_b = np.array([[x % p for x in xs] for p in b.primes], dtype=np.uint64)
    f = jax.jit(lambda r: rns_ops.reconstruct(r, ba, plan, center=True,
                                              k_out=k_out, bound_bits=bound))
    got = np.asarray(f(jnp.asarray(res_b)))
    assert np.array_equal(got, bigint.ints_to_limbs(xs, k_out)), \
        f"reconstruct fast path dim={dim} differs from the oracle"


def _golden(name: str) -> dict:
    import numpy as np
    with open(os.path.join(HERE, "tests", "golden", name)) as f:
        return {k: np.array([complex(a, b) for a, b in v])
                for k, v in json.load(f).items()}


def replay_golden_linear(eng, keys, dec) -> None:
    """tests/test_golden_algo.py::test_golden_algo_linear, op for op."""
    import numpy as np
    from gpqhe_jax.algo.linalg import HoistedGemvPlan, gemv, he_idx, he_nrm2, he_sum
    from gpqhe_jax.ring import sample as smp

    g = _golden("golden_algo_linear.json")
    ctx = eng.ctx
    pk, sk, rlk, ck, rk = keys
    v = smp.sample_z01vec(eng.rng, ctx.slots)
    A = smp.sample_z01vec(eng.rng, ctx.slots * ctx.slots)
    assert np.array_equal(v, g["v"]), "surf stream divergence (v)"
    assert np.array_equal(A, g["A"]), "surf stream divergence (A)"
    ct = eng.enc_pk(eng.ecd(v), pk)
    outs = {
        "gemv": dec(gemv(eng, A, ct.copy(), rk)),
        "gemv_hoisted": dec(gemv(eng, None, ct.copy(), rk,
                                 plan=HoistedGemvPlan(eng, A), hoisted=True)),
        "sum": dec(he_sum(eng, ct.copy(), rk)),
        "idx1": dec(he_idx(eng, ct.copy(), 1, rk)),
        "nrm2": dec(he_nrm2(eng, ct.copy(), rlk, ck, rk)),
    }
    for name, got in outs.items():
        diff = float(np.max(np.abs(got - g[name.replace("_hoisted", "")])))
        log(f"[scheme] golden {name}: diff {diff:.3e} (gate 1e-9)")
        assert diff < 1e-9, f"golden {name}: diff {diff} vs reference binary"


def replay_golden_logn11(eng, keys, dec) -> None:
    """tests/test_golden.py::test_golden_vs_reference_binary, op for op."""
    import numpy as np
    from gpqhe_jax import params
    from gpqhe_jax.ring import sample as smp

    g = _golden("golden_logn11.json")
    ctx = eng.ctx
    pk, sk, rlk, ck, rk = keys
    m0 = smp.sample_z01vec(eng.rng, ctx.slots)
    ct1 = eng.enc_pk(eng.ecd(m0), pk)
    m1 = smp.sample_z01vec(eng.rng, ctx.slots)
    ct2 = eng.enc_pk(eng.ecd(m1), pk)
    assert np.array_equal(m0, g["m0"]), "surf stream diverged before m0"
    assert np.array_equal(m1, g["m1"]), "surf stream diverged before m1"
    tol_ks = (params.BLKSIZ + 2) / ctx.Delta
    checks = {
        "enc": (dec(ct1), 1e-9),
        "add": (dec(eng.add(ct1, ct2)), 1e-9),
        "mulrs": (dec(eng.rs(eng.mul(ct1, ct2, rlk))), tol_ks),
        "conj": (dec(eng.conj(ct1.copy(), ck)), tol_ks),
        "rot1": (dec(eng.rot(ct1.copy(), 1, rk)), tol_ks),
        "moddown": (dec(eng.moddown(ct1)), 1e-9),
    }
    for name, (got, tol) in checks.items():
        diff = float(np.max(np.abs(got - g[name])))
        log(f"[scheme] golden {name}: diff {diff:.3e} (gate {tol:.1e})")
        assert diff < tol, f"golden {name}: diff {diff} vs reference binary"


def phase_scheme(cfg: dict = SCHEME) -> dict:
    import jax
    import numpy as np
    from gpqhe_jax.context import HeContext
    from gpqhe_jax.ring import sample as smp
    from gpqhe_jax.scheme.engine import CKKS
    from gpqhe_jax.substrate.surf import Surf
    from gpqhe_jax.utils.pmu import run_timed

    t0 = time.perf_counter()
    ctx = HeContext(logn=cfg["logn"], q=1 << cfg["logq"], slots=cfg["slots"],
                    Delta=1 << cfg["logDelta"])
    eng = CKKS(ctx, rng=Surf())
    pk, sk = eng.keypair()
    rlk = eng.genrlk(sk)
    ck = eng.genck(sk)
    rk = eng.genrk(sk)
    keys = (pk, sk, rlk, ck, rk)
    log(f"[scheme] logn={cfg['logn']} logq={cfg['logq']} slots={cfg['slots']} "
        f"Delta=2^{cfg['logDelta']}: keypair, rlk, ck and {len(rk)} rotation "
        f"keys in {time.perf_counter() - t0:.1f} s")

    def dec(ct):
        return eng.dcd(eng.dec(ct, sk))

    t = time.perf_counter()
    {"linear": replay_golden_linear,
     "logn11": replay_golden_logn11}[cfg["golden"]](eng, keys, dec)
    log(f"[scheme] golden replay passed in {time.perf_counter() - t:.1f} s")

    tol, reps, B = cfg["tol"], cfg["reps"], cfg["batch"]
    msgs = [smp.sample_z01vec(eng.rng, ctx.slots) for _ in range(4)]
    cts = [eng.enc_pk(eng.ecd(m), pk) for m in msgs]
    res = {}

    out, cold, warm = run_timed(lambda: eng.mul_rs(cts[0], cts[1], rlk), reps)
    diff = float(np.max(np.abs(dec(out) - msgs[0] * msgs[1])))
    assert diff < tol, f"mul_rs decode diff {diff}"
    res["mul_rs_ms"] = report("scheme", f"mul_rs (decode diff {diff:.2e})",
                              cold, warm) * 1e3

    # B distinct pairs in one batched program, each bit-identical to mul_rs
    pairs = [(i % 4, (i + 1 + i // 4) % 4) for i in range(B)]
    c1s = [cts[i] for i, _ in pairs]
    c2s = [cts[j] for _, j in pairs]
    outs, cold, warm = run_timed(lambda: eng.mul_rs_batch(c1s, c2s, rlk), reps)
    for k, (i, j) in enumerate(pairs):
        single = eng.mul_rs(cts[i], cts[j], rlk)
        assert np.array_equal(np.asarray(outs[k].c0), np.asarray(single.c0)) \
            and np.array_equal(np.asarray(outs[k].c1), np.asarray(single.c1)), \
            f"mul_rs_batch output {k} differs from mul_rs"
    diff = float(np.max(np.abs(dec(outs[-1]) - msgs[pairs[-1][0]]
                               * msgs[pairs[-1][1]])))
    assert diff < tol, f"mul_rs_batch decode diff {diff}"
    med = report("scheme", f"mul_rs_batch B={B} (bit-identical to mul_rs)",
                 cold, warm)
    res["mul_rs_batch_ms_per_ct"] = med * 1e3 / B
    log(f"[scheme] mul_rs_batch: {med * 1e3 / B:.4f} ms/ct amortized")

    for name, fn, want in [
            ("rot1", lambda: eng.rot(cts[0].copy(), 1, rk), np.roll(msgs[0], -1)),
            ("conj", lambda: eng.conj(cts[0].copy(), ck), np.conj(msgs[0]))]:
        out, cold, warm = run_timed(fn, reps)
        diff = float(np.max(np.abs(dec(out) - want)))
        assert diff < tol, f"{name} decode diff {diff}"
        res[f"{name}_ms"] = report("scheme", f"{name} (decode diff {diff:.2e})",
                                   cold, warm) * 1e3

    for seed, dim in enumerate((ctx.dimswk, eng.dimswk_h)):
        t = time.perf_counter()
        check_reconstruct(eng, dim, seed)
        log(f"[scheme] reconstruct dim={dim}: bit-exact vs the Python-int CRT "
            f"oracle (exact and truncated paths, {time.perf_counter() - t:.1f} s)")

    stats = jax.devices()[0].memory_stats()
    peak = stats.get("peak_bytes_in_use") if stats else None
    log(f"[scheme] peak_bytes_in_use: "
        f"{peak if peak is not None else 'not reported by this backend'}")
    res["peak_bytes_in_use"] = peak
    return res


# ---------------------------------------------------------------------------
# phase: bootstrap
# ---------------------------------------------------------------------------

def phase_bootstrap(cfg: dict = BOOTSTRAP) -> dict:
    """The deepest composition: raise -> SubSum -> c2s -> EvalSin -> s2c at
    the reference's h=64 / iter=9 depth on a logn=9 ring (decode gate 1e-2,
    see bench.py stage_bootstrap)."""
    import numpy as np
    from gpqhe_jax import bootstrap as bs
    from gpqhe_jax.context import HeContext
    from gpqhe_jax.ring import sample as smp
    from gpqhe_jax.scheme.engine import CKKS
    from gpqhe_jax.substrate.surf import Surf
    from gpqhe_jax.utils.pmu import run_timed

    ctx = HeContext(logn=cfg["logn"], q=1 << cfg["logq"], slots=4,
                    Delta=1 << 30)
    eng = CKKS(ctx, rng=Surf())
    pk, sk = eng.keypair()
    rlk = eng.genrlk(sk)
    ck = eng.genck(sk)
    rk = eng.genrk(sk, bs.bootstrap_rotations(ctx))
    m0 = 0.1 * smp.sample_z01vec(eng.rng, ctx.slots)
    ct = eng.enc_pk(eng.ecd(m0), pk)
    while ct.l > 1:
        ct = eng.moddown(ct)
    bctx = bs.BootstrapContext(eng)

    out, cold, warm = run_timed(
        lambda: bs.bootstrap(eng, bctx, ct, rlk, ck, rk, iter=cfg["iter"]), 3)
    diff = float(np.max(np.abs(eng.dcd(eng.dec(out, sk)) - m0)))
    assert diff < 1e-2, f"bootstrap decode diff {diff} exceeds 1e-2"
    assert out.l >= 2, f"bootstrap landed too low (l={out.l})"
    med = report("bootstrap", f"logn={cfg['logn']} h=64 iter={cfg['iter']} "
                 f"(decode diff {diff:.2e}, {out.l} levels left)",
                 cold, warm, 1.0, "s")
    return dict(cold_s=cold, warm_s=med, levels_left=out.l)


# ---------------------------------------------------------------------------
# phase: mesh (--four-cards)
# ---------------------------------------------------------------------------

def phase_mesh(cfg: dict = MESH) -> dict:
    """Sharded mul_rs and rot on a (limb=2, coeff=2, batch=1) mesh of the
    first four devices — through the builders and through MeshCKKS — each
    bit-identical to the single-device engine in the same process."""
    import jax.numpy as jnp
    import numpy as np
    from gpqhe_jax.context import HeContext
    from gpqhe_jax.parallel.engine import MeshCKKS
    from gpqhe_jax.parallel.mesh import (build_sharded_mul_rs,
                                         build_sharded_rot, make_he_mesh3)
    from gpqhe_jax.ring import sample as smp
    from gpqhe_jax.scheme.engine import CKKS
    from gpqhe_jax.substrate.surf import Surf
    from gpqhe_jax.utils.pmu import run_timed

    mesh = make_he_mesh3(4, limb=2, coeff=2)
    ctx = HeContext(logn=cfg["logn"], q=1 << cfg["logq"], slots=cfg["slots"],
                    Delta=1 << cfg["logDelta"])
    eng = CKKS(ctx, rng=Surf())
    meng = MeshCKKS(ctx, mesh, rng=Surf())
    pk, sk = eng.keypair()
    rlk = eng.genrlk(sk)
    rk = eng.genrk(sk, rotations=[1])
    m0 = smp.sample_z01vec(eng.rng, ctx.slots)
    m1 = smp.sample_z01vec(eng.rng, ctx.slots)
    ct1 = eng.enc_pk(eng.ecd(m0), pk)
    ct2 = eng.enc_pk(eng.ecd(m1), pk)
    tol, reps = cfg["tol"], cfg["reps"]
    log(f"[mesh] mesh {dict(mesh.shape)} over "
        f"{[str(d) for d in mesh.devices.flat]}; logn={cfg['logn']} "
        f"logq={cfg['logq']}")

    def same(a, b, what):
        assert np.array_equal(np.asarray(a.c0), np.asarray(b.c0)) and \
            np.array_equal(np.asarray(a.c1), np.asarray(b.c1)), \
            f"{what} differs from the single-device engine"

    def dec_diff(ct, want):
        return float(np.max(np.abs(eng.dcd(eng.dec(ct, sk)) - want)))

    res = {}
    ref_m = [eng.mul_rs(ct1, ct2, rlk), eng.mul_rs(ct2, ct1, rlk)]
    ref_r = [eng.rot(ct1.copy(), 1, rk), eng.rot(ct2.copy(), 1, rk)]
    _, cold, warm = run_timed(lambda: eng.mul_rs(ct1, ct2, rlk), reps)
    res["single_mul_rs_ms"] = report("mesh", "single-device mul_rs", cold,
                                     warm) * 1e3

    # builder path: a batch of two ciphertext pairs
    fm = build_sharded_mul_rs(eng, ctx.L, mesh)
    a0, a1 = jnp.stack([ct1.c0, ct2.c0]), jnp.stack([ct1.c1, ct2.c1])
    (c0, c1), cold, warm = run_timed(
        lambda: fm(a0, a1, a0[::-1], a1[::-1], rlk.p0hat, rlk.p1hat), reps)
    for i, ref in enumerate(ref_m):
        same(type(ref)(l=ref.l, nu=ref.nu, B=ref.B, c0=c0[i], c1=c1[i]), ref,
             f"build_sharded_mul_rs output {i}")
    res["sharded_mul_rs_ms"] = report(
        "mesh", "build_sharded_mul_rs B=2 (bit-identical)", cold, warm) * 1e3
    fr = build_sharded_rot(eng, ct1.l, mesh, 1)
    (r0, r1), cold, warm = run_timed(
        lambda: fr(a0, a1, rk[1].p0hat, rk[1].p1hat), reps)
    for i, ref in enumerate(ref_r):
        same(type(ref)(l=ref.l, nu=ref.nu, B=ref.B, c0=r0[i], c1=r1[i]), ref,
             f"build_sharded_rot output {i}")
    res["sharded_rot_ms"] = report(
        "mesh", "build_sharded_rot B=2 (bit-identical)", cold, warm) * 1e3

    # engine path: what --mesh=2x2x1 users reach
    out_m, cold, warm = run_timed(lambda: meng.mul_rs(ct1, ct2, rlk), reps)
    same(out_m, ref_m[0], "MeshCKKS.mul_rs")
    diff = dec_diff(out_m, m0 * m1)
    assert diff < tol, f"MeshCKKS.mul_rs decode diff {diff}"
    res["meshckks_mul_rs_ms"] = report(
        "mesh", f"MeshCKKS.mul_rs (bit-identical, decode diff {diff:.2e})",
        cold, warm) * 1e3
    out_r, cold, warm = run_timed(lambda: meng.rot(ct1.copy(), 1, rk), reps)
    same(out_r, ref_r[0], "MeshCKKS.rot")
    diff = dec_diff(out_r, np.roll(m0, -1))
    assert diff < tol, f"MeshCKKS.rot decode diff {diff}"
    res["meshckks_rot_ms"] = report(
        "mesh", f"MeshCKKS.rot (bit-identical, decode diff {diff:.2e})",
        cold, warm) * 1e3
    return res


# ---------------------------------------------------------------------------

def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the mesh phase, on four GPUs")
    args = ap.parse_args(argv)

    devs = gate()
    import jax
    sys.path.insert(0, HERE)
    from gpqhe_jax.utils.info import device_summary, gpu_name_power
    from gpqhe_jax.utils.xla import enable_persistent_cache

    dev = device_summary()
    log(f"device_kind: {dev['kind']}  count: {dev['count']}")
    log(f"nvidia-smi: {gpu_name_power()}")
    log(f"jax {jax.__version__}  XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}")
    log(f"compile cache: {enable_persistent_cache()}")

    t0 = time.perf_counter()
    if args.four_cards:
        if len(devs) < 4:
            raise SystemExit(f"--four-cards needs 4 GPUs; JAX found {len(devs)}")
        phases = (("mesh", phase_mesh),)
    else:
        phases = (("ntt", phase_ntt), ("scheme", phase_scheme),
                  ("bootstrap", phase_bootstrap))
    for name, fn in phases:
        t = time.perf_counter()
        fn()
        log(f"== phase {name} passed in {time.perf_counter() - t:.1f} s")
    log(f"all phases passed in {time.perf_counter() - t0:.1f} s")
    log(f"nvidia-smi: {gpu_name_power()}")
    print(json.dumps({"ok": True, "device": dev}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
