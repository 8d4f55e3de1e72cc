#!/usr/bin/env python
"""Benchmark: the north-star metrics from BASELINE.md on one device.

  1. negacyclic NTT throughput at N = 2^16 (one "op" = one forward
     length-65536 NTT over one 59-bit prime);
  2. fused ciphertext mult+relinearize+rescale latency at the reference's
     linear-op parameters (logn=14, logq=438 — ref: tests/gpqhe.c:1296-1299),
     with a decode-correctness check against the plaintext product;
  3. the same op's amortized per-ciphertext THROUGHPUT at batch=8 (one
     program over a leading batch axis — CKKS.mul_rs_batch);
  4. double-hoisted BSGS gemv latency at the same parameters (slots=16);
  5. full bootstrap latency (default: logn=9 proxy with the REAL reference
     depth h=64/iter=9; reference scale logn=15/logq=881 with
     BENCH_FULL_BOOTSTRAP=1 — ref: src/he-bootstrap.c:477-546).

This file is BOTH the orchestrator and every stage:

  python bench.py                 # orchestrator: stages as subprocesses
  python bench.py --stage scheme  # one stage, prints its JSON metric lines

Stages run one after another, each in its own process, so exactly one JAX
process holds the device at a time; a stage past its budget is killed and
reaped before the next one starts.  Each stage checks its results for
correctness and raises on a mismatch; the orchestrator exits non-zero when
any stage failed or timed out.  Every stage enables the persistent
compilation cache (utils/xla.py enable_persistent_cache).

Times are warm medians over repeated calls (quartiles on stderr).  The
reference publishes no numbers, so vs_baseline for (1) is the speedup over
a vectorized numpy CPU implementation of the identical kernel on this host,
for (3) the per-ct speedup over this run's single-ct latency, and null
elsewhere.

Prints one JSON line per metric, naming the device it ran on:
  {"metric": "ntt_n65536_ops_per_sec", "value": N, "unit": "ntt/s",
   "vs_baseline": x, "device": {"platform": ..., "kind": ..., "count": ...}}
  also mul_rs_ms, mul_rs_batch8_ms_per_ct, gemv_ms, bootstrap_logn9_s.
"""

import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))


def log(*a):
    print(*a, file=sys.stderr, flush=True)


_DEVICE: dict = {}


def emit(metric, value, unit, vs_baseline):
    print(json.dumps({"metric": metric, "value": value, "unit": unit,
                      "vs_baseline": vs_baseline, "device": _DEVICE}),
          flush=True)


# ===========================================================================
# orchestrator
# ===========================================================================

STAGES = (
    # (name, budget_seconds): budgets cover cold compiles
    ("scheme", 1200),
    ("ntt", 600),
    ("bootstrap", 900),
)


def run_stage(name: str, budget: float) -> bool:
    """Run one stage as a subprocess (its stdout passes straight through).
    True iff it exited 0 within its budget; a stage past its budget is
    killed and reaped, so no process of it holds the device afterwards."""
    import subprocess

    cmd = [sys.executable, os.path.abspath(__file__), "--stage", name]
    log(f"[bench] stage {name}: budget {budget:.0f}s")
    t0 = time.time()
    p = subprocess.Popen(cmd, cwd=HERE)
    try:
        rc = p.wait(timeout=budget)
    except subprocess.TimeoutExpired:
        log(f"[bench] stage {name}: BUDGET EXCEEDED ({budget:.0f}s) — killed")
        p.kill()
        p.wait()
        rc = None
    log(f"[bench] stage {name}: rc={rc}, {time.time()-t0:.1f}s")
    return rc == 0


def orchestrate() -> int:
    t0 = time.time()
    failed = []
    for name, budget in STAGES:
        if name == "bootstrap" and os.environ.get("BENCH_FULL_BOOTSTRAP") == "1":
            budget = 3000
        if not run_stage(name, budget):
            failed.append(name)
    log(f"[bench] done in {time.time()-t0:.1f}s; "
        f"failed stages: {failed or 'none'}")
    return 1 if failed else 0


# ===========================================================================
# stage plumbing
# ===========================================================================

def stage_setup():
    """Common per-stage init: x64, persistent compile cache, device line."""
    t0 = time.time()
    sys.path.insert(0, HERE)
    import jax
    jax.config.update("jax_enable_x64", True)
    from gpqhe_jax.utils.info import device_summary, gpu_name_power
    from gpqhe_jax.utils.xla import enable_persistent_cache
    cache_dir = enable_persistent_cache()
    _DEVICE.update(device_summary())
    if _DEVICE["platform"] != "gpu":
        # a measurement that finds no card fails; it never falls back
        raise SystemExit(f"bench.py needs a GPU; JAX found {_DEVICE}")
    log(f"device: platform={_DEVICE['platform']} kind={_DEVICE['kind']} "
        f"count={_DEVICE['count']} nvidia-smi: {gpu_name_power()} "
        f"({time.time()-t0:.1f}s startup; cache {cache_dir})")
    return t0


# ===========================================================================
# stages
# ===========================================================================

def stage_ntt():
    """Metric 1: NTT throughput at n=2^16 over a [BATCH, DIM] stack."""
    t0 = stage_setup()
    import jax
    import jax.numpy as jnp
    import numpy as np
    from gpqhe_jax.context import PolyContext
    from gpqhe_jax.ops.ntt import ntt_numpy
    from gpqhe_jax.ring.poly import RingEngine
    from gpqhe_jax.utils.pmu import quartiles, run_timed

    LOGN, DIM, BATCH = 16, 16, 8
    n = 1 << LOGN
    pctx = PolyContext(LOGN, q=1 << 900, dim_cap=DIM)
    ring = RingEngine(pctx)
    ring.prepare(DIM)
    log(f"context ready ({time.time()-t0:.1f}s)")

    rng = np.random.default_rng(0)
    a_np = np.stack([
        np.stack([rng.integers(0, p, n, dtype=np.uint64) for p in pctx.primes[:DIM]])
        for _ in range(BATCH)])
    a = jnp.asarray(a_np)

    comp = jax.jit(lambda x: ring.ntt_f(x, DIM)).lower(a).compile()
    log(f"compiled ({time.time()-t0:.1f}s)")
    out = comp(a)
    out.block_until_ready()

    # correctness spot check vs the numpy oracle on one (batch, prime)
    check = ntt_numpy(a_np[0, 0:1].copy(), pctx.prime_ctx[0].zetas,
                      np.uint64(pctx.primes[0]),
                      np.uint64(pctx.prime_ctx[0].pinv_mont))
    assert np.array_equal(np.asarray(out)[0, 0], check[0]), \
        "device NTT mismatch vs the numpy oracle"
    log("correctness check passed")

    q1, med, q3 = quartiles(run_timed(lambda: comp(a), 30)[2])
    ops_per_sec = BATCH * DIM / med
    log(f"device: [{BATCH},{DIM},{n}] NTT median {med*1e3:.3f} ms "
        f"(q1 {q1*1e3:.3f}, q3 {q3*1e3:.3f}) -> {ops_per_sec:.1f} ntt/s")

    # CPU baseline: one prime's stack, normalized to ops/s
    b_np = a_np[0, :4].copy()
    t1 = time.time()
    ntt_numpy(b_np, pctx.prime_ctx[0].zetas, np.uint64(pctx.primes[0]),
              np.uint64(pctx.prime_ctx[0].pinv_mont))
    base_ops = 4 / (time.time() - t1)
    log(f"numpy-cpu baseline: {base_ops:.1f} ntt/s")
    emit("ntt_n65536_ops_per_sec", round(ops_per_sec, 2), "ntt/s",
         round(ops_per_sec / base_ops, 3))


def stage_scheme():
    """Metrics 2-4: mul_rs latency, batch-8 throughput, hoisted gemv —
    one context (logn=14, logq=438), one key set."""
    t0 = stage_setup()
    import numpy as np
    from gpqhe_jax.algo.linalg import HoistedGemvPlan, gemv
    from gpqhe_jax.context import HeContext
    from gpqhe_jax.ring import sample as smp
    from gpqhe_jax.scheme.engine import CKKS
    from gpqhe_jax.substrate.surf import Surf
    from gpqhe_jax.utils.pmu import quartiles, run_timed

    ctx = HeContext(logn=14, q=1 << 438, slots=16, Delta=1 << 50)
    eng = CKKS(ctx, rng=Surf())
    pk, sk = eng.keypair()
    rlk = eng.genrlk(sk)
    m1 = smp.sample_z01vec(eng.rng, ctx.slots)
    m2 = smp.sample_z01vec(eng.rng, ctx.slots)
    ct1 = eng.enc_pk(eng.ecd(m1), pk)
    ct2 = eng.enc_pk(eng.ecd(m2), pk)
    log(f"mul_rs context+keys ready ({time.time()-t0:.1f}s)")

    out_ct = eng.mul_rs(ct1, ct2, rlk)      # compile + warm
    got = eng.dcd(eng.dec(out_ct, sk))
    diff = float(np.max(np.abs(got - m1 * m2)))
    assert diff < 1e-5, f"mul_rs decode diff {diff} exceeds the reference KAT tolerance"
    log(f"mul_rs correctness check passed (diff {diff:.2e}; "
        f"{time.time()-t0:.1f}s)")
    q1, med, q3 = quartiles(run_timed(lambda: eng.mul_rs(ct1, ct2, rlk), 20)[2])
    ms = med * 1e3
    log(f"mul_rs: median {ms:.3f} ms (q1 {q1*1e3:.3f}, q3 {q3*1e3:.3f}; "
        f"logn=14, logq=438)")
    emit("mul_rs_ms", round(ms, 3), "ms", None)

    # ---- throughput: amortized ms/ct at batch=8 (one fused program)
    Bb = 8
    cts1 = [ct1] * Bb
    cts2 = [ct2] * Bb
    outs = eng.mul_rs_batch(cts1, cts2, rlk)      # compile + warm
    gotb = eng.dcd(eng.dec(outs[0], sk))
    diffb = float(np.max(np.abs(gotb - m1 * m2)))
    assert diffb < 1e-5, f"batched mul_rs decode diff {diffb}"
    q1, med, q3 = quartiles(run_timed(
        lambda: eng.mul_rs_batch(cts1, cts2, rlk), 10)[2])
    ms_ct = med * 1e3 / Bb
    log(f"mul_rs batch={Bb}: {ms_ct:.3f} ms/ct amortized (q1 "
        f"{q1*1e3/Bb:.3f}, q3 {q3*1e3/Bb:.3f}; {time.time()-t0:.1f}s)")
    emit("mul_rs_batch8_ms_per_ct", round(ms_ct, 3), "ms/ct",
         round(ms / ms_ct, 3))   # vs this run's single-ct latency

    # ---- algorithm layer: hoisted gemv at slots=16
    rk = eng.genrk(sk)
    rng_np = np.random.default_rng(1)
    A = (rng_np.standard_normal(ctx.slots * ctx.slots)
         + 1j * rng_np.standard_normal(ctx.slots * ctx.slots))
    plan = HoistedGemvPlan(eng, A)
    out = gemv(eng, None, ct1, rk, plan=plan, hoisted=True)   # compile + warm
    got = eng.dcd(eng.dec(out, sk))
    want = A.reshape(ctx.slots, ctx.slots) @ m1
    diffg = float(np.max(np.abs(got - want)))
    assert diffg < 1e-5, f"gemv decode diff {diffg}"
    assert plan.fallbacks == 0, "hoisted gemv fell back to the classic path"
    q1, med, q3 = quartiles(run_timed(
        lambda: gemv(eng, None, ct1, rk, plan=plan, hoisted=True), 10)[2])
    log(f"gemv (hoisted, slots=16, logn=14): median {med*1e3:.3f} ms (q1 "
        f"{q1*1e3:.3f}, q3 {q3*1e3:.3f}; {time.time()-t0:.1f}s)")
    emit("gemv_ms", round(med * 1e3, 3), "ms", None)


def stage_bootstrap():
    """Metric 5: full bootstrap pipeline on the device: raise -> SubSum ->
    c2s -> EvalSin -> s2c, the deepest composition (dozens of per-level
    programs).

    Default config: logn=9, logq=640 — the REAL pipeline at the reference's
    Hamming weight h=64 and EvalSin depth iter=9 (the range condition
    2^iter >= 4*pi*(h/2+1) is h-determined, so the arithmetic depth is
    IDENTICAL to the reference scale; only the ring is small).  The
    reference-scale config (logn=15, logq=881 — tests/test_bootstrap_refscale
    and README) is opt-in via BENCH_FULL_BOOTSTRAP=1.

    Message scaled by 0.1, decode gate 1e-2 (see doc/architecture.md's
    bootstrap error budget: EvalSin's approximation error in message units
    is ~q_src/(2pi*Delta) * eps_taylor, far above the 1e-5 linear-op gate)."""
    t0 = stage_setup()
    import jax
    import numpy as np
    from gpqhe_jax import bootstrap as bs
    from gpqhe_jax.context import HeContext
    from gpqhe_jax.ring import sample as smp
    from gpqhe_jax.scheme.engine import CKKS
    from gpqhe_jax.substrate.surf import Surf

    full = os.environ.get("BENCH_FULL_BOOTSTRAP") == "1"
    if full:
        logn, logq, min_l = 15, 881, 10
    else:
        logn, logq, min_l = 9, 640, 2
    ctx = HeContext(logn=logn, q=1 << logq, slots=4, Delta=1 << 30)
    eng = CKKS(ctx, rng=Surf())
    pk, sk = eng.keypair()
    rlk = eng.genrlk(sk)
    ck = eng.genck(sk)
    rk = eng.genrk(sk, bs.bootstrap_rotations(ctx))
    log(f"bootstrap(logn={logn}, logq={logq}, h=64, iter=9): keys ready "
        f"({time.time()-t0:.1f}s)")
    m0 = 0.1 * smp.sample_z01vec(eng.rng, ctx.slots)
    ct = eng.enc_pk(eng.ecd(m0), pk)
    # consume levels down to l=1 so the raise has work to do
    while ct.l > 1:
        ct = eng.moddown(ct)
    bctx = bs.BootstrapContext(eng)
    t1 = time.time()
    out = bs.bootstrap(eng, bctx, ct, rlk, ck, rk, iter=9)
    jax.block_until_ready((out.c0, out.c1))
    cold_s = time.time() - t1
    got = eng.dcd(eng.dec(out, sk))
    diff = float(np.max(np.abs(got - m0)))
    log(f"bootstrap cold (compiles included): {cold_s:.1f}s, diff {diff:.2e}")
    assert diff < 1e-2, f"bootstrap decode diff {diff} exceeds 1e-2"
    assert out.l >= min_l, f"bootstrap landed too low (l={out.l})"
    ts = []
    for _ in range(3):
        t1 = time.time()
        out = bs.bootstrap(eng, bctx, ct, rlk, ck, rk, iter=9)
        jax.block_until_ready((out.c0, out.c1))
        ts.append(time.time() - t1)
    warm_s = sorted(ts)[1]
    log(f"bootstrap warm: median {warm_s:.3f}s of {ts} (levels left: {out.l})")
    emit("bootstrap_s" if full else "bootstrap_logn9_s", round(warm_s, 3),
         "s", None)


def main() -> int:
    if len(sys.argv) >= 3 and sys.argv[1] == "--stage":
        {"ntt": stage_ntt, "scheme": stage_scheme,
         "bootstrap": stage_bootstrap}[sys.argv[2]]()
        return 0
    return orchestrate()


if __name__ == "__main__":
    sys.exit(main())
