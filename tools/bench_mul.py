#!/usr/bin/env python
"""Ciphertext mult+rescale latency on the default device.

Usage: python tools/bench_mul.py [logn] [logq] [butterfly|matmul] [logp]
Measures the warm per-call latency of the fused he_mul program and of
rescale at top level, plus NTT throughput context.
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

jax.config.update("jax_enable_x64", True)

import numpy as np


def log(*a):
    print(*a, flush=True)


def main():
    logn = int(sys.argv[1]) if len(sys.argv) > 1 else 14
    logq = int(sys.argv[2]) if len(sys.argv) > 2 else 438
    impl = sys.argv[3] if len(sys.argv) > 3 else "butterfly"
    logp = int(sys.argv[4]) if len(sys.argv) > 4 else 59
    t0 = time.time()
    from gpqhe_jax.context import HeContext
    from gpqhe_jax.ring import sample as smp
    from gpqhe_jax.scheme.engine import CKKS
    from gpqhe_jax.substrate.surf import Surf
    from gpqhe_jax.utils.pmu import time_jitted
    from gpqhe_jax.utils.xla import enable_persistent_cache
    enable_persistent_cache()

    ctx = HeContext(logn=logn, q=1 << logq, slots=16, Delta=1 << 50, logp=logp)
    eng = CKKS(ctx, rng=Surf(), ntt_impl=impl)
    log(f"[{time.time()-t0:.0f}s] ntt_impl={impl} logp={logp} ctx logn={logn} logq={logq} "
        f"dim_mul={ctx.dim_mul(ctx.L)} dim_swk={ctx.dim_swk(ctx.L)} "
        f"on {jax.devices()[0]}")
    pk, sk = eng.keypair()
    log(f"[{time.time()-t0:.0f}s] keypair")
    rlk = eng.genrlk(sk)
    log(f"[{time.time()-t0:.0f}s] rlk")
    m = smp.sample_z01vec(eng.rng, ctx.slots)
    ct1 = eng.enc_pk(eng.ecd(m), pk)
    ct2 = eng.enc_pk(eng.ecd(m * 0.5), pk)
    log(f"[{time.time()-t0:.0f}s] encrypted")

    mul_fn = eng.mul_step_fn(ctx.L)
    args = (ct1.c0, ct1.c1, ct2.c0, ct2.c1, rlk.p0hat, rlk.p1hat)
    sec = time_jitted(mul_fn, args, iters=10, warmup=2)
    log(f"he_mul (incl. relin) latency: {sec*1e3:.2f} ms")

    ctm = eng.mul(ct1, ct2, rlk)
    t = time_jitted(lambda c: eng.rs(
        type(ctm)(l=ctm.l, nu=ctm.nu, B=ctm.B, c0=c, c1=c)).c0, (ctm.c0,),
        iters=10, warmup=2)
    log(f"rescale latency: {t*1e3:.2f} ms")
    log(f"mult+rescale total: {(sec+t)*1e3:.2f} ms")

    # fused single-program mult+rescale
    for _ in range(2):
        ctf = eng.mul_rs(ct1, ct2, rlk)
    ctf.c0.block_until_ready()
    import time as _t
    t1 = _t.time()
    for _ in range(10):
        ctf = eng.mul_rs(ct1, ct2, rlk)
    ctf.c0.block_until_ready()
    log(f"fused mul_rs: {(_t.time()-t1)/10*1e3:.2f} ms")

    # correctness
    out = eng.dcd(eng.dec(eng.rs(ctm), sk))
    log(f"correctness: max diff {np.max(np.abs(out - m*m*0.5)):.3g}")
    outf = eng.dcd(eng.dec(ctf, sk))
    log(f"fused correctness: max diff {np.max(np.abs(outf - m*m*0.5)):.3g}")


if __name__ == "__main__":
    main()
