#!/usr/bin/env python
"""Stage attribution of the double-hoisted BSGS gemv (VERDICT r4 #8).

At slots=16 the hoisted gemv (algo/linalg.py gemv_hoisted) is:
  prep (dec+NTT c0/c1 once, all n1 Galois perms as one gather)
  n2=4 x giant step (lax.scan over n1=4 baby steps + ONE divide-round)
  3 x outer rot (full key switch)  +  3 x add  +  1 x rs
This times each jitted piece warm and checks the sum against the composed
latency, so the headline gemv latency is attributed (ref: src/he-algo.c:47-93 —
the reference does a FULL key switch per baby step instead).

Usage: python tools/profile_gemv.py [logn] [logq] [slots]
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

jax.config.update("jax_enable_x64", True)

import numpy as np


def timeit(fn, iters=10, warmup=2):
    for _ in range(warmup):
        out = fn()
    jax.block_until_ready(out)
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        for _ in range(iters):
            out = fn()
        jax.block_until_ready(out)
        best = min(best, (time.perf_counter() - t0) / iters)
    return best


def main():
    logn = int(sys.argv[1]) if len(sys.argv) > 1 else 14
    logq = int(sys.argv[2]) if len(sys.argv) > 2 else 438
    slots = int(sys.argv[3]) if len(sys.argv) > 3 else 16
    t0 = time.time()
    from gpqhe_jax.algo.linalg import HoistedGemvPlan, gemv
    from gpqhe_jax.context import HeContext
    from gpqhe_jax.ring import sample as smp
    from gpqhe_jax.scheme.engine import CKKS
    from gpqhe_jax.substrate.surf import Surf
    from gpqhe_jax.utils.xla import enable_persistent_cache
    enable_persistent_cache()

    ctx = HeContext(logn=logn, q=1 << logq, slots=slots, Delta=1 << 50)
    eng = CKKS(ctx, rng=Surf())
    pk, sk = eng.keypair()
    rk = eng.genrk(sk)
    m1 = smp.sample_z01vec(eng.rng, ctx.slots)
    ct = eng.enc_pk(eng.ecd(m1), pk)
    rng_np = np.random.default_rng(1)
    A = (rng_np.standard_normal(slots * slots)
         + 1j * rng_np.standard_normal(slots * slots))
    plan = HoistedGemvPlan(eng, A)
    out = gemv(eng, None, ct, rk, plan=plan, hoisted=True)   # compile+warm
    jax.block_until_ready((out.c0, out.c1))
    assert plan.fallbacks == 0
    l = ct.l
    dims_h, dimc, nu_max = plan.dims(eng, l)
    bnd_sum = plan.bound_max() * plan.n1
    print(f"[{time.time()-t0:.0f}s] logn={logn} logq={logq} slots={slots} "
          f"n1={plan.n1} n2={plan.n2} dims_h={dims_h} dimc={dimc} "
          f"dev={jax.devices()[0]}", flush=True)

    prep = eng.hoisted_gemv_prep_fn(l, plan.n1, dims_h, dimc)
    step = eng.hoisted_gemv_step_fn(l, dims_h, dimc,
                                    bits_h=eng.bits_hoist(l, bnd_sum),
                                    bits_c=eng.ctx.bits_mulpt(l, bnd_sum))
    rk0, rk1 = plan.rk_stack(rk)
    c1p, c0p = prep(ct.c0, ct.c1)
    ptx, ptb = plan.pack_slab(eng, l, 0)
    s0, s1 = step(c1p, c0p, ptx, ptb, rk0, rk1)
    from gpqhe_jax.scheme.types import Ciphertext
    inner = Ciphertext(l=l, nu=1.0, B=1.0, c0=s0, c1=s1)

    rows = [
        ("prep (dec+NTT once + perms)", timeit(lambda: prep(ct.c0, ct.c1)[0])),
        ("giant step (scan n1 + 1 ks)", timeit(
            lambda: step(c1p, c0p, ptx, ptb, rk0, rk1)[0])),
        ("outer rot (full ks)", timeit(lambda: eng.rot(inner, plan.n1, rk).c0)),
        ("add", timeit(lambda: eng.add(inner, inner).c0)),
        ("rs", timeit(lambda: eng.rs(inner).c0)),
    ]
    total = (rows[0][1] + plan.n2 * rows[1][1] + (plan.n2 - 1) * rows[2][1]
             + (plan.n2 - 1) * rows[3][1] + rows[4][1])
    composed = timeit(lambda: gemv(eng, None, ct, rk, plan=plan,
                                   hoisted=True).c0)
    print(f"\n{'stage':<30} {'ms':>8} {'x count':>8} {'total ms':>9}")
    counts = [1, plan.n2, plan.n2 - 1, plan.n2 - 1, 1]
    for (name, sec), cnt in zip(rows, counts):
        print(f"{name:<30} {sec*1e3:>8.2f} {cnt:>8} {sec*cnt*1e3:>9.2f}")
    print(f"{'SUM of stages (BSGS pieces)':<30} {'':>8} {'':>8} {total*1e3:>9.2f}")
    print(f"{'composed gemv (full-hoist)':<30} {'':>8} {'':>8} {composed*1e3:>9.2f}")
    print(f"[{time.time()-t0:.0f}s] done", flush=True)


if __name__ == "__main__":
    main()
