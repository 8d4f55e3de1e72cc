#!/usr/bin/env python
"""Classic vs double-hoisted BSGS gemv latency on the default device.

Usage: python tools/bench_gemv.py [logn] [logq] [slots]
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

jax.config.update("jax_enable_x64", True)

import numpy as np


def main():
    logn = int(sys.argv[1]) if len(sys.argv) > 1 else 12
    logq = int(sys.argv[2]) if len(sys.argv) > 2 else 109
    slots = int(sys.argv[3]) if len(sys.argv) > 3 else 4
    t0 = time.time()
    from gpqhe_jax.algo import linalg
    from gpqhe_jax.context import HeContext
    from gpqhe_jax.ring import sample as smp
    from gpqhe_jax.scheme.engine import CKKS
    from gpqhe_jax.substrate.surf import Surf

    ctx = HeContext(logn=logn, q=1 << logq, slots=slots, Delta=1 << 30)
    eng = CKKS(ctx, rng=Surf())
    print(f"[{time.time()-t0:.0f}s] ctx logn={logn} logq={logq} slots={slots} "
          f"dimswk={ctx.dimswk} dimswk_h={eng.dimswk_h} on {jax.devices()[0]}",
          flush=True)
    pk, sk = eng.keypair()
    rk = eng.genrk(sk)
    print(f"[{time.time()-t0:.0f}s] keys", flush=True)
    rng = np.random.default_rng(0)
    A = (rng.standard_normal(slots * slots)
         + 1j * rng.standard_normal(slots * slots)) * 0.3
    m = smp.sample_z01vec(eng.rng, slots)
    ct = eng.enc_pk(eng.ecd(m), pk)
    ref = A.reshape(slots, slots) @ m

    plan_c = linalg.GemvPlan(eng, A)
    plan_h = linalg.HoistedGemvPlan(eng, A)

    for name, call in (
        ("classic", lambda: linalg.gemv(eng, A, ct, rk, plan=plan_c)),
        ("hoisted", lambda: linalg.gemv(eng, A, ct, rk, plan=plan_h,
                                        hoisted=True)),
    ):
        for _ in range(2):  # compile + warm (some programs compile on call 2)
            out = call()
        out.c0.block_until_ready()
        t1 = time.time()
        iters = 5
        for _ in range(iters):
            out = call()
        out.c0.block_until_ready()
        dt = (time.time() - t1) / iters
        err = np.max(np.abs(eng.dcd(eng.dec(out, sk)) - ref))
        print(f"{name}: {dt*1e3:.2f} ms/gemv  (err {err:.2e}) "
              f"[{time.time()-t0:.0f}s]", flush=True)


if __name__ == "__main__":
    main()
