#!/usr/bin/env python
"""Scaling-efficiency harness: sharded poly_mul throughput vs device count.

On the virtual CPU mesh this is a functional scaling check (collective
counts, shapes); on a multi-GPU host the same harness measures scaling over
the real interconnect.  Usage:

    XLA_FLAGS=--xla_force_host_platform_device_count=8 JAX_PLATFORMS=cpu \
        python tools/bench_scaling.py [logn] [dim] [batch_per_dev]
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

jax.config.update("jax_enable_x64", True)

import numpy as np


def main():
    logn = int(sys.argv[1]) if len(sys.argv) > 1 else 10
    dim = int(sys.argv[2]) if len(sys.argv) > 2 else 4
    bpd = int(sys.argv[3]) if len(sys.argv) > 3 else 2
    import jax.numpy as jnp

    from gpqhe_jax.context import PolyContext
    from gpqhe_jax.parallel.mesh import build_sharded_poly_mul_3d, make_he_mesh3

    ndev_all = len(jax.devices())
    n = 1 << logn
    K = 4
    pctx = PolyContext(logn, q=1 << 100, dim_cap=dim)
    rng = np.random.default_rng(0)
    results = {}
    ndevs = [d for d in (1, 2, 4, 8, 16) if d <= ndev_all]
    for nd in ndevs:
        limb = 2 if nd >= 2 and dim % 2 == 0 else 1
        coeff = 2 if nd >= 4 else 1
        batch = nd // (limb * coeff)
        mesh = make_he_mesh3(nd, limb=limb, coeff=coeff)
        B = bpd * batch
        f = build_sharded_poly_mul_3d(pctx, dim, K, 32 * K, K, mesh)
        a = jnp.asarray(rng.integers(0, 1 << 31, (B, n, K)), dtype=jnp.uint32)
        b = jnp.asarray(rng.integers(0, 1 << 31, (B, n, K)), dtype=jnp.uint32)
        out = f(a, b)
        out.block_until_ready()
        iters = 10
        t0 = time.time()
        for _ in range(iters):
            out = f(a, out[..., :K])
        out.block_until_ready()
        dt = (time.time() - t0) / iters
        thr = B / dt
        results[nd] = thr
        eff = thr / (results[1] * nd) * 100 if 1 in results else float("nan")
        print(f"devices={nd:2d} mesh=(limb={limb},coeff={coeff},batch={batch}) "
              f"B={B}: {thr:8.1f} polymul/s  efficiency {eff:5.1f}%", flush=True)


if __name__ == "__main__":
    main()
