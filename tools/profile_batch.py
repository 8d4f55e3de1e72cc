#!/usr/bin/env python
"""Stage-by-stage attribution of the BATCHED mul_rs program.

For each pipeline stage of mul_rs_batch_fn (engine.py), times the stage as
its own jitted program at batch B and at B=1, and prints the per-ct scaling
factor (ideal: <= 1.0x per ct; a stage whose per-ct time GROWS with B does
not amortize).

Usage: python tools/profile_batch.py [logn] [logq] [B] [impl]
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp
import numpy as np


def timeit(fn, args, iters=10, warmup=2):
    for _ in range(warmup):
        out = fn(*args)
    jax.block_until_ready(out)
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*args)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / iters


def main():
    logn = int(sys.argv[1]) if len(sys.argv) > 1 else 14
    logq = int(sys.argv[2]) if len(sys.argv) > 2 else 438
    B = int(sys.argv[3]) if len(sys.argv) > 3 else 8
    impl = sys.argv[4] if len(sys.argv) > 4 else "butterfly"
    t0 = time.time()
    from gpqhe_jax.context import HeContext
    from gpqhe_jax.ops import limbs as lb
    from gpqhe_jax.ops import rns as rns_ops
    from gpqhe_jax.ops.modmath import addmod, mulmod
    from gpqhe_jax.scheme.engine import CKKS
    from gpqhe_jax.substrate.surf import Surf
    from gpqhe_jax.utils.xla import enable_persistent_cache
    enable_persistent_cache()

    ctx = HeContext(logn=logn, q=1 << logq, slots=16, Delta=1 << 50)
    eng = CKKS(ctx, rng=Surf(), ntt_impl=impl)
    l = ctx.L
    qb, klv = eng.qbits(l), eng.kl(l)
    dim_m, dim_s = ctx.dim_mul(l), ctx.dim_swk(l)
    n = ctx.poly.n
    print(f"[{time.time()-t0:.0f}s] impl={impl} logn={logn} logq={logq} B={B} "
          f"dim_m={dim_m} dim_s={dim_s} klv={klv} dev={jax.devices()[0]}",
          flush=True)

    ring = eng.ring
    ring.prepare(dim_m)
    ring.prepare(dim_s)
    bam, plm = ring.ba(dim_m), ring.recon(dim_m)
    bas, pls = ring.ba(dim_s), ring.recon(dim_s)
    r2m = jnp.array(ctx.poly.basis(dim_m).r2)
    r2s = jnp.array(ctx.poly.basis(dim_s).r2)
    wm = ring.weights(dim_m, klv)
    ws = ring.weights(dim_s, klv)

    rng = np.random.default_rng(0)
    ct = jnp.asarray(rng.integers(0, 2**32, (B, n, klv), dtype=np.uint64)
                     .astype(np.uint32))
    ct1 = ct[0]

    rows = []

    def both(name, build1, buildB, args1, argsB, per_ct_scale=1.0):
        """Time a stage at B=1 and B; record per-ct ratio."""
        tB = timeit(buildB, argsB)
        t1 = timeit(build1, args1)
        rows.append((name, t1 * 1e3, tB * 1e3, tB / B / t1))
        print(f"  {name:<30} 1x {t1*1e3:7.2f} ms   {B}x {tB*1e3:7.2f} ms "
              f"-> per-ct {tB/B/t1:5.2f}x", flush=True)
        return None

    # S1: decompose x4 over dim_m
    dec1 = jax.jit(lambda a: jnp.stack([rns_ops.decompose(a, bam, wm)] * 4))
    decB = jax.jit(lambda a: jnp.stack(
        [rns_ops.decompose(a, bam, wm) for _ in range(4)]))
    both("S1 decompose x4 (dim_m)", dec1, decB, (ct1,), (ct,))

    # S2: forward NTT, fold 4 vs 4B
    res1 = jnp.asarray(rng.integers(0, 2**59, (4, dim_m, n), dtype=np.uint64))
    resB = jnp.asarray(rng.integers(0, 2**59, (4 * B, dim_m, n), dtype=np.uint64))
    f1 = jax.jit(lambda r: ring.ntt_f(r, dim_m))
    both("S2 fwd NTT (fold 4 vs 4B)", f1, f1, (res1,), (resB,))

    # S3: pointwise cross terms
    def cross(h):
        hh = h.reshape(4, -1, dim_m, n)
        x0, x1, y0, y1 = hh[0], hh[1], hh[2], hh[3]
        pm, pvm = bam.ps[:, None], bam.pinv[:, None]
        d0 = mulmod(x0, y0, pm, pvm, r2m[:, None])
        d2 = mulmod(x1, y1, pm, pvm, r2m[:, None])
        d1 = addmod(mulmod(x0, y1, pm, pvm, r2m[:, None]),
                    mulmod(x1, y0, pm, pvm, r2m[:, None]), pm)
        return jnp.stack([d0, d1, d2])
    crossj = jax.jit(cross)
    both("S3 pointwise cross", crossj, crossj, (res1,), (resB,))

    # S4: inverse NTT scaled, fold 3 vs 3B
    r31 = jnp.asarray(rng.integers(0, 2**59, (3, dim_m, n), dtype=np.uint64))
    r3B = jnp.asarray(rng.integers(0, 2**59, (3 * B, dim_m, n), dtype=np.uint64))
    i1 = jax.jit(lambda r: ring.ntt_i(r, dim_m, scale_phatinv=True))
    both("S4 inv NTT (fold 3 vs 3B)", i1, i1, (r31,), (r3B,))

    # S5: CRT reconstruct x3 over dim_m
    def rec(r):
        return jnp.stack([lb.resize(lb.mask_bits(
            rns_ops.reconstruct(r[i], bam, plm, center=True, k_out=klv,
                                bound_bits=ctx.bits_mul(l), pre_scaled=True),
            qb), klv) for i in range(3)])
    recj = jax.jit(rec)
    rec1_in = r31.reshape(3, 1, dim_m, n)[:, 0]
    recB_in = r3B.reshape(3, B, dim_m, n)
    both("S5 CRT reconstruct x3", recj, recj, (rec1_in,), (recB_in,))

    # S6: relin decompose+NTT over dim_s
    d2_1 = ct1
    d2_B = ct
    ds1 = jax.jit(lambda x: ring.ntt_f(rns_ops.decompose(x, bas, ws), dim_s))
    both("S6 dec+NTT d2 (dim_s)", ds1, ds1, (d2_1,), (d2_B,))

    # S7: x evk both halves + inverse NTT (2 vs 2B fold)
    pk_, sk_ = eng.keypair()
    rlk = eng.genrlk(sk_)
    h1 = jnp.asarray(rng.integers(0, 2**59, (dim_s, n), dtype=np.uint64))
    hB = jnp.asarray(rng.integers(0, 2**59, (B, dim_s, n), dtype=np.uint64))

    def ksmul(h, e0, e1):
        ps, pvs = bas.ps[:, None], bas.pinv[:, None]
        u0 = mulmod(h, e0[:dim_s], ps, pvs, r2s[:, None])
        u1 = mulmod(h, e1[:dim_s], ps, pvs, r2s[:, None])
        s = jnp.stack([u0, u1])
        if s.ndim == 4:
            s = s.reshape(2 * h.shape[0], dim_s, n)
        return ring.ntt_i(s, dim_s, scale_phatinv=True)
    ksj = jax.jit(ksmul)
    both("S7 x evk + inv NTT (dim_s)", ksj, ksj, (h1, rlk.p0hat, rlk.p1hat),
         (hB, rlk.p0hat, rlk.p1hat))

    # S8: divide-round x2 (the ks_post pair)
    ks_pair = eng._keyswitch_core(dim_s, l)
    u1 = jnp.asarray(rng.integers(0, 2**59, (dim_s, n), dtype=np.uint64))
    uB = jnp.asarray(rng.integers(0, 2**59, (B, dim_s, n), dtype=np.uint64))
    kpj = jax.jit(lambda a, b: ks_pair(a, b))
    both("S8 divide-round x2", kpj, kpj, (u1, u1), (uB, uB))

    # fused reference points
    fused_1 = eng.mul_rs_batch_fn(l, 1)
    fused_B = eng.mul_rs_batch_fn(l, B)
    ek = (rlk.p0hat, rlk.p1hat)
    c1 = ct[0:1]
    t1 = timeit(lambda: fused_1(c1, c1, c1, c1, *ek), ())
    tB = timeit(lambda: fused_B(ct, ct, ct, ct, *ek), ())
    print(f"  {'FUSED mul_rs_batch':<30} 1x {t1*1e3:7.2f} ms   {B}x "
          f"{tB*1e3:7.2f} ms -> per-ct {tB/B/t1:5.2f}x", flush=True)
    print(f"[{time.time()-t0:.0f}s] done", flush=True)


if __name__ == "__main__":
    main()
