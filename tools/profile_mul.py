#!/usr/bin/env python
"""Stage-by-stage attribution of the mult+rescale latency on the default device.

The fused he_mul program is ONE XLA program; to attribute its time this tool
rebuilds each pipeline stage as its own jitted program with the real shapes
and times them separately (warm), then times the fused program for reference.

Usage: python tools/profile_mul.py [logn] [logq] [impl]
Prints a table: stage | ms | % of fused.
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
    impl = sys.argv[3] if len(sys.argv) > 3 else "butterfly"
    t0 = time.time()
    from gpqhe_jax.context import HeContext
    from gpqhe_jax.ops import limbs as lb
    from gpqhe_jax.ops import rns as rns_ops
    from gpqhe_jax.ops.modmath import addmod, mulmod
    from gpqhe_jax.ring import sample as smp
    from gpqhe_jax.scheme.engine import CKKS
    from gpqhe_jax.substrate.surf import Surf

    ctx = HeContext(logn=logn, q=1 << logq, slots=16, Delta=1 << 50)
    eng = CKKS(ctx, rng=Surf(), ntt_impl=impl)
    l = ctx.L
    qb, klv = eng.qbits(l), eng.kl(l)
    dim_m, dim_s = ctx.dim_mul(l), ctx.dim_swk(l)
    n = ctx.poly.n
    print(f"[{time.time()-t0:.0f}s] impl={impl} logn={logn} logq={logq} "
          f"dim_m={dim_m} dim_s={dim_s} klv={klv} kq={eng.kq} "
          f"dev={jax.devices()[0]}", flush=True)

    pk, sk = eng.keypair()
    rlk = eng.genrlk(sk)
    m = smp.sample_z01vec(eng.rng, ctx.slots)
    ct1 = eng.enc_pk(eng.ecd(m), pk)
    ct2 = eng.enc_pk(eng.ecd(m * 0.5), pk)
    print(f"[{time.time()-t0:.0f}s] keys+cts ready", flush=True)

    ring = eng.ring
    ring.prepare(dim_m)
    ring.prepare(dim_s)
    bam, plm = ring.ba(dim_m), ring.recon(dim_m)
    bas, pls = ring.ba(dim_s), ring.recon(dim_s)
    ba8, pl8 = ring.ba(ctx.dim), ring.recon(ctx.dim)
    r2m = jnp.array(ctx.poly.basis(dim_m).r2)
    r2s = jnp.array(ctx.poly.basis(dim_s).r2)
    wm = ring.weights(dim_m, klv)
    ws = ring.weights(dim_s, klv)

    stages = {}

    # A1: decompose x4
    dec4 = jax.jit(lambda a, b, c, d: jnp.stack(
        [rns_ops.decompose(x, bam, wm) for x in (a, b, c, d)]))
    args4 = (ct1.c0, ct1.c1, ct2.c0, ct2.c1)
    stages["A1 decompose x4 (dim_m)"] = timeit(dec4, args4)
    res4 = dec4(*args4)

    # A2: forward NTT fold-4
    ntt4f = jax.jit(lambda r: ring.ntt_f(r, dim_m))
    stages["A2 fwd NTT x4 (dim_m)"] = timeit(ntt4f, (res4,))
    hat4 = ntt4f(res4)

    # A3: pointwise cross terms
    def cross(h):
        x0, x1, y0, y1 = h
        pm, pvm = bam.ps[:, None], bam.pinv[:, None]
        d0 = mulmod(x0, y0, pm, pvm, r2m[:, None])
        d2 = mulmod(x1, y1, pm, pvm, r2m[:, None])
        d1 = addmod(mulmod(x0, y1, pm, pvm, r2m[:, None]),
                    mulmod(x1, y0, pm, pvm, r2m[:, None]), pm)
        return jnp.stack([d0, d1, d2])
    crossj = jax.jit(cross)
    stages["A3 pointwise x4+add"] = timeit(crossj, (hat4,))
    dh = crossj(hat4)

    # A4: inverse NTT fold-3
    intt3 = jax.jit(lambda r: ring.ntt_i(r, dim_m))
    stages["A4 inv NTT x3 (dim_m)"] = timeit(intt3, (dh,))
    res3 = intt3(dh)

    # A5: CRT reconstruct x3 + mask
    rec3 = jax.jit(lambda r: jnp.stack([
        lb.resize(lb.mask_bits(
            rns_ops.reconstruct(r[i], bam, plm, center=True,
                                k_out=klv, bound_bits=ctx.bits_mul(l)), qb), klv)
        for i in range(3)]))
    stages["A5 CRT reconstruct x3"] = timeit(rec3, (res3,))
    d012 = rec3(res3)

    # B1: decompose+NTT d2 over dim_s
    d2l = d012[2]
    decs = jax.jit(lambda x: ring.ntt_f(rns_ops.decompose(x, bas, ws), dim_s))
    stages["B1 dec+NTT d2 (dim_s)"] = timeit(decs, (d2l,))
    d2hat = decs(d2l)

    # B2: x evk both halves
    muls = jax.jit(lambda h, e0, e1: jnp.stack(
        [mulmod(h, e0[:dim_s], bas.ps[:, None], bas.pinv[:, None], r2s[:, None]),
         mulmod(h, e1[:dim_s], bas.ps[:, None], bas.pinv[:, None], r2s[:, None])]))
    stages["B2 x evk (2 halves)"] = timeit(muls, (d2hat, rlk.p0hat, rlk.p1hat))
    uh = muls(d2hat, rlk.p0hat, rlk.p1hat)

    # B3: inverse NTT fold-2 (dim_s)
    intt2 = jax.jit(lambda r: ring.ntt_i(r, dim_s))
    stages["B3 inv NTT x2 (dim_s)"] = timeit(intt2, (uh,))
    resu = intt2(uh)

    # B4: divide-round by P (2x: recon_s + recon_8 + mulconst + round)
    pinv16 = eng.pinv16
    p_half_up = jnp.asarray(eng.p_half_up)

    def ksp(res):
        outs = []
        for i in range(2):
            c = rns_ops.reconstruct(res[i], bas, pls, center=True,
                                    k_out=eng.kq, bound_bits=ctx.bits_swk(l))
            r = rns_ops.reconstruct(res[i][:ctx.dim], ba8, pl8, center=False,
                                    k_out=pl8.ks)
            u = lb.mul_const_mod2k(lb.sub(lb.resize(c, eng.kq),
                                          lb.resize(r, eng.kq)), pinv16, eng.kq)
            rb = lb.geq_const(lb.resize(r, eng.rk8), p_half_up)
            u = lb.add_scalar_bit(u, rb.astype(jnp.uint32))
            outs.append(lb.resize(lb.mask_bits(u, qb), klv))
        return jnp.stack(outs)
    kspj = jax.jit(ksp)
    stages["B4 divide-round x2"] = timeit(kspj, (resu,))
    u01 = kspj(resu)

    # B5: final adds + rescale
    logD = ctx.p.bit_length() - 1
    qbn, kln = eng.qbits(l - 1), eng.kl(l - 1)

    def fin(u, d):
        c0 = lb.mask_bits(lb.add(u[0], d[0]), qb)
        c1 = lb.mask_bits(lb.add(u[1], d[1]), qb)
        rs1 = lambda x: lb.resize(lb.mask_bits(lb.rshift_round(x, logD), qbn), kln)
        return rs1(c0), rs1(c1)
    finj = jax.jit(fin)
    stages["B5 adds + rescale"] = timeit(finj, (u01, d012))

    # fused reference
    fused = eng.mul_step_fn(l)
    args = (ct1.c0, ct1.c1, ct2.c0, ct2.c1, rlk.p0hat, rlk.p1hat)
    t_fused = timeit(fused, args)
    from gpqhe_jax.scheme.types import Ciphertext
    t_mulrs = timeit(
        lambda *a: eng.mul_rs(Ciphertext(l=l, nu=1.0, B=0.0, c0=a[0], c1=a[1]),
                              Ciphertext(l=l, nu=1.0, B=0.0, c0=a[2], c1=a[3]),
                              rlk).c0, args[:4])

    total = sum(stages.values())
    print(f"\n{'stage':<28} {'ms':>8} {'% of sum':>9}")
    for k, v in stages.items():
        print(f"{k:<28} {v*1e3:>8.2f} {v/total*100:>8.1f}%")
    print(f"{'SUM of stages':<28} {total*1e3:>8.2f}")
    print(f"{'fused he_mul (one program)':<28} {t_fused*1e3:>8.2f}")
    print(f"{'fused mul_rs':<28} {t_mulrs*1e3:>8.2f}")
    print(f"[{time.time()-t0:.0f}s] done", flush=True)


if __name__ == "__main__":
    main()
