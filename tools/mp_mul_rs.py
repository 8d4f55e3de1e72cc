#!/usr/bin/env python
"""Two-process sharded mul_rs: the multi-host (DCN-shaped) evidence.

The reference is strictly single-process (SURVEY.md §2: "MPI" there means
multi-precision integer).  Here TWO OS processes each contribute 4 virtual
CPU devices; a jax.distributed (gloo) runtime joins them, one
(limb, coeff, batch) = (2, 2, 2) mesh spans BOTH processes, and the fused
mult+relin+rescale program (parallel/mesh.py build_sharded_mul_rs) executes
with its limb-axis psum and coeff-axis ppermute collectives crossing the
process boundary — the shape multi-host execution takes, with the local
socket in place of the host network.  Keys and ciphertexts move between the
processes through utils/serialize (the key/ct exchange format the reference
lacks entirely).

Process 0 additionally computes the single-device engine result and asserts
the globally-sharded output is BIT-EXACT against it.

Usage:
  one-shot launcher (spawns both ranks):   python tools/mp_mul_rs.py
  single rank (what the launcher spawns):  python tools/mp_mul_rs.py RANK \
      NPROC TMPDIR PORT
"""

import os
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOGN, LOGQ, SLOTS, LOGD = 6, 110, 4, 30
LOCAL_DEVICES = 4


def worker(rank: int, nproc: int, tmpdir: str, port: int) -> None:
    # env must be set BEFORE jax import (conftest-style CPU override)
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                               + f" --xla_force_host_platform_device_count={LOCAL_DEVICES}").strip()
    sys.path.insert(0, HERE)
    import jax
    jax.config.update("jax_enable_x64", True)
    jax.config.update("jax_cpu_collectives_implementation", "gloo")
    jax.distributed.initialize(coordinator_address=f"127.0.0.1:{port}",
                               num_processes=nproc, process_id=rank)
    from gpqhe_jax.utils.xla import enable_persistent_cache
    enable_persistent_cache()
    import numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P

    from gpqhe_jax.context import HeContext
    from gpqhe_jax.parallel.mesh import build_sharded_mul_rs, make_he_mesh3
    from gpqhe_jax.ring import sample as smp
    from gpqhe_jax.scheme.engine import CKKS
    from gpqhe_jax.substrate.surf import Surf
    from gpqhe_jax.utils import serialize

    assert len(jax.devices()) == nproc * LOCAL_DEVICES, \
        (len(jax.devices()), "global device enumeration failed")
    log = lambda *a: print(f"[rank {rank}]", *a, file=sys.stderr, flush=True)
    log(f"global devices: {len(jax.devices())} "
        f"(local {jax.local_device_count()})")

    ctx = HeContext(logn=LOGN, q=1 << LOGQ, slots=SLOTS, Delta=1 << LOGD)
    eng = CKKS(ctx, rng=Surf())
    marker = os.path.join(tmpdir, "ready")
    if rank == 0:
        # keygen + encrypt + the single-device reference result, then publish
        pk, sk = eng.keypair()
        rlk = eng.genrlk(sk)
        m1 = smp.sample_z01vec(eng.rng, ctx.slots)
        m2 = smp.sample_z01vec(eng.rng, ctx.slots)
        ct1 = eng.enc_pk(eng.ecd(m1), pk)
        ct2 = eng.enc_pk(eng.ecd(m2), pk)
        want = eng.mul_rs(ct1, ct2, rlk)
        for name, obj in [("ct1", ct1), ("ct2", ct2), ("rlk", rlk),
                          ("want", want)]:
            serialize.save(os.path.join(tmpdir, f"{name}.npz"), ctx, obj)
        with open(marker, "w") as fh:
            fh.write("ok")
        log("keys/cts serialized")
    else:
        while not os.path.exists(marker):
            time.sleep(0.2)
        time.sleep(0.2)  # let the writes land
    ct1 = serialize.load(os.path.join(tmpdir, "ct1.npz"), ctx)
    ct2 = serialize.load(os.path.join(tmpdir, "ct2.npz"), ctx)
    rlk = serialize.load(os.path.join(tmpdir, "rlk.npz"), ctx)
    want = serialize.load(os.path.join(tmpdir, "want.npz"), ctx)

    mesh = make_he_mesh3(nproc * LOCAL_DEVICES, limb=2, coeff=2)
    nprocs_in_mesh = len({d.process_index for d in mesh.devices.flat})
    assert nprocs_in_mesh == nproc, "mesh does not span both processes"
    f = build_sharded_mul_rs(eng, ctx.L, mesh)

    B = mesh.shape["batch"]

    def replicated(x):
        x = np.asarray(x)
        sh = NamedSharding(mesh, P(*([None] * x.ndim)))
        return jax.make_array_from_callback(x.shape, sh, lambda idx: x[idx])

    def batched(x):
        x = np.stack([np.asarray(x)] * B)
        sh = NamedSharding(mesh, P("batch", "coeff", None))
        return jax.make_array_from_callback(x.shape, sh, lambda idx: x[idx])

    args = (batched(ct1.c0), batched(ct1.c1), batched(ct2.c0), batched(ct2.c1),
            replicated(rlk.p0hat), replicated(rlk.p1hat))
    c0, c1 = f(*args)
    jax.block_until_ready((c0, c1))
    log("sharded mul_rs executed over the 2-process mesh")

    # every process checks ITS addressable shards against the reference
    for out, ref in ((c0, np.asarray(want.c0)), (c1, np.asarray(want.c1))):
        refb = np.stack([ref] * B)
        for shard in out.addressable_shards:
            got = np.asarray(shard.data)
            exp = refb[shard.index]
            assert np.array_equal(got, exp), \
                f"rank {rank} shard {shard.index} mismatch"
    with open(os.path.join(tmpdir, f"ok{rank}"), "w") as fh:
        fh.write("bit-exact")
    log("bit-exact vs single-device engine")
    jax.distributed.shutdown()


def launch() -> int:
    port = int(os.environ.get("MP_PORT", 9921))
    nproc = 2
    with tempfile.TemporaryDirectory() as tmpdir:
        procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), str(r), str(nproc),
             tmpdir, str(port)], cwd=HERE)
            for r in range(nproc)]
        rcs = [p.wait(timeout=600) for p in procs]
        ok = all(rc == 0 for rc in rcs) and \
            all(os.path.exists(os.path.join(tmpdir, f"ok{r}"))
                for r in range(nproc))
    print(f"mp_mul_rs: {'PASS (bit-exact across 2 processes)' if ok else 'FAIL'}"
          f" rcs={rcs}")
    return 0 if ok else 1


if __name__ == "__main__":
    if len(sys.argv) == 1:
        sys.exit(launch())
    worker(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], int(sys.argv[4]))
