"""Substrate KATs: surf RNG byte-exactness, FIPS-202 vs hashlib, limb codecs."""

import hashlib

import pytest

import numpy as np
import pytest

from gpqhe_jax.substrate import bigint, fips202, surf

# Expected bytes produced by the reference rng.c compiled with -DSUPERCOP
# (ref: src/rng.c:32-78), chunks of 13/64/13/64 bytes.
SURF_KAT = [
    "934d60b35624d740b30a7f227a",
    "f2ae7c678e4e04e13c5f509eade2b79aea77e23e2a2ea6c9c476fc4937b013c9"
    "93a793d6c0ab9960695ba838f649da539ca3d0bac5ba881dd35c597196700046",
    "92d675b83c98db6a0e55800baf",
    "eb7e70491bf40fdbb1169f785669a406103336a4a1d93ffa24269970f51601db"
    "5338ad82d46dc7300e2d894b0eaa40a6ab254506d8c1176a33c4a1b2879604b1",
]


def test_surf_kat():
    s = surf.Surf()
    for chunk, expect in enumerate(SURF_KAT):
        ln = 64 if chunk % 2 else 13
        assert bytes(s.randombytes(ln)).hex() == expect


def test_surf_buffering_invariance():
    """Stream must not depend on read chunking (C consumes byte-at-a-time)."""
    a = surf.Surf()
    b = surf.Surf()
    whole = bytes(a.randombytes(1000))
    parts = b"".join(bytes(b.randombytes(k)) for k in [1, 7, 64, 128, 300, 500])
    assert whole == parts


@pytest.mark.parametrize("msg", [b"", b"abc", b"x" * 200, bytes(range(137))])
def test_fips202_vs_hashlib(msg):
    assert fips202.shake128(64, msg) == hashlib.shake_128(msg).digest(64)
    assert fips202.shake256(64, msg) == hashlib.shake_256(msg).digest(64)
    assert fips202.sha3_256(msg) == hashlib.sha3_256(msg).digest()
    assert fips202.sha3_512(msg) == hashlib.sha3_512(msg).digest()


def test_sponge_incremental():
    sp = fips202.KeccakSponge(fips202.SHAKE128_RATE, 0x1F)
    sp.absorb(b"a" * 100)
    sp.absorb(b"b" * 100)
    assert sp.squeeze(32) == hashlib.shake_128(b"a" * 100 + b"b" * 100).digest(32)


def test_bigint_roundtrip():
    import random
    random.seed(0)
    vals = [random.getrandbits(400) - (1 << 399) for _ in range(50)]
    limbs = bigint.ints_to_limbs(vals, 13)
    back = bigint.limbs_to_signed_ints(limbs)
    assert back == [v for v in vals]
    nn = [abs(v) for v in vals]
    limbs2 = bigint.ints_to_limbs(nn, 13)
    assert bigint.limbs_to_ints(limbs2) == nn
    one = bigint.int_to_limbs(nn[0], 13)
    assert bigint.limbs_to_int(one) == nn[0]
    d = bigint.digits16(nn[0], 26)
    assert sum(int(x) << (16 * i) for i, x in enumerate(d)) == nn[0] & ((1 << 416) - 1)


def test_native_substrate_matches_numpy():
    """The C substrate (built on demand) must be byte-identical to the numpy
    oracle; skip cleanly when no compiler is available.

    The expected stream is built from the numpy _surf_batch directly (NOT
    Surf.randombytes, which itself routes through the C lib when present) so
    the SIMD surf_batch path — all 32 lanes, the batch boundary and the
    scalar tail — has an independent in-suite oracle (advisor r4)."""
    import numpy as np

    from gpqhe_jax.substrate import native as nat

    if nat.get_lib() is None:
        pytest.skip("no C compiler")
    # 2*SURF_W+1 = 65 blocks: two full SIMD batches plus a scalar-tail block
    nblocks = 2 * 32 + 1
    out = nat.surf_blocks(surf._SEED_DEFAULT, 0, nblocks)
    idx = 1 + np.arange(nblocks, dtype=np.uint64)   # C increments first
    ctr = np.zeros((4, nblocks), dtype=np.uint32)
    for i in range(4):
        ctr[i] = ((idx >> np.uint64(32 * i)) & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    want = surf._surf_batch(ctr, surf._SEED_DEFAULT).reshape(-1)
    assert bytes(out) == bytes(want)
    # and at a counter start that straddles the u32 lane boundary
    big = (1 << 32) - 3
    out2 = nat.surf_blocks(surf._SEED_DEFAULT, big, 40)
    idx2 = big + 1 + np.arange(40, dtype=np.uint64)
    ctr2 = np.zeros((4, 40), dtype=np.uint32)
    for i in range(4):
        ctr2[i] = ((idx2 >> np.uint64(32 * i)) & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    want2 = surf._surf_batch(ctr2, surf._SEED_DEFAULT).reshape(-1)
    assert bytes(out2) == bytes(want2)
    for msg in [b"", b"abc", b"q" * 300]:
        assert nat.shake(168, 0x1F, msg, 64) == hashlib.shake_128(msg).digest(64)
        assert nat.shake(136, 0x06, msg, 32) == hashlib.sha3_256(msg).digest()


def test_op_trace():
    """Per-op tracing counts jitted program invocations (SURVEY.md §5:
    the libpmu-role instrumentation)."""
    import numpy as np

    from gpqhe_jax.context import HeContext
    from gpqhe_jax.ring import sample as smp
    from gpqhe_jax.scheme.engine import CKKS
    from gpqhe_jax.substrate.surf import Surf
    from gpqhe_jax.utils import trace

    ctx = HeContext(logn=5, q=1 << 100, slots=4, Delta=1 << 30)
    eng = CKKS(ctx, rng=Surf())
    pk, sk = eng.keypair()
    rlk = eng.genrlk(sk)
    m = smp.sample_z01vec(eng.rng, 4)
    ct = eng.enc_pk(eng.ecd(m), pk)
    with trace.op_trace() as t:
        out = eng.rs(eng.mul(ct, ct, rlk))
    assert t.counts.get("he_mul") == 1
    assert t.counts.get("rs") == 2  # c0 and c1 run the same cached program
    rep = t.report()
    assert "he_mul" in rep and "ms/call" in rep
    # inactive -> untouched callables, and results still correct
    got = eng.dcd(eng.dec(out, sk))
    assert np.max(np.abs(got - m * m)) < 1e-5
