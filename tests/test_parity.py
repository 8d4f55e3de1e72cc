"""Parity tests for the smaller reference components: RNG backends,
Kyber-style seeded samplers, canonical-embedding norms, kemctx sizes,
serialization, Barrett reduction, observability printers."""

import io
import random

import jax.numpy as jnp
import numpy as np
import pytest

from gpqhe_jax.context import HeContext, PolyContext
from gpqhe_jax.ops.modmath import barrett_inv, barrett_reduce, mulhilo64
from gpqhe_jax.ring import sample as smp
from gpqhe_jax.scheme.engine import CKKS
from gpqhe_jax.substrate.rng_backends import Aes256CtrDrbg, UrandomRng, \
    aes256_ecb_encrypt_block
from gpqhe_jax.substrate.surf import Surf
from gpqhe_jax.utils import info, serialize


def test_aes256_fips197_vector():
    key = bytes(range(32))
    pt = bytes.fromhex("00112233445566778899aabbccddeeff")
    assert aes256_ecb_encrypt_block(key, pt).hex() == \
        "8ea2b7ca516745bfeafc49904b496089"


def test_ctr_drbg_deterministic():
    d1 = Aes256CtrDrbg(bytes(range(48)))
    d2 = Aes256CtrDrbg(bytes(range(48)))
    a = bytes(d1.randombytes(40))
    assert a == bytes(d2.randombytes(40))
    assert a != bytes(d1.randombytes(40))  # stream advances
    # chunking must not change the stream (ref: src/rng.c:196-224 consumes
    # whole blocks then updates, so 16+24 == 40 only when aligned)
    d3 = Aes256CtrDrbg(bytes(range(48)), personalization=bytes(48))
    assert bytes(d3.randombytes(40)) == a  # zero personalization is identity


def test_urandom_backend():
    r = UrandomRng()
    a = r.randombytes(64)
    assert a.shape == (64,) and a.dtype == np.uint8


def test_poly_uniform_rejection():
    q = 3329
    out = smp.poly_uniform(256, bytes(32), q)
    assert out.shape == (256,)
    assert np.all(out < 5 * q)
    # deterministic per seed
    assert np.array_equal(out, smp.poly_uniform(256, bytes(32), q))
    assert not np.array_equal(out, smp.poly_uniform(256, b"\x01" * 32, q))


def test_poly_sample_cbd():
    out = smp.poly_sample(256, bytes(32), nonce=0)
    assert out.shape == (256,)
    assert np.all(np.abs(out) <= 8)
    assert np.array_equal(out, smp.poly_sample(256, bytes(32), nonce=0))
    assert not np.array_equal(out, smp.poly_sample(256, bytes(32), nonce=1))


def test_barrett_matches_mod():
    random.seed(11)
    pctx = PolyContext(5, q=1 << 20, dim_cap=2)
    for p in pctx.primes[:2]:
        qinv = barrett_inv(p)
        qbits = p.bit_length()
        a = np.array([random.randrange(p) for _ in range(32)], dtype=np.uint64)
        b = np.array([random.randrange(p) for _ in range(32)], dtype=np.uint64)
        hi, lo = mulhilo64(jnp.asarray(a), jnp.asarray(b))
        got = barrett_reduce(hi, lo, jnp.uint64(p), jnp.uint64(qinv), qbits)
        exp = [(int(x) * int(y)) % p for x, y in zip(a, b)]
        assert [int(v) for v in np.asarray(got)] == exp


@pytest.fixture(scope="module")
def small_eng():
    ctx = HeContext(logn=10, q=1 << 27, slots=4, Delta=1 << 21)
    return CKKS(ctx, rng=Surf())


def test_canemb_norm(small_eng):
    eng = small_eng
    m = smp.sample_z01vec(eng.rng, eng.ctx.slots)
    norm_m = eng.canemb_norm(m)
    pt = eng.ecd(m)
    norm_pt = eng.canemb_norm_pt(pt)
    # encoding then measuring must agree with measuring directly (within
    # rounding); both roughly max|m| * Delta
    assert norm_pt == pytest.approx(norm_m, rel=1e-6)
    assert norm_m <= eng.ctx.Delta * 2  # messages in [0,1)+i[0,1)


def test_kemctx_sizes(small_eng):
    k = small_eng.ctx.kemctx()
    n = small_eng.ctx.poly.n
    assert k["polybytes"] == (small_eng.ctx.poly.logq + 1) * n // 8
    assert k["pkbytes"] == k["polybytes"] + 32
    assert k["ssbytes"] == 4 * (n // 2) * 16


def test_serialize_roundtrip(tmp_path, small_eng):
    eng = small_eng
    pk, sk = eng.keypair()
    m = smp.sample_z01vec(eng.rng, eng.ctx.slots)
    ct = eng.enc_pk(eng.ecd(m), pk)
    p = str(tmp_path / "ct.npz")
    serialize.save(p, eng.ctx, ct)
    ct2 = serialize.load(p, eng.ctx)
    assert ct2.l == ct.l and ct2.nu == ct.nu
    assert np.array_equal(np.asarray(ct2.c0), np.asarray(ct.c0))
    got = eng.dcd(eng.dec(ct2, sk))
    assert np.max(np.abs(got - m)) < 1e-3  # logn=10 Delta=2^21 noise floor
    # keys round-trip too
    p2 = str(tmp_path / "sk.npz")
    serialize.save(p2, eng.ctx, sk)
    sk2 = serialize.load(p2, eng.ctx)
    assert np.array_equal(np.asarray(sk2.s), np.asarray(sk.s))
    # context mismatch must be rejected
    other = HeContext(logn=10, q=1 << 27, slots=2, Delta=1 << 21)
    with pytest.raises(ValueError):
        serialize.load(p, other)


def test_info_printers(small_eng, capsys=None):
    eng = small_eng
    buf = io.StringIO()
    info.show_ctx_params(eng.ctx, out=lambda s: buf.write(s + "\n"))
    text = buf.getvalue()
    assert "moduli ladder" in text and "RNS primes" in text
    pk, sk = eng.keypair()
    ct = eng.enc_pk(eng.ecd(smp.sample_z01vec(eng.rng, 4)), pk)
    buf2 = io.StringIO()
    info.show_ct_params(eng.ctx, ct, "t", out=lambda s: buf2.write(s))
    assert "l=1" in buf2.getvalue() or "l=" in buf2.getvalue()
