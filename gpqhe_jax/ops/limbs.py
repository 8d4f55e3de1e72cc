"""Device big-integer arithmetic on u32-limb tensors.

The MPI domain of the reference (libgcrypt big ints, ref: src/types.h:47)
becomes fixed-width little-endian u32-limb tensors [..., K] here.  Values are
nonnegative representatives mod 2**(32K); signed intermediates use two's
complement in that width.  Static limb counts keep every op jit-compilable.

All functions take/return u32 arrays; internal arithmetic is u64.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

_M32 = jnp.uint64(0xFFFFFFFF)
_32 = jnp.uint64(32)


def _u64(a):
    return a.astype(jnp.uint64)


def _shift_limb_axis(c):
    """Shift one position toward higher limbs (carry c_i lands on limb i+1)."""
    pad = [(0, 0)] * (c.ndim - 1) + [(1, 0)]
    return jnp.pad(c, pad)[..., :-1]


def _carry_prefix(g, p):
    """Kogge-Stone carry prefix: G_i = carry out of limbs [0..i] given
    generate g and propagate p flags (g & p never both true per limb)."""
    import jax

    def comb(left, right):
        gl, pl = left
        gr, pr = right
        return gr | (pr & gl), pl & pr

    G, _ = jax.lax.associative_scan(comb, (g, p), axis=-1)
    return G


def add(a, b):
    """(a + b) mod 2^(32K), log-depth carry-lookahead over the limb axis
    (the sequential ripple was 31-46 dependent steps at production widths)."""
    s = _u64(a) + _u64(b)
    low = s & _M32
    g = (s >> _32) != 0
    p = low == _M32
    carry_in = _shift_limb_axis(_carry_prefix(g, p)).astype(jnp.uint64)
    return ((low + carry_in) & _M32).astype(jnp.uint32)


def add_scalar_bit(a, bit):
    """a + bit (bit in {0,1} per row), mod 2^(32K); log-depth carry."""
    s0 = _u64(a[..., 0]) + _u64(bit)
    low = jnp.concatenate(
        [(s0 & _M32).astype(jnp.uint32)[..., None], a[..., 1:]], axis=-1)
    g0 = ((s0 >> _32) != 0)[..., None]
    g = jnp.concatenate(
        [g0, jnp.zeros(a.shape[:-1] + (a.shape[-1] - 1,), dtype=bool)], axis=-1)
    p = low == jnp.uint32(0xFFFFFFFF)
    carry_in = _shift_limb_axis(_carry_prefix(g, p & ~g)).astype(jnp.uint64)
    return ((_u64(low) + carry_in) & _M32).astype(jnp.uint32)


def sub(a, b):
    """(a - b) mod 2^(32K), log-depth borrow-lookahead: limb i generates a
    borrow when a_i < b_i and propagates an incoming one when a_i == b_i."""
    g = a < b
    p = a == b
    borrow_in = _shift_limb_axis(_carry_prefix(g, p)).astype(jnp.uint64)
    return ((_u64(a) - _u64(b) - borrow_in) & _M32).astype(jnp.uint32)


def neg(a):
    """-a mod 2^(32K)."""
    return add_scalar_bit(~a, jnp.ones(a.shape[:-1], dtype=jnp.uint32))


def select(mask, a, b):
    """Per-row select: mask ? a : b (mask shape = row shape)."""
    return jnp.where(mask[..., None], a, b)


def geq_const(a, c_limbs):
    """a >= c (c passed as u32[K] array or broadcastable limb tensor).

    Vectorized lexicographic compare: per-limb (gt - lt) signs weighted by
    limb significance and summed; the sign of the total is the comparison.
    One round is exact for <= 62 limbs (sum of 2^i stays inside i64); wider
    bases (logn=15/logq=881 key-switch reaches K=68) fold hierarchically —
    each round collapses chunks of <= 62 limb-signs into one exact chunk
    sign, so any K is exact in ceil(log_62 K) rounds."""
    c = c_limbs if c_limbs.ndim == a.ndim else jnp.broadcast_to(c_limbs, a.shape)
    sgn = (a > c).astype(jnp.int64) - (a < c).astype(jnp.int64)
    while sgn.shape[-1] > 1:
        m = min(62, sgn.shape[-1])
        pad = (-sgn.shape[-1]) % m
        if pad:  # zero signs at the high end: "equal" padding limbs
            sgn = jnp.concatenate(
                [sgn, jnp.zeros(sgn.shape[:-1] + (pad,), jnp.int64)], axis=-1)
        g = sgn.shape[-1] // m
        w = jnp.asarray(np.left_shift(np.int64(1), np.arange(m)))
        score = jnp.sum(sgn.reshape(sgn.shape[:-1] + (g, m)) * w, axis=-1)
        sgn = jnp.sign(score)
    return sgn[..., 0] >= 0


def mask_bits(a, nbits: int):
    """Keep the low nbits: a mod 2^nbits (static nbits)."""
    k = a.shape[-1]
    full = nbits // 32
    rem = nbits % 32
    pieces = []
    for i in range(k):
        if i < full:
            pieces.append(a[..., i])
        elif i == full and rem:
            pieces.append(a[..., i] & jnp.uint32((1 << rem) - 1))
        else:
            pieces.append(jnp.zeros_like(a[..., i]))
    return jnp.stack(pieces, axis=-1)


def rshift(a, t: int, k_out: int | None = None):
    """floor(a / 2^t) for nonnegative a (static t), output k_out limbs."""
    k = a.shape[-1]
    if k_out is None:
        k_out = k
    s, r = divmod(t, 32)
    outs = []
    for i in range(k_out):
        lo = a[..., i + s] if i + s < k else jnp.zeros_like(a[..., 0])
        if r == 0:
            outs.append(lo)
        else:
            hi = a[..., i + s + 1] if i + s + 1 < k else jnp.zeros_like(a[..., 0])
            outs.append((lo >> jnp.uint32(r)) | (hi << jnp.uint32(32 - r)))
    return jnp.stack(outs, axis=-1)


def rshift_round(a, t: int, k_out: int | None = None):
    """Round-to-nearest division by 2^t, remainder ties (== 2^(t-1)) round DOWN:
    floor(a/2^t) + [a mod 2^t > 2^(t-1)]  (ref: src/types.c:115-128 with m=2^t).
    a must be a nonnegative representative."""
    q = rshift(a, t, k_out)
    if t == 0:
        return q
    # frac > 2^(t-1)  <=>  bit t-1 set AND low t-1 bits nonzero
    hb_limb, hb_bit = divmod(t - 1, 32)
    topbit = (a[..., hb_limb] >> jnp.uint32(hb_bit)) & jnp.uint32(1)
    low_nonzero = jnp.zeros(a.shape[:-1], dtype=bool)
    for i in range(hb_limb + 1):
        if i < hb_limb:
            low_nonzero = low_nonzero | (a[..., i] != 0)
        elif hb_bit > 0:
            low_nonzero = low_nonzero | ((a[..., i] & jnp.uint32((1 << hb_bit) - 1)) != 0)
    round_up = (topbit == 1) & low_nonzero
    return add_scalar_bit(q, round_up.astype(jnp.uint32))


def sign_extend(a, k_out: int):
    """Two's-complement widen: replicate the top bit into new limbs."""
    k = a.shape[-1]
    if k_out <= k:
        return a[..., :k_out]
    top = ((a[..., k - 1] >> jnp.uint32(31)) & jnp.uint32(1)) * jnp.uint32(0xFFFFFFFF)
    ext = jnp.broadcast_to(top[..., None], a.shape[:-1] + (k_out - k,))
    return jnp.concatenate([a, ext], axis=-1)


def fit_signed(a, mask_to_bits: int, k_out: int):
    """Reduce a two's-complement value mod 2^mask_to_bits and emit k_out limbs.

    When widening past the source width the value must be SIGN-extended first
    (zero-extension corrupts negative values — the value mod 2^(32 k_out)
    changes); when narrowing, plain truncation is the correct mod."""
    src_bits = 32 * a.shape[-1]
    if mask_to_bits >= src_bits and k_out > a.shape[-1]:
        a = sign_extend(a, k_out)
    return resize(mask_bits(a, min(mask_to_bits, 32 * a.shape[-1])), k_out)


def resize(a, k_out: int):
    """Zero-extend or truncate to k_out limbs (value mod 2^(32 k_out))."""
    k = a.shape[-1]
    if k_out == k:
        return a
    if k_out < k:
        return a[..., :k_out]
    pad = [(0, 0)] * (a.ndim - 1) + [(0, k_out - k)]
    return jnp.pad(a, pad)


def to_digits16(a):
    """u32[..., K] -> u64[..., 2K] 16-bit digits."""
    lo = _u64(a) & jnp.uint64(0xFFFF)
    hi = _u64(a) >> jnp.uint64(16)
    return jnp.stack([lo, hi], axis=-1).reshape(a.shape[:-1] + (2 * a.shape[-1],))


def _shift_digit_axis(c):
    """Shift one position toward higher digits (carry c_i lands on digit i+1)."""
    pad = [(0, 0)] * (c.ndim - 1) + [(1, 0)]
    return jnp.pad(c, pad)[..., :-1]


def from_digits16(d, k_out: int):
    """u64[..., D] 16-bit digit sums (each < 2^48) -> u32[..., k_out] limbs,
    with carry propagation; value taken mod 2^(32 k_out).

    Carry propagation in LOG depth instead of a sequential scan over the
    digit axis: three parallel split-and-add rounds shrink every digit to
    <= 2^16 (bounds 2^48 -> 2^32+2^16 -> 2^17 -> 2^16), then the remaining
    0/1 ripple is resolved with a Kogge-Stone-style prefix over
    (generate, propagate) flags via lax.associative_scan.  Replaces a
    want-step lax.scan (62-92 sequential steps at production dims) with
    ~3 + log2(D) vectorized steps."""
    import jax

    ddim = d.shape[-1]
    want = 2 * k_out
    if ddim < want:
        pad = [(0, 0)] * (d.ndim - 1) + [(0, want - ddim)]
        d = jnp.pad(d, pad)
    elif ddim > want:
        d = d[..., :want]
    m16 = jnp.uint64(0xFFFF)
    s16 = jnp.uint64(16)
    for _ in range(3):
        d = (d & m16) + _shift_digit_axis(d >> s16)
    b = d & m16
    g = (d >> s16) != 0          # digit == 2^16: generates a carry
    p = b == m16                 # digit == 0xFFFF: propagates a carry

    def comb(left, right):
        gl, pl = left
        gr, pr = right
        return gr | (pr & gl), pl & pr

    G, _ = jax.lax.associative_scan(comb, (g, p), axis=-1)
    carry_in = _shift_digit_axis(G).astype(jnp.uint64)
    digits = (b + carry_in) & m16
    lo = digits[..., 0::2]
    hi = digits[..., 1::2]
    return (lo | (hi << s16)).astype(jnp.uint32)


def mul_const_mod2k(a, c16: np.ndarray, k_out: int):
    """a * c mod 2^(32 k_out), c given as host u16-digit array (np.uint32/u64).

    Exact digit convolution as a bf16 x bf16 -> f32 matrix product (a
    tensor-core GEMM on the GPU): 8-bit digit planes of both operands are
    bf16-exact, every product < 2^16, and the contraction (4K <= 256 terms)
    keeps every f32 partial sum integer-exact (< 2^24) in any summation
    order; adjacent 8-bit columns fold into 16-bit digit sums (< 2^31)
    before carry resolution.
    """
    d8_out = 4 * k_out
    k = a.shape[-1]
    assert 4 * k <= 256, "contraction would overflow the exact-f32 window"
    a64 = a.astype(jnp.uint64)
    a8 = jnp.stack(
        [((a64 >> jnp.uint64(8 * t)) & jnp.uint64(0xFF)) for t in range(4)],
        axis=-1).reshape(a.shape[:-1] + (4 * k,)).astype(jnp.bfloat16)
    c = np.asarray(c16, dtype=np.uint64)
    c8 = np.zeros(2 * c.shape[0], dtype=np.float32)
    c8[0::2] = (c & np.uint64(0xFF)).astype(np.float32)
    c8[1::2] = ((c >> np.uint64(8)) & np.uint64(0xFF)).astype(np.float32)
    # Toeplitz band: M[u, s] = c8[s - u]
    M = np.zeros((4 * k, d8_out), dtype=np.float32)
    for u in range(4 * k):
        hi = min(d8_out - u, c8.shape[0])
        if hi > 0:
            M[u, u:u + hi] = c8[:hi]
    part = jnp.einsum("...k,ks->...s", a8,
                      jnp.asarray(M, dtype=jnp.bfloat16),
                      preferred_element_type=jnp.float32)
    s8 = part.astype(jnp.int32).astype(jnp.uint64)
    s16 = s8[..., 0::2] + (s8[..., 1::2] << jnp.uint64(8))
    return from_digits16(s16, k_out)


def to_f64_centered(a, q_bits: int):
    """Centered value (smod 2^q_bits) of a as f64 (ref: src/types.c:77-106 +
    mpi_smod semantics).  Exact for |value| < 2^53; relative error 2^-53 above."""
    am = mask_bits(a, q_bits)
    hb_limb, hb_bit = divmod(q_bits - 1, 32)
    negmask = ((am[..., hb_limb] >> jnp.uint32(hb_bit)) & jnp.uint32(1)) == 1
    # value - 2^q_bits when negative: use two's complement negate
    # magnitude of the negative branch: 2^q_bits - am, re-masked to q_bits
    mag = select(negmask, mask_bits(neg(am), q_bits), am)
    k = mag.shape[-1]
    val = jnp.zeros(mag.shape[:-1], dtype=jnp.float64)
    for i in range(k - 1, -1, -1):
        val = val * 4294967296.0 + mag[..., i].astype(jnp.float64)
    return jnp.where(negmask, -val, val)
