"""Ring engine: jitted device composites over R_q = Z_q[X]/(X^n + 1).

Device replacement for the reference's poly.c hot path
(ref: src/poly.c:84-120).  Polynomials are u32-limb tensors [n, K]
(see gpqhe_jax.ops.limbs); products run decompose -> NTT -> pointwise ->
INTT -> CRT-reconstruct entirely on device, one fused jit program per
static shape signature.

Key semantic invariant (why masking replaces big-int smod): every ciphertext
modulus is q_l = 2^logq_l (the reference builds the ladder by dividing
q = 1 << logq by Delta = 2^logDelta, ref: tests/gpqhe.c:1349-1352,
src/precomp.c:386-409), and 2^(32K) is then a multiple of q_l, so two's-
complement limb arithmetic mod 2^(32K) preserves values mod q_l.  All RNS
dimension formulas still cover the (slightly larger) representative
magnitudes — see dim_* in context.py.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..context import PolyContext
from ..ops import limbs as lb
from ..ops import rns as rns_ops
from ..ops.modmath import mulmod
from ..ops.ntt import intt, ntt
from ..substrate import bigint


NTT_IMPLS = ("butterfly", "matmul")


class RingEngine:
    """Per-PolyContext device kernels with plan/jit caches.

    ntt_impl selects the NTT backend: 'butterfly' (fused elementwise
    stages, ops/ntt.py) or 'matmul' (four-step digit matmuls, ops/ntt4.py).
    The two produce different (internally consistent) evaluation orders, so
    all NTT-resident objects of one engine share one backend.
    """

    def __init__(self, pctx: PolyContext, ntt_impl: str = "butterfly"):
        if ntt_impl not in NTT_IMPLS:
            raise ValueError(f"ntt_impl must be one of {NTT_IMPLS}, "
                             f"not {ntt_impl!r}")
        self.pctx = pctx
        self.ntt_impl = ntt_impl
        self._ba: dict[int, rns_ops.BasisArrays] = {}
        self._recon: dict[int, rns_ops.ReconPlan] = {}
        self._weights: dict[tuple[int, int], np.ndarray] = {}
        self._galois: dict[int, tuple[np.ndarray, np.ndarray]] = {}
        self._ntt4: dict[int, object] = {}
        self._jit: dict = {}

    def ntt4_plan(self, dim: int):
        if dim not in self._ntt4:
            from ..ops.ntt4 import make_ntt4_plan
            self._ntt4[dim] = make_ntt4_plan(self.pctx, dim)
        return self._ntt4[dim]

    def prepare(self, dim: int) -> None:
        """Eagerly materialize device plans for dim (must run OUTSIDE any jit
        trace — device arrays created during tracing would leak as tracers)."""
        self.ba(dim)
        if self.ntt_impl == "matmul":
            self.ntt4_plan(dim)

    def ntt_f(self, res, dim: int):
        """Forward NTT with the selected backend; res u64[..., dim, n]
        (leading poly/batch axes allowed)."""
        if self.ntt_impl == "matmul":
            from ..ops.ntt4 import ntt4
            return ntt4(res, self.ntt4_plan(dim))
        ba = self.ba(dim)
        return ntt(res, ba.zetas, ba.ps, ba.pinv)

    def ntt_i(self, res, dim: int, scale_phatinv: bool = False):
        """Inverse NTT with the selected backend; res u64[..., dim, n].

        scale_phatinv=True fuses the CRT reconstruct's per-prime phat^-1
        multiply into the INTT's final n^-1 scaling (callers then pass
        pre_scaled=True to rns.reconstruct)."""
        if self.ntt_impl == "matmul":
            from ..ops.ntt4 import intt4
            out = intt4(res, self.ntt4_plan(dim))
            if scale_phatinv:
                from ..ops.modmath import mont_mul
                ba = self.ba(dim)
                out = mont_mul(out, ba.phatinv_mont[:, None], ba.ps[:, None],
                               ba.pinv[:, None])
            return out
        ba = self.ba(dim)
        return intt(res, ba.zetas_inv, ba.ps, ba.pinv,
                    ba.ninvphat_mont if scale_phatinv else ba.ninv_mont)

    # -- plan caches --------------------------------------------------------

    def ba(self, dim: int) -> rns_ops.BasisArrays:
        if dim not in self._ba:
            self._ba[dim] = rns_ops.make_basis_arrays(self.pctx, dim)
        return self._ba[dim]

    def recon(self, dim: int) -> rns_ops.ReconPlan:
        if dim not in self._recon:
            self._recon[dim] = rns_ops.make_recon_plan(self.pctx, dim)
        return self._recon[dim]

    def weights(self, dim: int, k: int) -> np.ndarray:
        if (dim, k) not in self._weights:
            self._weights[(dim, k)] = rns_ops.make_decomp_weights(self.pctx, dim, k)
        return self._weights[(dim, k)]

    def galois_map(self, rot: int | None) -> tuple[np.ndarray, np.ndarray]:
        """(src_index, neg_flag) for output slot k.  rot=None means conjugation.

        poly_rot: k = i*5^rot mod 2n, sign flip above n (ref: src/poly.c:263-276);
        poly_conj: r[0]=a[0], r[i]=-a[n-i] (ref: src/poly.c:278-283)."""
        key = -1 if rot is None else rot
        if key not in self._galois:
            n, m = self.pctx.n, self.pctx.m
            src = np.empty(n, dtype=np.int32)
            negf = np.empty(n, dtype=bool)
            if rot is None:
                src[0] = 0
                negf[0] = False
                for i in range(1, n):
                    src[i] = n - i
                    negf[i] = True
            else:
                power = pow(params_rot(), rot, m)
                for i in range(n):
                    k = (i * power) % m
                    if k < n:
                        src[k] = i
                        negf[k] = False
                    else:
                        src[k - n] = i
                        negf[k - n] = True
            self._galois[key] = (src, negf)
        return self._galois[key]

    # -- jit helper ---------------------------------------------------------

    def _cached(self, key, builder):
        if key not in self._jit:
            self._jit[key] = builder()
        from ..utils import trace
        return trace.maybe_wrap(key, self._jit[key])

    # -- decompose variants -------------------------------------------------

    def _decompose_unsigned(self, a, dim: int):
        k = a.shape[-1]
        return rns_ops.decompose(a, self.ba(dim), self.weights(dim, k))

    def _decompose_signed(self, a, dim: int, src_bits: int):
        """Two's-complement input of src_bits width -> residues honouring sign."""
        ba = self.ba(dim)
        hb_limb, hb_bit = divmod(src_bits - 1, 32)
        negmask = ((a[..., hb_limb] >> jnp.uint32(hb_bit)) & jnp.uint32(1)) == 1
        mag = lb.select(negmask, lb.mask_bits(lb.neg(a), src_bits), a)
        res = self._decompose_unsigned(mag, dim)  # [dim, n]
        ps = ba.ps[:, None]
        neg_res = jnp.where(res != 0, ps - res, res)
        return jnp.where(negmask[None, :], neg_res, res)

    def decompose(self, a, dim: int, signed_bits: int | None = None):
        if signed_bits is None:
            return self._decompose_unsigned(a, dim)
        return self._decompose_signed(a, dim, signed_bits)

    # -- public jitted composites ------------------------------------------

    def fwd_ntt(self, a, dim: int, signed_bits: int | None = None):
        """limbs [n, K] -> NTT-domain residues u64[dim, n]."""
        key = ("fwd", dim, a.shape[-1], signed_bits)

        def build():
            self.prepare(dim)
            ba = self.ba(dim)

            @jax.jit
            def f(x):
                res = self.decompose(x, dim, signed_bits)
                return self.ntt_f(res, dim)
            return f
        return self._cached(key, build)(a)

    def inv_ntt_recon(self, chat, dim: int, mask_to_bits: int, k_out: int,
                      center: bool = True):
        """NTT-domain residues -> limbs mod 2^mask_to_bits, resized to k_out."""
        key = ("invrec", dim, mask_to_bits, k_out, center)

        def build():
            self.prepare(dim)
            ba = self.ba(dim)
            plan = self.recon(dim)

            @jax.jit
            def f(ch):
                res = self.ntt_i(ch, dim)
                c = rns_ops.reconstruct(res, ba, plan, center=center)
                return lb.fit_signed(c, mask_to_bits, k_out)
            return f
        return self._cached(key, build)(chat)

    def pointwise_mul(self, ahat, bhat, dim: int):
        key = ("pw", dim, ahat.shape)

        def build():
            ba = self.ba(dim)
            r2 = jnp.array(self.pctx.basis(dim).r2)

            @jax.jit
            def f(x, y):
                return mulmod(x, y, ba.ps[:, None], ba.pinv[:, None], r2[:, None])
            return f
        return self._cached(key, build)(ahat, bhat)

    def poly_mul(self, a, b, dim: int, mask_to_bits: int, k_out: int,
                 signed_a: int | None = None, signed_b: int | None = None):
        """Full negacyclic product (ref: src/poly.c:84-107) with final smod as
        a power-of-two mask.  Returns u32[n, k_out]."""
        key = ("mul", dim, a.shape[-1], b.shape[-1], mask_to_bits, k_out,
               signed_a, signed_b)

        def build():
            self.prepare(dim)
            ba = self.ba(dim)
            plan = self.recon(dim)
            r2 = jnp.array(self.pctx.basis(dim).r2)

            @jax.jit
            def f(x, y):
                xh = self.ntt_f(self.decompose(x, dim, signed_a), dim)
                yh = self.ntt_f(self.decompose(y, dim, signed_b), dim)
                ch = mulmod(xh, yh, ba.ps[:, None], ba.pinv[:, None], r2[:, None])
                res = self.ntt_i(ch, dim)
                c = rns_ops.reconstruct(res, ba, plan, center=True)
                return lb.fit_signed(c, mask_to_bits, k_out)
            return f
        return self._cached(key, build)(a, b)

    def galois(self, a, rot: int | None, q_bits: int):
        """Apply rot/conj automorphism to limbs mod 2^q_bits."""
        key = ("gal", -1 if rot is None else rot, a.shape, q_bits)

        def build():
            src, negf = self.galois_map(rot)
            srcj = jnp.asarray(src)
            negj = jnp.asarray(negf)

            @jax.jit
            def f(x):
                g = x[srcj, :]
                neg = lb.mask_bits(lb.neg(g), q_bits)
                pos = lb.mask_bits(g, q_bits)
                return jnp.where(negj[:, None], neg, pos)
            return f
        return self._cached(key, build)(a)


def params_rot() -> int:
    from .. import params
    return params.ROT
