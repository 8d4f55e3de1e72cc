"""gpqhe_jax — CKKS homomorphic-encryption framework on JAX/XLA.

A ground-up JAX rebuild with the capabilities of the reference GPQHE library
(pure C).  See SURVEY.md for the layer map this package implements.

64-bit integer support must be enabled before any array op: residues are u64
and Montgomery products are built from explicit 32-bit splits.
"""

import jax as _jax

_jax.config.update("jax_enable_x64", True)

from .context import HeContext, PolyContext  # noqa: E402,F401
from .scheme.engine import CKKS  # noqa: E402,F401
from .scheme.types import (  # noqa: E402,F401
    Ciphertext, Plaintext, PublicKey, SecretKey, SwitchKey)
