"""Test harness config: force CPU with 8 virtual devices for mesh tests.

Mirrors the reference's deterministic-KAT philosophy (ref: README.md:48,
src/rng.c:32-78): everything derives from the surf stream, so tests are
reproducible bit for bit.  Multi-device tests run on a virtual CPU mesh
(the "fake backend" analogue, SURVEY.md §4).
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# Tests always run on the virtual CPU mesh, whatever device the host has.
os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

from gpqhe_jax.utils.xla import enable_persistent_cache  # noqa: E402

# Scheme-op programs take seconds each to compile; the persistent cache makes
# repeated test runs fast (JAX_COMPILATION_CACHE_DIR, else <repo>/.jax_cache).
enable_persistent_cache(min_compile_secs=1.0)

import pytest  # noqa: E402

import gpqhe_jax  # noqa: E402,F401  (enables x64 before any jax use)


@pytest.fixture(autouse=True)
def _fresh_rng():
    """Reset the process-global surf stream per test, like a fresh C process."""
    from gpqhe_jax.substrate import surf
    surf.reset_default_rng()
    yield
    surf.reset_default_rng()
