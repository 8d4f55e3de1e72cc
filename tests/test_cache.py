"""Compile-cache policy (utils/xla.py): JAX_COMPILATION_CACHE_DIR when set,
and nothing else; otherwise the fixed <repo>/.jax_cache."""

import os
import subprocess
import sys

import pytest

from gpqhe_jax.utils.xla import DEFAULT_CACHE_DIR

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROBE = """
import jax, jax.numpy as jnp
from gpqhe_jax.utils.xla import enable_persistent_cache
used = enable_persistent_cache(min_compile_secs=0)
jax.jit(lambda x: jnp.sin(x) * 3 + 1)(jnp.arange(97.0)).block_until_ready()
print(used)
print(jax.config.jax_compilation_cache_dir)
"""


@pytest.mark.parametrize("env_set", [True, False])
def test_cache_dir_policy(tmp_path, env_set):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    want = DEFAULT_CACHE_DIR
    if env_set:
        want = str(tmp_path / "cc")
        env["JAX_COMPILATION_CACHE_DIR"] = want
    p = subprocess.run([sys.executable, "-c", PROBE], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=120)
    assert p.returncode == 0, p.stderr
    used, configured = p.stdout.split()[-2:]
    assert used == configured == want
    if env_set:
        assert os.listdir(want), "no compiled program landed in the cache dir"
