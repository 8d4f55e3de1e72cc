"""JAX's persistent compilation cache for the engine's programs.

Scheme-op programs are large (dozens of fused u64 stages per NTT), so a
fresh process pays seconds to minutes of compilation; the persistent cache
replays them from disk.  The cache key includes the backend, so CPU and GPU
entries share one directory safely.
"""

import os

import jax

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
DEFAULT_CACHE_DIR = os.path.join(_REPO_ROOT, ".jax_cache")


def enable_persistent_cache(min_compile_secs: float = 0.5) -> str:
    """Turn on the persistent compilation cache.  Call BEFORE the first jit
    dispatch.  Where JAX_COMPILATION_CACHE_DIR is set JAX already reads it,
    and that directory is used as it is; otherwise the cache lives at the
    fixed <repo>/.jax_cache (a fixed path, because the path is part of what
    a cached entry is found again by).  Returns the directory in use."""
    cache_dir = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if not cache_dir:
        cache_dir = DEFAULT_CACHE_DIR
        jax.config.update("jax_compilation_cache_dir", cache_dir)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", min_compile_secs)
    return cache_dir
