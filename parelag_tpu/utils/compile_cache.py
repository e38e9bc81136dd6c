"""Persistent XLA compilation cache.

JAX's persistent compilation cache stores each serialized executable on
local disk keyed by the HLO fingerprint (and the platform), so a process
after the first loads the same graphs instead of compiling them again.
Every entry point enables it before its first compile.
"""

import os

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def default_cache_dir() -> str:
    """JAX_COMPILATION_CACHE_DIR when set, else the fixed
    `<repo>/.jax_cache` (the path is part of the cache's key, so it must
    not move between runs)."""
    return (os.environ.get("JAX_COMPILATION_CACHE_DIR")
            or os.path.join(_REPO, ".jax_cache"))


def enable_persistent_compile_cache() -> str:
    """Point JAX at the on-disk compilation cache (idempotent) and return
    its directory.  Must run before the first jit compilation; a failure
    raises."""
    import jax

    existing = getattr(jax.config, "jax_compilation_cache_dir", None)
    if existing:
        return existing
    path = default_cache_dir()
    os.makedirs(path, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", path)
    # cache everything that took XLA real work; tiny entries are cheap
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.2)
    return path
