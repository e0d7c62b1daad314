"""Runtime setup for the entry points: precision and the compile cache.

The platform is JAX's own choice, which ``JAX_PLATFORMS`` overrides. A
platform that fails to start raises; nothing falls back to another one.
"""

from __future__ import annotations

import os

# fixed, so the cache's key (which includes the path) is the same in every
# process run from this checkout; listed in .gitignore
DEFAULT_CACHE_DIR = os.path.abspath(
    os.path.join(os.path.dirname(__file__), "..", "..", ".jax_cache"))


def enable_compile_cache() -> str | None:
    """Turn on JAX's persistent compile cache; returns its directory:
    ``JAX_COMPILATION_CACHE_DIR`` if set, else the checkout's ``.jax_cache/``.

    JAX reads ``JAX_COMPILATION_CACHE_DIR`` itself, so a directory is set
    here only when that variable is not, and only off the CPU: XLA:CPU
    warns of a machine-feature mismatch on every entry it reloads, and its
    compiles are quick. Call it before the process compiles anything: JAX
    fixes the cache at its first compile."""
    import jax

    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    if jax.default_backend() == "cpu":
        return None
    jax.config.update("jax_compilation_cache_dir", DEFAULT_CACHE_DIR)
    return DEFAULT_CACHE_DIR


def setup(use_x64: bool) -> str:
    """Configure precision and the compile cache; returns the backend name.

    float64 runs stay on the default platform like float32 ones."""
    import jax

    if use_x64:
        jax.config.update("jax_enable_x64", True)
    enable_compile_cache()
    return jax.default_backend()
