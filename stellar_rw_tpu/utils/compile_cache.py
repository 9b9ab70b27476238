"""Where JAX keeps its persistent compilation cache.

JAX reads `JAX_COMPILATION_CACHE_DIR` by itself. When it is set, this module
sets nothing, so no second cache directory appears. When it is not set, the
cache goes to a fixed `.jax_cache/` at the root of the checkout: a fixed path,
because the path is part of the cache key and a moving directory never hits.
"""

from __future__ import annotations

import os

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
CHECKOUT_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
DEFAULT_DIR = os.path.join(CHECKOUT_ROOT, ".jax_cache")


def configure_compile_cache() -> str:
    """Point JAX's persistent compilation cache at its directory; returns it.

    Call before the first compilation of the process."""
    env_dir = os.environ.get(ENV_VAR)
    if env_dir:
        return env_dir
    import jax

    jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    return DEFAULT_DIR
