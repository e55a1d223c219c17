"""Where the persistent XLA compilation cache lives.

One rule for every entry point (the CLI, viz, bench.py, chip_smoke.py and
experiments/): if ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself
and nothing is set here. Otherwise the cache goes to ``<checkout>/.jax_cache``,
derived from the package's location — a fixed path, because the path is part
of what makes a later run find the entries again.
"""

from __future__ import annotations

import os

ENV = "JAX_COMPILATION_CACHE_DIR"
CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def cache_dir() -> str:
    """The directory the cache uses under the rule above."""
    return os.environ.get(ENV) or os.path.join(CHECKOUT, ".jax_cache")


def enable() -> str:
    """Point JAX at ``cache_dir()`` (call before the first compile);
    returns the directory in use."""
    if not os.environ.get(ENV):
        import jax
        jax.config.update("jax_compilation_cache_dir", cache_dir())
    return cache_dir()
