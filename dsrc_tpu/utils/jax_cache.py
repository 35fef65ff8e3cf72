"""Where JAX keeps its persistent compilation cache for this program.

Compiling the block programs takes seconds to minutes, so the package
calls `use_compile_cache()` when it is imported, before any compile of the
library, the CLI, bench.py or chip_smoke.py.  The rule:

  * `JAX_COMPILATION_CACHE_DIR` set: that directory, nothing else changed;
  * otherwise `<checkout>/.jax_cache`, one fixed path inside the checkout
    (listed in .gitignore), so every process run from the same checkout
    finds what an earlier one compiled.
"""
from __future__ import annotations

import os

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
CHECKOUT_CACHE = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), ".jax_cache")


def use_compile_cache() -> str:
    """Point JAX's persistent compilation cache at the directory the rule
    above picks and return it.  Works whether or not jax was imported
    first (a config update, not an environment default); call it before
    the first compile, since JAX opens the cache only once."""
    import jax

    path = os.environ.get(ENV_VAR) or CHECKOUT_CACHE
    jax.config.update("jax_compilation_cache_dir", path)
    return path
