"""smallvcm_tpu: differentiable SmallVCM in JAX.

Importing the package sets JAX's persistent compilation cache, so the large
wavefront programs compile once and load from disk in later processes.
``JAX_COMPILATION_CACHE_DIR``, when set, is the cache and no other directory
is set; otherwise the cache is ``.jax_cache`` at the root of the checkout.
"""

import os as _os
from pathlib import Path as _Path

import jax as _jax

CHECKOUT_CACHE_DIR = _Path(__file__).resolve().parent.parent / ".jax_cache"

if not _os.environ.get("JAX_COMPILATION_CACHE_DIR"):
    _jax.config.update("jax_compilation_cache_dir", str(CHECKOUT_CACHE_DIR))
