"""JAX/XLA decode + encode building blocks.

On import, enables JAX's persistent compilation cache so that each
process does not compile the decode programs again. Where
JAX_COMPILATION_CACHE_DIR is set, JAX already reads it and nothing
else is set here; otherwise the cache lives at a fixed path inside the
checkout (COMPILE_CACHE_DIR), listed in .gitignore.
"""
import os as _os

COMPILE_CACHE_DIR = _os.path.join(
  _os.path.dirname(_os.path.dirname(_os.path.dirname(
    _os.path.abspath(__file__)))), ".jax_cache")


def _enable_compile_cache():
  import jax
  if (_os.environ.get("JAX_COMPILATION_CACHE_DIR")
      or jax.config.jax_compilation_cache_dir):
    return
  jax.config.update("jax_compilation_cache_dir", COMPILE_CACHE_DIR)


_enable_compile_cache()

from . import decode, engine
