"""Tracing/profiling helpers (SURVEY section 5: the reference has no
in-tree tracing; the device path uses the jax profiler instead)."""
import contextlib
import time
from typing import Optional


@contextlib.contextmanager
def trace(log_dir: str = "/tmp/crackle_tpu_trace"):
  """Capture a jax profiler trace around a block:

      with crackle_tpu.utils.profiling.trace() as d:
          decompress(...)
      # open d with tensorboard / xprof
  """
  import jax
  jax.profiler.start_trace(log_dir)
  try:
    yield log_dir
  finally:
    jax.profiler.stop_trace()


@contextlib.contextmanager
def timer(name: str = "", sync=None):
  """Wall-clock a block; pass sync=array to block on device work."""
  import jax
  t0 = time.perf_counter()
  box = {}
  try:
    yield box
  finally:
    if sync is not None:
      jax.block_until_ready(sync)
    box["seconds"] = time.perf_counter() - t0
    if name:
      print(f"{name}: {box['seconds'] * 1e3:.1f} ms")


def annotate(name: str):
  """Named profiler span decorator for hot functions."""
  import jax

  def deco(fn):
    def wrapped(*args, **kwargs):
      with jax.profiler.TraceAnnotation(name):
        return fn(*args, **kwargs)
    wrapped.__name__ = getattr(fn, "__name__", name)
    return wrapped
  return deco
