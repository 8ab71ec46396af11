"""Two-process jax.distributed test of the multi-host codec flow:
compress_shard -> assemble_shards (byte-identical to single-process)
-> per-host windowed decode, plus a real cross-process allgather.

Each process runs 2 virtual CPU devices, so the global view is a
4-device cluster split across 2 processes — the same topology shape
as 2 hosts over the network (SURVEY.md section 2.5 / BASELINE 2-host
row).
"""
import os
import socket
import subprocess
import sys
import tempfile

import pytest


def _free_port() -> int:
  s = socket.socket()
  s.bind(("localhost", 0))
  port = s.getsockname()[1]
  s.close()
  return port


def test_two_process_compress_assemble_decode():
  worker = os.path.join(os.path.dirname(__file__),
                        "_multihost_worker.py")
  port = _free_port()
  nproc = 2
  env = dict(os.environ)
  env.pop("XLA_FLAGS", None)
  env["JAX_PLATFORMS"] = "cpu"
  with tempfile.TemporaryDirectory() as tmp:
    procs = [
      subprocess.Popen(
        [sys.executable, worker, str(i), str(nproc), str(port), tmp],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env,
      )
      for i in range(nproc)
    ]
    outs = []
    for p in procs:
      try:
        out, _ = p.communicate(timeout=240)
      except subprocess.TimeoutExpired:
        for q in procs:
          q.kill()
        raise
      outs.append(out.decode(errors="replace"))
    for i, (p, out) in enumerate(zip(procs, outs)):
      assert p.returncode == 0, f"worker {i} failed:\n{out}"
      assert f"worker {i} OK" in out, out
