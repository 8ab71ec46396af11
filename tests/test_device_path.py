"""Device-path plumbing: the one backend predicate, the compile-cache
policy, the native CRC32C fallback, and the GPU smoke script's refusal
to run without a GPU."""
import os
import subprocess
import sys

import numpy as np
import pytest

import crackle_tpu as crackle
from crackle_tpu import codec

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(code, env_extra=None, env_drop=()):
  env = {k: v for k, v in os.environ.items() if k not in env_drop}
  env.update(JAX_PLATFORMS="cpu", PYTHONPATH=ROOT, **(env_extra or {}))
  return subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                        capture_output=True, text=True, timeout=120)


@pytest.mark.parametrize("engine,expect", [
  ("numpy", False), ("jax", True), ("auto", False),
])
def test_device_path_predicate(monkeypatch, engine, expect):
  """set_engine forces the choice; 'auto' follows JAX's default
  backend, which is the CPU here."""
  monkeypatch.setattr(codec, "_ENGINE", engine)
  assert codec.device_path_on() is expect


def test_device_path_predicate_routes_decode_and_encode(monkeypatch):
  """decompress and compress of a device array take the device path
  exactly when the predicate says so."""
  from crackle_tpu.kernels import encode, engine
  from crackle_tpu.headers import LabelFormat
  coarse = np.random.RandomState(3).randint(0, 3, size=(3, 3, 2))
  vol = np.asfortranarray(coarse.repeat(4, 0).repeat(4, 1).repeat(2, 2)
                          .astype(np.uint32))
  binary = crackle.compress(vol)
  pins = crackle.compress(vol, allow_pins=1)
  assert crackle.header(pins).label_format == \
    LabelFormat.PINS_VARIABLE_WIDTH
  calls = []
  real_dec, real_enc = engine.decode_window, encode.encode_flat_device
  monkeypatch.setattr(engine, "decode_window",
                      lambda *a, **k: calls.append("dec")
                      or real_dec(*a, **k))
  monkeypatch.setattr(encode, "encode_flat_device",
                      lambda *a, **k: calls.append("enc")
                      or real_enc(*a, **k))
  import jax.numpy as jnp
  for on in (False, True):
    monkeypatch.setattr(codec, "device_path_on", lambda: on)
    calls.clear()
    # pins streams skip the native decoder, so the predicate decides
    np.testing.assert_array_equal(crackle.decompress(pins), vol)
    assert crackle.compress(jnp.asarray(vol)) == binary
    assert calls == (["dec", "enc"] if on else [])


def test_compile_cache_honours_env(tmp_path):
  """With JAX_COMPILATION_CACHE_DIR set, that is the one cache dir."""
  r = _run("import jax, crackle_tpu.kernels as k; "
           "print(jax.config.jax_compilation_cache_dir)",
           env_extra={"JAX_COMPILATION_CACHE_DIR": str(tmp_path)})
  assert r.returncode == 0, r.stderr
  assert r.stdout.strip().splitlines()[-1] == str(tmp_path)


def test_compile_cache_fixed_path_in_checkout():
  """Without the variable, the cache is a fixed path inside the
  checkout, the same in every process."""
  code = ("import jax, crackle_tpu.kernels as k; "
          "print(jax.config.jax_compilation_cache_dir)")
  outs = [_run(code, env_drop=("JAX_COMPILATION_CACHE_DIR",))
          for _ in range(2)]
  for r in outs:
    assert r.returncode == 0, r.stderr
  paths = {r.stdout.strip().splitlines()[-1] for r in outs}
  assert paths == {os.path.join(ROOT, ".jax_cache")}


def test_native_crc32c_fallback(monkeypatch):
  """Without google_crc32c, lib.crc32c uses the native library's
  CRC32C, which equals the pure-python byte loop."""
  from crackle_tpu import lib, native
  monkeypatch.setattr(lib, "_HAS_GOOGLE_CRC", False)
  assert native.available()
  calls = []
  real = native.crc32c
  monkeypatch.setattr(native, "crc32c",
                      lambda b: calls.append(len(b)) or real(b))
  rng = np.random.RandomState(1)
  for n in (0, 1, 7, 8, 9, 4099):
    data = rng.randint(0, 256, size=n).astype(np.uint8)
    assert lib.crc32c(data) == lib._crc32c_py(data.tobytes())
  assert calls == [0, 1, 7, 8, 9, 4099]
  # the standard CRC-32C check value
  assert lib.crc32c(b"123456789") == 0xE3069283


@pytest.fixture
def gpu():
  """Skip unless nvidia-smi names a card. Decided here, at run time,
  so every worker collects the same tests."""
  import shutil
  smi = shutil.which("nvidia-smi")
  if smi is None or subprocess.run([smi, "-L"], capture_output=True,
                                   timeout=60).returncode != 0:
    pytest.skip("no NVIDIA GPU: nvidia-smi finds no card")


@pytest.mark.gpu
def test_chip_smoke_passes_on_gpu(gpu):
  """On a GPU machine the smoke script passes every phase. It runs in
  its own process on the card; this process stays on the CPU."""
  env = {k: v for k, v in os.environ.items()
         if k not in ("JAX_PLATFORMS", "XLA_FLAGS")}
  r = subprocess.run([sys.executable, os.path.join(ROOT, "chip_smoke.py")],
                     env=env, cwd=ROOT, capture_output=True, text=True,
                     timeout=1200)
  assert r.returncode == 0, r.stdout[-4000:] + r.stderr[-4000:]
  assert r.stdout.strip().splitlines()[-1].startswith('{"ok": true')


def test_chip_smoke_refuses_cpu():
  """chip_smoke.py exits non-zero and prints no result off the GPU."""
  env = dict(os.environ, JAX_PLATFORMS="cpu")
  r = subprocess.run([sys.executable, os.path.join(ROOT, "chip_smoke.py")],
                     env=env, cwd=ROOT, capture_output=True, text=True,
                     timeout=120)
  assert r.returncode != 0
  assert '"ok"' not in r.stdout
  assert "needs a GPU" in r.stderr
