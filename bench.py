"""Benchmark: decode throughput of the GPU engine on the reference's
CANONICAL benchmark shape — a 512^3 connectomics-like volume
(benchmarks/README.md:243-282 uses 512^3 connectomics.npy).

Prints ONE JSON line:
  {"metric": ..., "value": N, "unit": ..., "vs_baseline": N, ...}

The primary metric is steady-state decode throughput from a
device-resident compressed stream (engine.DeviceStream): the
compressed binary (~1% of raw) is uploaded once, then the full volume
decodes entirely on device — the serving path for in-memory
compressed segmentation. vs_baseline compares against the
reference's single-thread decode of 512^3 connectomics.npy on an M3
(545.6 MVx/s, benchmarks/README.md:272).

Correctness inside the run: the decoded per-slice CCL images are
checked against the stream's stored crc32c ON DEVICE once, and the
smaller committed 256^2x128 volume (with its raw .npy in git) is
decoded and compared voxel-exact. Every section is fenced: a failure
in one section zeroes the metric / sets "correct": false but never
aborts the run — the JSON line is always emitted (rc 0) and the
other sections' numbers still print to stderr.

Compressed test volumes are cached under bench_data/ (committed);
scripts/gen_bench_volumes.py regenerates them.
"""
import json
import os
import sys
import time
import traceback

import jax
import numpy as np

BENCH_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "bench_data")
SHAPE = (256, 256, 128)
SHAPE512 = (512, 512, 512)
BASELINE_DECODE_MVX = 545.6  # reference 1-thread M3, 512^3 connectomics

# Two-scale seed densities calibrated to the published
# connectomics.npy compression profile (0.56% flat / 0.51% pins /
# 0.45% markov-5 on 256x256x64 cutouts, benchmarks/README.md:10-14):
# the committed bench volumes land at 0.50% (256^2x128) and 0.70%
# (512^3) flat — bracketing the published figure, with the 512^3
# headline volume on the HARDER side — with realistic per-slice
# component counts and the same pins < flat, markov < pins ordering.
# Densities are per 4.19M voxels (= 256*256*64), scaled by volume.
_SPARSE_PER_4M = 16     # large cells (the neurite/soma backbone)
_PATCHES_PER_4M = 2     # dense patches of small fragments
_PER_PATCH = 40
_PATCH_SIGMA = 10.0
_ANISO_Z = 0.35         # cells elongated along z like neurites


def synthetic_connectomics(shape, seed=42):
  """Two-scale anisotropic Voronoi labeling: a sparse backbone of
  large z-elongated cells plus dense patches of small fragments,
  giving the long-tailed component-size mix of real connectomics
  auto-segmentation. Calibrated to the published compression profile
  (see constants above)."""
  rng = np.random.RandomState(seed)
  sx, sy, sz = shape
  dims = np.array([sx, sy, sz], float)
  scale = (sx * sy * sz) / (256 * 256 * 64)
  n_sparse = max(int(round(_SPARSE_PER_4M * scale)), 2)
  n_patches = max(int(round(_PATCHES_PER_4M * scale)), 1)
  pts = [rng.rand(n_sparse, 3) * dims]
  centers = rng.rand(n_patches, 3) * dims
  for c in centers:
    p = c + rng.randn(_PER_PATCH, 3) * _PATCH_SIGMA \
        * np.array([1.0, 1.0, 1.0 / _ANISO_Z])
    pts.append(p)
  pts = np.clip(np.concatenate(pts), 0, dims - 1)
  aniso = np.array([1.0, 1.0, _ANISO_Z])
  from scipy.spatial import cKDTree
  tree = cKDTree(pts * aniso)
  xs, ys, zs = np.meshgrid(
    np.arange(sx), np.arange(sy), np.arange(sz), indexing='ij'
  )
  q = np.stack([xs.ravel(), ys.ravel(), zs.ravel()], axis=1) * aniso
  _, idx = tree.query(q, workers=-1)
  return np.asfortranarray(
    (idx + 1).astype(np.uint32).reshape(shape)
  )


def get_binary():
  os.makedirs(BENCH_DIR, exist_ok=True)
  path = os.path.join(
    BENCH_DIR,
    f"connectomics_v2_{SHAPE[0]}x{SHAPE[1]}x{SHAPE[2]}.ckl"
  )
  vol_path = path + ".npz"
  import crackle_tpu as crackle
  if os.path.exists(path) and os.path.exists(vol_path):
    with open(path, 'rb') as f:
      return f.read(), np.asfortranarray(np.load(vol_path)["vol"])
  print("generating synthetic connectomics volume...", file=sys.stderr)
  vol = synthetic_connectomics(SHAPE)
  print("compressing (host encoder)...", file=sys.stderr)
  t0 = time.time()
  binary = crackle.compress(vol)
  print(f"encode took {time.time() - t0:.1f}s, "
        f"ratio {len(binary) / vol.nbytes:.4%}", file=sys.stderr)
  with open(path, 'wb') as f:
    f.write(binary)
  np.savez_compressed(vol_path, vol=vol)
  return binary, vol


def _fence(name, fn, *args, **kwargs):
  """Run a bench section; on any failure print the traceback to
  stderr and return None instead of aborting the run."""
  try:
    return fn(*args, **kwargs)
  except Exception:  # noqa: BLE001
    print(f"--- section '{name}' failed ---", file=sys.stderr)
    traceback.print_exc()
    return None


def _bench_512(crackle, engine, jnp):
  path = os.path.join(BENCH_DIR, "connectomics_v2_512x512x512.ckl")
  if not os.path.exists(path):
    print("512^3 stream missing; run scripts/gen_bench_volumes.py",
          file=sys.stderr)
    return None
  binary = open(path, "rb").read()
  voxels = SHAPE512[0] * SHAPE512[1] * SHAPE512[2]
  sz = SHAPE512[2]

  t0 = time.perf_counter()
  stream = engine.upload_stream(binary)
  if stream is None:
    print("512^3: upload_stream fell back to host path", file=sys.stderr)
    return None
  labels, cc, N = stream.decode_window(0, sz, check_crcs=True)
  jax.block_until_ready(labels)
  print(f"512^3 upload+compile+crc-checked decode: "
        f"{time.perf_counter() - t0:.1f} s "
        f"({stream.nbytes_device / 1e6:.1f} MB on device vs "
        f"{voxels * 4 / 1e6:.0f} MB raw)", file=sys.stderr)

  best = None
  for _ in range(3):
    t0 = time.perf_counter()
    outs = []
    for _i in range(4):
      labels, cc, N = stream.decode_window(0, sz)
      outs.append(jnp.max(labels))
    jax.block_until_ready(jnp.stack(outs))
    dt = (time.perf_counter() - t0) / 4
    best = dt if best is None else min(best, dt)
  mvx = voxels / best / 1e6
  print(f"512^3 decode steady-state: {best * 1e3:.1f} ms/volume "
        f"{mvx:.1f} MVx/s ({mvx * 4 / 1e3:.2f} GB/s out)",
        file=sys.stderr)
  return mvx


def _bench_noise(crackle, engine):
  """Pathological binary noise (the reference's worst case). Long
  multi-chain slices split into device-decodable virtual slices, but
  binary noise is one giant crack chain per slice (~95% of the
  stream), which cannot split — those route to the native host
  decoder by design (engine.MAX_DEVICE_CAP). Measures
  whichever path the dispatch actually picks."""
  path = os.path.join(BENCH_DIR, "binary_noise_512x512x16.ckl")
  if not os.path.exists(path):
    return
  binary = open(path, "rb").read()
  voxels = 512 * 512 * 16
  res = engine.decode_window_ccl(binary, 0, 16, check_crcs=True)
  if res is None:
    crackle.decompress(binary)  # warm
    best = None
    for _ in range(2):
      t0 = time.perf_counter()
      crackle.decompress(binary)
      dt = time.perf_counter() - t0
      best = dt if best is None else min(best, dt)
    print(f"noise 512^2x16 decode (host path, by dispatch): "
          f"{best * 1e3:.1f} ms = {voxels / best / 1e6:.1f} MVx/s",
          file=sys.stderr)
    return
  best = None
  for _ in range(2):
    t0 = time.perf_counter()
    engine.decode_window_ccl(binary, 0, 16, check_crcs=False)
    dt = time.perf_counter() - t0
    best = dt if best is None else min(best, dt)
  print(f"noise 512^2x16 decode (device ccl): "
        f"{best * 1e3:.1f} ms = {voxels / best / 1e6:.1f} MVx/s",
        file=sys.stderr)


def _bench_encode_device(crackle, jnp, vol, voxels):
  """Device encode: per-voxel stages (VCG, CCL, tables, CRC32C) on
  the device from a device-resident volume; host tail = DFS trace +
  assembly (kernels/encode.encode_flat_device). Reference bar:
  246.3 MVx/s single-thread M3 (benchmarks/README.md:255)."""
  dev_vol = jnp.asarray(np.ascontiguousarray(vol))
  jax.block_until_ready(jnp.max(dev_vol))
  enc = crackle.compress(dev_vol)  # warm + compile
  want = crackle.compress(vol)
  ok = enc == want
  best = None
  for _ in range(3):
    t0 = time.perf_counter()
    enc = crackle.compress(dev_vol)
    dt = time.perf_counter() - t0
    best = dt if best is None else min(best, dt)
  mvx = voxels / best / 1e6
  print(f"encode(device stages + host trace): {best * 1e3:.0f} ms "
        f"{mvx:.1f} MVx/s; bytes match host: {ok}", file=sys.stderr)
  return mvx if ok else None


def _bench_stage1(jnp, vol, voxels):
  """Pure device throughput of the encode per-voxel stages (no
  transfers, no host tail) — the kernel-speed ceiling."""
  from crackle_tpu.kernels import encode as enc_k
  sx, sy, sz = vol.shape
  zyx = np.ascontiguousarray(np.transpose(vol, (2, 1, 0)))
  planes = jnp.asarray(zyx.astype(np.uint32).view(np.int32))
  outs = enc_k._encode_stage1(planes, sx, sy, False)  # warm
  jax.block_until_ready(outs[4])
  best = None
  for _ in range(3):
    t0 = time.perf_counter()
    outs = enc_k._encode_stage1(planes, sx, sy, False)
    jax.block_until_ready(outs[4])
    dt = time.perf_counter() - t0
    best = dt if best is None else min(best, dt)
  mvx = voxels / best / 1e6
  print(f"encode stage1 (device only): {best * 1e3:.1f} ms "
        f"{mvx:.1f} MVx/s", file=sys.stderr)
  return mvx


def _bench_markov(crackle, engine, jnp):
  """Markov-5 stream through DeviceStream (host rank-decode happens
  once at upload; steady-state serving is all-device). Reference
  decompress bar: 174 MVx/s 1-thread (benchmarks/README.md:157)."""
  path = os.path.join(BENCH_DIR, "connectomics_v2_mkv5_256x256x128.ckl")
  if not os.path.exists(path):
    return None
  binary = open(path, "rb").read()
  voxels = SHAPE[0] * SHAPE[1] * SHAPE[2]
  sz = SHAPE[2]
  stream = engine.upload_stream(binary)
  if stream is None:
    print("markov: upload_stream declined", file=sys.stderr)
    return None
  labels, cc, N = stream.decode_window(0, sz, check_crcs=True)
  jax.block_until_ready(jnp.max(labels))
  best = None
  for _ in range(3):
    t0 = time.perf_counter()
    outs = []
    for _i in range(4):
      labels, cc, N = stream.decode_window(0, sz)
      outs.append(jnp.max(labels))
    jax.block_until_ready(jnp.stack(outs))
    dt = (time.perf_counter() - t0) / 4
    best = dt if best is None else min(best, dt)
  mvx = voxels / best / 1e6
  print(f"markov-5 decode steady-state (DeviceStream): "
        f"{best * 1e3:.1f} ms/window {mvx:.1f} MVx/s", file=sys.stderr)
  return mvx


def _bench_pins(crackle, engine, jnp):
  """Pins stream served from a device-resident DeviceStream (sections
  and pin tables uploaded once, like flat streams)."""
  path = os.path.join(BENCH_DIR, "connectomics_v2_pins_256x256x128.ckl")
  if not os.path.exists(path):
    return None
  binary = open(path, "rb").read()
  voxels = SHAPE[0] * SHAPE[1] * SHAPE[2]
  sz = SHAPE[2]
  stream = engine.upload_stream(binary)
  if stream is None:
    print("pins: upload_stream declined", file=sys.stderr)
    return None
  labels, cc, N = stream.decode_window(0, sz, check_crcs=True)
  jax.block_until_ready(jnp.max(labels))
  best = None
  for _ in range(3):
    t0 = time.perf_counter()
    outs = []
    for _i in range(4):
      labels, cc, N = stream.decode_window(0, sz)
      outs.append(jnp.max(labels))
    jax.block_until_ready(jnp.stack(outs))
    dt = (time.perf_counter() - t0) / 4
    best = dt if best is None else min(best, dt)
  mvx = voxels / best / 1e6
  print(f"pins decode steady-state (DeviceStream): "
        f"{best * 1e3:.1f} ms/window {mvx:.1f} MVx/s", file=sys.stderr)
  return mvx


def _bench_watershed(crackle, engine, jnp):
  """u64 watershed-class stream (ws.npy profile: oversegmented,
  64-bit labels painted as (lo, hi) planes) through DeviceStream.
  Reference bar: 213.4 MVx/s 1-thread decompress
  (benchmarks/README.md:310)."""
  path = os.path.join(BENCH_DIR, "watershed_u64_256x256x128.ckl")
  if not os.path.exists(path):
    return None
  binary = open(path, "rb").read()
  voxels = SHAPE[0] * SHAPE[1] * SHAPE[2]
  sz = SHAPE[2]
  stream = engine.upload_stream(binary)
  if stream is None:
    print("watershed: upload_stream declined", file=sys.stderr)
    return None
  labels, cc, N = stream.decode_window(0, sz, check_crcs=True)
  jax.block_until_ready(jnp.max(labels))
  best = None
  for _ in range(3):
    t0 = time.perf_counter()
    outs = []
    for _i in range(4):
      labels, cc, N = stream.decode_window(0, sz)
      outs.append(jnp.max(labels))
    jax.block_until_ready(jnp.stack(outs))
    dt = (time.perf_counter() - t0) / 4
    best = dt if best is None else min(best, dt)
  mvx = voxels / best / 1e6
  print(f"watershed u64 decode steady-state (DeviceStream): "
        f"{best * 1e3:.1f} ms/window {mvx:.1f} MVx/s",
        file=sys.stderr)
  return mvx


def _bench_encode(crackle, vol, voxels):
  # warmup, then best-of-3: a single cold call measures the container's
  # CPU scheduling noise more than the encoder (round-3 postmortem)
  crackle.compress(vol)
  best = None
  for _ in range(3):
    t0 = time.perf_counter()
    enc = crackle.compress(vol)
    dt = time.perf_counter() - t0
    best = dt if best is None else min(best, dt)
  print(f"encode(host): {best * 1e3:.0f} ms "
        f"{voxels / best / 1e6:.1f} MVx/s "
        f"ratio {len(enc) / vol.nbytes:.4%}", file=sys.stderr)
  return voxels / best / 1e6


def _bench_256(crackle, engine, jnp, binary, vol, voxels, sz):
  """Correctness gate + steady-state window decode on the committed
  256^2x128 volume. Returns (correct, mvx)."""
  stream256 = engine.upload_stream(binary)
  if stream256 is None:
    return False, None
  labels, cc, N = stream256.decode_window(0, sz)
  got = np.asarray(labels).astype(vol.dtype) \
    .reshape(sz, SHAPE[1], SHAPE[0]).transpose(2, 1, 0)
  correct = bool(np.array_equal(got, vol))
  # warm up after the 33 MB correctness fetch, then best-of-3: a
  # single unwarmed rep right after the big d2h measured 13x slow
  # (round-3/4 postmortem — the kernels were never the regression)
  stream256.decode_window(0, sz)
  jax.block_until_ready(jnp.max(labels))
  best = None
  for _ in range(3):
    t0 = time.perf_counter()
    outs = []
    for _i in range(8):
      labels, cc, N = stream256.decode_window(0, sz)
      outs.append(jnp.max(labels))
    jax.block_until_ready(jnp.stack(outs))
    dt = (time.perf_counter() - t0) / 8
    best = dt if best is None else min(best, dt)
  dt = best
  mvx = voxels / dt / 1e6
  print(f"256^2x128 decode steady-state: {dt * 1e3:.1f} ms/window "
        f"{mvx:.1f} MVx/s; correct: {correct}", file=sys.stderr)
  return correct, mvx


def main():
  import crackle_tpu as crackle
  from crackle_tpu.kernels import engine
  import jax.numpy as jnp

  backend = jax.default_backend()
  if backend != "gpu":
    print(f"bench: needs a GPU; JAX's backend is {backend!r}",
          file=sys.stderr)
    sys.exit(1)
  import subprocess
  card = subprocess.run(
    ["nvidia-smi", "--query-gpu=name,power.limit",
     "--format=csv,noheader"],
    capture_output=True, text=True, timeout=60, check=True).stdout
  print(f"card: {card.strip()} devices: {jax.devices()}",
        file=sys.stderr)

  binary, vol = get_binary()
  voxels = SHAPE[0] * SHAPE[1] * SHAPE[2]
  sz = SHAPE[2]

  encode_mvx = _fence("encode", _bench_encode, crackle, vol, voxels)

  res256 = _fence("256-device", _bench_256, crackle, engine, jnp,
                  binary, vol, voxels, sz)
  correct256, mvx256 = res256 if res256 is not None else (False, None)

  def host_decode():
    t0 = time.perf_counter()
    ok = bool(np.array_equal(crackle.decompress(binary), vol))
    host_dt = time.perf_counter() - t0
    print(f"decode-to-host (with crc): {host_dt * 1e3:.0f} ms "
          f"{voxels / host_dt / 1e6:.1f} MVx/s; correct: {ok}",
          file=sys.stderr)
    return ok

  host_ok = bool(_fence("host-decode", host_decode))
  correct = correct256 and host_ok

  enc_dev_mvx = _fence("encode-device", _bench_encode_device,
                       crackle, jnp, vol, voxels)
  stage1_mvx = _fence("encode-stage1", _bench_stage1, jnp, vol, voxels)
  mkv_mvx = _fence("markov-device", _bench_markov, crackle, engine, jnp)
  pins_mvx = _fence("pins-device", _bench_pins, crackle, engine, jnp)
  ws_mvx = _fence("watershed-device", _bench_watershed, crackle,
                  engine, jnp)

  # primary: the canonical 512^3 volume (per-slice CCL crc32c checked
  # on device during the cold pass)
  mvx = _fence("512-device", _bench_512, crackle, engine, jnp)
  _fence("noise", _bench_noise, crackle, engine)

  out = {
    "metric": "decode_throughput",
    "value": round(mvx, 1) if (mvx and correct) else 0.0,
    "unit": "MVx/s",
    "vs_baseline": round(mvx / BASELINE_DECODE_MVX, 3)
                   if (mvx and correct) else 0.0,
    "correct": correct,
  }
  for key, v in (("encode_mvx", encode_mvx),
                 ("encode_device_mvx", enc_dev_mvx),
                 ("encode_stage1_mvx", stage1_mvx),
                 ("markov_decode_mvx", mkv_mvx),
                 ("pins_decode_mvx", pins_mvx),
                 ("watershed_u64_decode_mvx", ws_mvx),
                 ("decode_256_mvx", mvx256)):
    if v:
      out[key] = round(v, 1)
  print(json.dumps(out))


if __name__ == "__main__":
  main()
