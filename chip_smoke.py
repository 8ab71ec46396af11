"""Smoke test of the codec's main path on NVIDIA GPUs.

    python chip_smoke.py           # one card: phases (b)-(g)
    python chip_smoke.py --four    # four cards: the sharded path only

One process drives the card(s); the phases run in order and any
failure exits non-zero. Every comparison is exact (the codec is
lossless). Phases on one card:

  (b) 512^3 u32 flat stream: upload_stream, CRC-checked device decode
      of all 512 slices against the native host decode; a corrupted
      stored CRC word must raise FormatError;
  (c) the committed 256^2x128 flat, markov-5, pins and u64 watershed
      streams through DeviceStream against the host decode;
  (d) CrackleDeviceArray 256^2x64 cutouts of the 512^3 stream at
      seeded offsets against the host volume;
  (e) crackle.compress of device arrays (256^2x128 and 512^3) against
      the host encoder's bytes;
  (f) voxel_counts / bounding_boxes through the device stats against
      the host path;
  (g) stage timings at 512^3: replay, CCL sweeps, CRC32C.

With --four: decompress_sharded and compress_sharded of the 512^3
volume on a 1-D mesh over four cards, against the single-card decode
and the host encoder's bytes.

The last line of standard output is one JSON object,
{"ok": true, "device": {"platform", "kind", "count"}}. Without a GPU
the script exits non-zero and prints no result.
"""
import argparse
import json
import logging
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
BENCH_DIR = os.path.join(ROOT, "bench_data")
SEED = 20261016


def log(msg):
  print(msg, flush=True)


def ms(seconds):
  return f"{seconds * 1e3:.3f} ms"


def median_seconds(fn, reps=5):
  """Median wall time of fn(), which must end in block_until_ready."""
  ts = []
  for _ in range(reps):
    t0 = time.perf_counter()
    fn()
    ts.append(time.perf_counter() - t0)
  return float(np.median(ts))


def card_lines():
  """nvidia-smi's name and power limit of each card; fails if the card
  cannot be named."""
  out = subprocess.run(
    ["nvidia-smi", "--query-gpu=name,power.limit",
     "--format=csv,noheader"],
    capture_output=True, text=True, timeout=60, check=True).stdout
  lines = [ln.strip() for ln in out.splitlines() if ln.strip()]
  if not lines:
    raise RuntimeError("nvidia-smi named no card")
  return lines


class WarningLog(logging.Handler):
  """Collects the engine's host-fallback warnings."""

  def __init__(self):
    super().__init__(logging.WARNING)
    self.records = []

  def emit(self, record):
    self.records.append(record.getMessage())


def read(name):
  with open(os.path.join(BENCH_DIR, name), "rb") as f:
    return f.read()


def host_decode(binary):
  """Host decode (native where it applies, else numpy), with the
  device path off."""
  from crackle_tpu import codec
  prev = codec.get_engine()
  codec.set_engine("numpy")
  try:
    return codec.decompress(binary)
  finally:
    codec.set_engine(prev)


def stream_to_volume(labels, head, z0, z1):
  return np.asarray(labels).astype(head.dtype, copy=False).reshape(
    z1 - z0, head.sy, head.sx).transpose(2, 1, 0)


def compile_seconds(stream, z0, z1):
  """AOT lower + compile of the window decode program a DeviceStream
  runs for [z0, z1)."""
  from crackle_tpu.kernels import decode as dec
  h = stream.head
  win = (lambda a: a) if (z0, z1) == (0, h.sz) else (lambda a: a[z0:z1])
  base = [win(a) for a in (stream.packed, stream.nbytes, stream.nodes,
                           stream.n_chains)]
  t0 = time.perf_counter()
  if stream.pins is not None:
    pl_, pb_, si_, sl_, bg32, cap_n = stream.pins
    import jax.numpy as jnp
    dec.decode_slices_full_pins.lower(
      *base, win(pl_), win(pb_), win(si_), win(sl_), jnp.int32(bg32),
      sx=h.sx, sy=h.sy, permissible=stream.permissible,
      cap_n=cap_n).compile()
  else:
    offs, keys, lo, hi = stream.flat
    dec.decode_slices_full.lower(
      *base, win(offs), keys, lo, hi, sx=h.sx, sy=h.sy,
      permissible=stream.permissible).compile()
  return time.perf_counter() - t0


def serve(name, binary, want):
  """Upload a stream, decode it whole with the device CRC check, and
  compare with want. Returns the DeviceStream."""
  import jax
  from crackle_tpu.kernels import engine
  t0 = time.perf_counter()
  stream = engine.upload_stream(binary)
  if not isinstance(stream, engine.DeviceStream):
    raise RuntimeError(f"{name}: upload_stream declined the stream")
  jax.block_until_ready(stream.packed)
  t_up = time.perf_counter() - t0
  sz = stream.head.sz
  t_c = compile_seconds(stream, 0, sz)
  t0 = time.perf_counter()
  labels, cc, N = stream.decode_window(0, sz, check_crcs=True)
  jax.block_until_ready(labels)
  t_first = time.perf_counter() - t0
  got = stream_to_volume(labels, stream.head, 0, sz)
  if not np.array_equal(got, want):
    raise AssertionError(f"{name}: device decode differs from host")
  t_ss = median_seconds(
    lambda: jax.block_until_ready(stream.decode_window(0, sz)[0]))
  vox = stream.head.sx * stream.head.sy * sz
  log(f"{name}: upload {ms(t_up)}, compile {ms(t_c)}, first decode "
      f"(CRC-checked) {ms(t_first)}, steady-state {ms(t_ss)} "
      f"({vox / t_ss / 1e6:.1f} MVx/s); {stream.nbytes_device} B on "
      f"device; equal to host decode")
  return stream


def phase_b(binary):
  import jax.numpy as jnp
  import crackle_tpu as crackle
  from crackle_tpu import native
  from crackle_tpu.headers import FormatError
  head = crackle.header(binary)
  t0 = time.perf_counter()
  vol = native.decompress_stream(
    binary, 0, head.sz, (head.sx, head.sy, head.sz), head.data_width,
    head.fortran_order)
  if vol is None:
    raise RuntimeError("native host decoder unavailable")
  log(f"(b) native host decode 512^3: {ms(time.perf_counter() - t0)}")
  bad_z = head.sz // 4 + 9
  stream = serve("(b) 512^3 flat u32", binary, vol)
  good = stream.crcs
  bad = np.asarray(good).copy()
  bad[bad_z] ^= 1
  stream.crcs = jnp.asarray(bad)
  try:
    stream.decode_window(0, head.sz, check_crcs=True)
  except FormatError as e:
    if f"z={bad_z}" not in str(e):
      raise
  else:
    raise AssertionError("corrupted stored CRC was not detected")
  finally:
    stream.crcs = good
  log(f"(b) corrupted stored CRC word at z={bad_z} raised FormatError")
  return vol


def phase_c():
  vol = np.asfortranarray(
    np.load(os.path.join(BENCH_DIR, "connectomics_v2_256x256x128.ckl.npz"))
    ["vol"])
  flat = read("connectomics_v2_256x256x128.ckl")
  if not np.array_equal(host_decode(flat), vol):
    raise AssertionError("(c) host decode differs from the .npz raw")
  serve("(c) 256^2x128 flat", flat, vol)
  for name, fname in (
      ("markov-5", "connectomics_v2_mkv5_256x256x128.ckl"),
      ("pins", "connectomics_v2_pins_256x256x128.ckl"),
      ("u64 watershed", "watershed_u64_256x256x128.ckl")):
    binary = read(fname)
    serve(f"(c) 256^2x128 {name}", binary, host_decode(binary))
  return flat, vol


def phase_d(binary, vol):
  import jax
  import crackle_tpu as crackle
  t0 = time.perf_counter()
  arr = crackle.CrackleDeviceArray(binary)
  jax.block_until_ready(arr.stream.packed)
  log(f"(d) CrackleDeviceArray upload: {ms(time.perf_counter() - t0)}")
  sx, sy, sz = arr.shape
  cx, cy, cz = min(256, sx), min(256, sy), min(64, sz)
  rng = np.random.RandomState(SEED)
  times = []
  for _ in range(5):
    x0 = int(rng.randint(0, sx - cx + 1))
    y0 = int(rng.randint(0, sy - cy + 1))
    z0 = int(rng.randint(0, sz - cz + 1))
    box = np.s_[x0:x0 + cx, y0:y0 + cy, z0:z0 + cz]
    t0 = time.perf_counter()
    cut = jax.block_until_ready(arr[box])
    times.append(time.perf_counter() - t0)
    if not np.array_equal(np.asarray(cut), vol[box]):
      raise AssertionError(f"(d) cutout at {(x0, y0, z0)} differs")
  log(f"(d) 5 cutouts {cx}x{cy}x{cz} equal to host: first (compile included) "
      f"{ms(times[0])}, steady-state median {ms(np.median(times[1:]))}")


def phase_e(vols):
  import jax
  import jax.numpy as jnp
  import crackle_tpu as crackle
  for name, vol in vols:
    t0 = time.perf_counter()
    want = crackle.compress(vol)
    t_host = time.perf_counter() - t0
    dev = jax.block_until_ready(jnp.asarray(vol))
    t0 = time.perf_counter()
    got = crackle.compress(dev)
    t_first = time.perf_counter() - t0
    if got != want:
      raise AssertionError(f"(e) {name}: device encode bytes differ")
    t_ss = median_seconds(lambda: crackle.compress(dev), reps=3)
    log(f"(e) compress(jax array) {name}: bytes equal to host compress; "
        f"first (compile included) {ms(t_first)}, steady-state "
        f"{ms(t_ss)}; host compress {ms(t_host)}")


def phase_f(binary):
  from crackle_tpu import codec
  from crackle_tpu.ops import analytics
  if not codec.device_path_on():
    raise AssertionError("(f) device path is off")
  if analytics._device_stats_run(binary) is None:
    raise AssertionError("(f) device stats declined the stream")
  t0 = time.perf_counter()
  vc_d = analytics.voxel_counts(binary)
  bb_d = analytics.bounding_boxes(binary, no_slice_conversion=True)
  t_dev = time.perf_counter() - t0
  prev = codec.get_engine()
  codec.set_engine("numpy")
  try:
    vc_h = analytics.voxel_counts(binary)
    bb_h = analytics.bounding_boxes(binary, no_slice_conversion=True)
  finally:
    codec.set_engine(prev)
  if vc_d != vc_h:
    raise AssertionError("(f) voxel_counts differ")
  if set(bb_d) != set(bb_h) or any(
      not np.array_equal(bb_d[k], bb_h[k]) for k in bb_h):
    raise AssertionError("(f) bounding_boxes differ")
  log(f"(f) voxel_counts + bounding_boxes on device equal to host "
      f"({len(vc_d)} labels, device {ms(t_dev)} with compiles)")


def phase_g(binary):
  import jax
  import jax.numpy as jnp
  from crackle_tpu.headers import CrackFormat
  from crackle_tpu.kernels import crc, decode as dec, engine
  from crackle_tpu.lib import crc32c
  head = engine._codec.header(binary)
  inputs = engine.prepare_slice_inputs(binary, 0, head.sz)
  sx, sy = head.sx, head.sy
  perm = head.crack_format == CrackFormat.PERMISSIBLE
  args = [jnp.asarray(inputs[k])
          for k in ("packed", "nbytes", "nodes", "n_chains")]
  log(f"(g) replay shapes: packed {inputs['packed'].shape} (CAP "
      f"{inputs['packed'].shape[1] * 4} codepoints), nodes "
      f"{inputs['nodes'].shape}")

  replay = jax.jit(lambda *a: dec._decode_vcg_batch(*a, sx, sy, perm))
  t0 = time.perf_counter()
  replay_c = replay.lower(*args).compile()
  t_c = time.perf_counter() - t0
  vcg = jax.block_until_ready(replay_c(*args))
  t_r = median_seconds(lambda: jax.block_until_ready(replay_c(*args)))
  log(f"(g) replay stage (plain XLA scatters), {head.sz} slices: {ms(t_r)} "
      f"(compile {ms(t_c)})")

  ccl_min = jax.jit(lambda v: dec._ccl_min(v, sx, sy))
  t0 = time.perf_counter()
  ccl_min_c = ccl_min.lower(vcg).compile()
  t_c = time.perf_counter() - t0
  _L, sweeps = jax.block_until_ready(ccl_min_c(vcg))
  sweeps = int(sweeps)
  t_s = median_seconds(lambda: jax.block_until_ready(ccl_min_c(vcg)))
  ccl = jax.jit(lambda v: dec._ccl_batch(v, sx, sy)).lower(vcg).compile()
  cc, _N = jax.block_until_ready(ccl(vcg))
  t_ccl = median_seconds(lambda: jax.block_until_ready(ccl(vcg)))
  log(f"(g) CCL sweeps to fixed point: {sweeps} sweeps, {ms(t_s)} "
      f"({ms(t_s / sweeps)} per sweep; compile {ms(t_c)}); with the "
      f"first-visit renumber {ms(t_ccl)}")

  words = jax.block_until_ready(cc.reshape(head.sz, sx * sy))
  got = np.asarray(crc.crc32c_device(words))
  host = np.asarray(words)
  want = np.array([crc32c(np.ascontiguousarray(r.astype("<u4")))
                   for r in host], np.uint32)
  if not np.array_equal(got, want):
    raise AssertionError("(g) device CRC32C differs from host")
  t_crc = median_seconds(
    lambda: jax.block_until_ready(crc.crc32c_device(words)))
  log(f"(g) CRC32C of {head.sz} rows x {sx * sy} words on device: "
      f"{ms(t_crc)}; equal to host crc32c")
  stats = jax.devices()[0].memory_stats() or {}
  if "peak_bytes_in_use" in stats:
    log(f"peak device memory: {stats['peak_bytes_in_use'] / 2**30:.2f} "
        f"GiB")


def phase_four(binary):
  import jax
  import crackle_tpu as crackle
  from crackle_tpu import parallel
  from crackle_tpu.kernels import engine
  devices = jax.devices()
  if len(devices) < 4:
    raise RuntimeError(f"--four needs 4 GPUs, JAX sees {len(devices)}")
  mesh = parallel.make_mesh(devices[:4])
  head = crackle.header(binary)
  stream = engine.upload_stream(binary)
  labels, _cc, _N = stream.decode_window(0, head.sz, check_crcs=True)
  single = stream_to_volume(labels, head, 0, head.sz)
  del stream, labels
  t0 = time.perf_counter()
  out = parallel.decompress_sharded(binary, mesh)
  t_first = time.perf_counter() - t0
  if out is None or not np.array_equal(out, single):
    raise AssertionError("sharded decode differs from single-card")
  t_ss = median_seconds(lambda: parallel.decompress_sharded(binary, mesh),
                        reps=3)
  log(f"(four) decompress_sharded 512^3 over 4 cards equal to the "
      f"single-card decode: first {ms(t_first)}, steady-state "
      f"{ms(t_ss)} (to host memory)")
  want = crackle.compress(single)
  t0 = time.perf_counter()
  enc = parallel.compress_sharded(single, mesh)
  t_first = time.perf_counter() - t0
  if enc != want:
    raise AssertionError("sharded encode bytes differ from host")
  t_ss = median_seconds(lambda: parallel.compress_sharded(single, mesh),
                        reps=3)
  log(f"(four) compress_sharded 512^3 over 4 cards: bytes equal to host "
      f"compress; first {ms(t_first)}, steady-state {ms(t_ss)}")


def main(argv=None):
  ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
  ap.add_argument("--four", action="store_true",
                  help="run only the sharded path on four cards")
  args = ap.parse_args(argv)

  import jax
  backend = jax.default_backend()
  if backend != "gpu":
    print(f"chip_smoke: needs a GPU; JAX's backend is {backend!r}",
          file=sys.stderr)
    return 1
  for line in card_lines():
    log(line)
  log(f"jax.devices(): {jax.devices()}")

  sys.path.insert(0, ROOT)
  import crackle_tpu  # noqa: F401  (fails outside the repository)
  warnings = WarningLog()
  logging.getLogger("crackle_tpu").addHandler(warnings)

  binary = read("connectomics_v2_512x512x512.ckl")
  if args.four:
    phase_four(binary)
  else:
    vol512 = phase_b(binary)
    flat256, vol256 = phase_c()
    phase_d(binary, vol512)
    phase_e([("256^2x128", vol256), ("512^3", vol512)])
    phase_f(flat256)
    if warnings.records:
      raise AssertionError(f"host fallbacks logged: {warnings.records}")
    phase_g(binary)
  dev = jax.devices()[0]
  print(json.dumps({"ok": True, "device": {
    "platform": dev.platform, "kind": dev.device_kind,
    "count": len(jax.devices())}}))
  return 0


if __name__ == "__main__":
  sys.exit(main())
