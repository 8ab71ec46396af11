"""The JAX decode engine must agree exactly with the numpy engine
(which is itself oracle-verified against sequential semantics)."""
import numpy as np
import pytest

import crackle_tpu as crackle
from crackle_tpu.kernels import engine


def random_volume(shape, num_labels, seed, smooth=0, dtype=np.uint32):
  rng = np.random.RandomState(seed)
  a = rng.randint(0, num_labels, size=shape).astype(dtype)
  for _ in range(smooth):
    axis = rng.randint(0, len(shape))
    m = rng.rand(*shape) < 0.6
    a = np.where(m, np.roll(a, 1, axis=axis), a)
  return np.asfortranarray(a)


CASES = [
  ((9, 9, 4), 4, 0, 0),
  ((16, 16, 4), 5, 1, 4),
  ((16, 16, 4), 2, 2, 0),   # noisy -> permissible
  ((33, 17, 3), 6, 3, 6),   # smooth -> impermissible
  ((8, 8, 2), 1, 4, 0),     # constant
  ((64, 64, 4), 12, 5, 6),
  ((1, 1, 1), 2, 6, 0),
  ((5, 1, 3), 3, 7, 0),
]


@pytest.mark.parametrize("shape,nl,seed,smooth", CASES)
def test_jax_decode_matches_numpy(shape, nl, seed, smooth):
  vol = random_volume(shape, nl, seed, smooth)
  binary = crackle.compress(vol)
  out = engine.decode_window(binary, 0, shape[2])
  assert out is not None
  np.testing.assert_array_equal(out, vol)


def test_jax_decode_z_window():
  vol = random_volume((12, 10, 8), 5, 11, 4)
  binary = crackle.compress(vol)
  out = engine.decode_window(binary, 2, 6)
  np.testing.assert_array_equal(out, vol[:, :, 2:6])


def test_jax_decode_ccl_matches_numpy_ccl():
  from crackle_tpu.ops.ccl import connected_components_slice
  vol = random_volume((32, 32, 4), 6, 13, 5)
  binary = crackle.compress(vol)
  cc, N = engine.decode_window_ccl(binary, 0, 4)
  sxy = 32 * 32
  flat = vol.ravel(order='F')
  for z in range(4):
    expected, n_expected = connected_components_slice(
      flat[z * sxy:(z + 1) * sxy], 32, 32
    )
    assert int(N[z]) == n_expected
    np.testing.assert_array_equal(cc[z], expected.astype(np.int32))


def test_jax_decode_binary_label():
  vol = random_volume((10, 10, 4), 5, 17, 3)
  binary = crackle.compress(vol)
  lbl = int(np.unique(vol)[1])
  out = engine.decode_window(binary, 0, 4, label=lbl)
  np.testing.assert_array_equal(out, vol == lbl)


def test_jax_decode_crc_detects_corruption():
  vol = random_volume((10, 10, 4), 5, 19, 3)
  binary = bytearray(crackle.compress(vol))
  # corrupt a crack code byte
  head = crackle.header(bytes(binary))
  gi = crackle.codec.grid_index(bytes(binary))
  binary[int(gi[0]) + 6] ^= 0xFF
  with pytest.raises(crackle.FormatError):
    engine.decode_window(bytes(binary), 0, 4)


@pytest.mark.parametrize("order", [1, 3, 5])
def test_jax_decode_markov_stream(order):
  """Markov streams rank-decode on the host but replay on device."""
  vol = random_volume((24, 20, 5), 6, 21 + order, 5)
  binary = crackle.compress(vol, markov_model_order=order)
  assert crackle.header(binary).markov_model_order == order
  out = engine.decode_window(binary, 0, 5)
  assert out is not None
  np.testing.assert_array_equal(out, vol)


def blocky_volume(shape, block, num_labels, seed, dtype=np.uint32):
  """Large contiguous blobs: forces pixel_pairs >= voxels/2 so the
  encoder picks IMPERMISSIBLE + condensed pins when allowed."""
  rng = np.random.RandomState(seed)
  sx, sy, sz = shape
  bx, by, bz = -(-sx // block), -(-sy // block), -(-sz // block)
  coarse = rng.randint(0, num_labels, size=(bx, by, bz)).astype(dtype)
  vol = coarse.repeat(block, 0).repeat(block, 1).repeat(block, 2)
  return np.asfortranarray(vol[:sx, :sy, :sz])


@pytest.mark.parametrize("optimize", [1, 2])
def test_jax_decode_pins_stream(optimize):
  """Condensed-pins label painting runs on device (gather + table)."""
  from crackle_tpu.headers import LabelFormat
  vol = blocky_volume((20, 18, 6), 4, 5, 31 + optimize)
  binary = crackle.compress(vol, allow_pins=optimize)
  assert (crackle.header(binary).label_format
          == LabelFormat.PINS_VARIABLE_WIDTH)
  out = engine.decode_window(binary, 0, 6)
  assert out is not None
  np.testing.assert_array_equal(out, vol)


def test_jax_decode_pins_markov_window():
  from crackle_tpu.headers import LabelFormat
  vol = blocky_volume((16, 16, 8), 4, 4, 77)
  binary = crackle.compress(vol, allow_pins=1, markov_model_order=2)
  assert (crackle.header(binary).label_format
          == LabelFormat.PINS_VARIABLE_WIDTH)
  out = engine.decode_window(binary, 2, 7)
  assert out is not None
  np.testing.assert_array_equal(out, vol[:, :, 2:7])


def test_jax_decode_u64_plant_interpret():
  """u64 labels paint through the lo/hi planes of the flat paint."""
  vol = random_volume((16, 12, 3), 5, 91, 4).astype(np.uint64)
  vol = np.asfortranarray(vol + np.uint64(0x1_0000_0000))
  binary = crackle.compress(vol)
  out = engine.decode_window(binary, 0, 3)
  assert out is not None
  assert out.dtype == np.uint64
  np.testing.assert_array_equal(out, vol)


def test_jax_decode_u32_plant_interpret():
  vol = random_volume((16, 16, 4), 6, 95, 5)
  binary = crackle.compress(vol)
  out = engine.decode_window(binary, 0, 4)
  assert out is not None
  np.testing.assert_array_equal(out, vol)


def test_device_stream_decode_interpret():
  """upload_stream parks the parsed sections on device; window decodes
  must match the host oracle with no further host parsing."""
  vol = random_volume((32, 24, 6), 9, 7, 4)
  binary = crackle.compress(vol)
  stream = engine.upload_stream(binary)
  assert stream is not None
  for z0, z1 in [(0, 6), (2, 5)]:
    labels, cc, N = stream.decode_window(z0, z1)
    got = np.asarray(labels).astype(vol.dtype) \
      .reshape(z1 - z0, 24, 32).transpose(2, 1, 0)
    np.testing.assert_array_equal(got, vol[:, :, z0:z1])


def test_device_stream_u64_windows():
  """u64 flat streams serve from a DeviceStream with the lo/hi paint
  and device crc checks."""
  vol = random_volume((20, 14, 5), 6, 93, 4).astype(np.uint64)
  vol = np.asfortranarray(vol * np.uint64(0x1_0000_0001))
  binary = crackle.compress(vol)
  stream = engine.upload_stream(binary)
  assert stream is not None and stream.flat[3] is not None
  for z0, z1 in [(0, 5), (1, 3)]:
    labels, cc, N = stream.decode_window(z0, z1, check_crcs=True)
    assert labels.dtype == np.uint64
    got = np.asarray(labels).reshape(z1 - z0, 14, 20).transpose(2, 1, 0)
    np.testing.assert_array_equal(got, vol[:, :, z0:z1])


def test_device_crc32c_matches_reference():
  """CRC32C as bit-linear matrix products must equal the byte-serial
  reference implementation (lib.crc32c / src/crc.hpp semantics)."""
  from crackle_tpu.kernels import crc
  from crackle_tpu.lib import crc32c
  rng = np.random.RandomState(5)
  for W in (1, 3, 129, 511, 512, 513, 4096):
    msgs = rng.randint(0, 2 ** 32, size=(4, W), dtype=np.uint32)
    got = np.asarray(crc.crc32c_device(msgs.view(np.int32)))
    want = np.array(
      [crc32c(np.ascontiguousarray(m.astype('<u4'))) for m in msgs],
      np.uint32)
    np.testing.assert_array_equal(got, want)


def test_device_crc32c_large_message():
  """Messages with 32*W > 2^24 bit-count sums: the per-plane parity
  must stay exact (regression: a single f32 accumulator across all 32
  bitplanes rounds and corrupts the parity at this size)."""
  from crackle_tpu.kernels import crc
  from crackle_tpu.lib import crc32c
  rng = np.random.RandomState(11)
  W = 600_001  # > 2^24 / 32, and not a multiple of the block size
  msgs = rng.randint(0, 2 ** 32, size=(2, W), dtype=np.uint32)
  got = np.asarray(crc.crc32c_device(msgs.view(np.int32)))
  want = np.array(
    [crc32c(np.ascontiguousarray(m.astype('<u4'))) for m in msgs],
    np.uint32)
  np.testing.assert_array_equal(got, want)


def test_device_stream_crc_check():
  """DeviceStream.decode_window(check_crcs=True) verifies per-slice
  crack crcs on device and flags corruption."""
  from crackle_tpu.headers import FormatError
  vol = random_volume((32, 24, 4), 7, 21, 4)
  binary = crackle.compress(vol)
  stream = engine.upload_stream(binary)
  assert stream is not None and stream.crcs is not None
  labels, cc, N = stream.decode_window(0, 4, check_crcs=True)
  got = np.asarray(labels).astype(vol.dtype) \
    .reshape(4, 24, 32).transpose(2, 1, 0)
  np.testing.assert_array_equal(got, vol)
  # corrupt a stored crc word: the device check must catch it
  import jax.numpy as jnp
  bad = np.asarray(stream.crcs).copy()
  bad[2] ^= 0x1
  stream.crcs = jnp.asarray(bad)
  with pytest.raises(FormatError, match="z=2"):
    stream.decode_window(0, 4, check_crcs=True)


# ---------------------------------------------------------------------------
# XLA replay and CCL against the numpy oracles (ops/crackcode, ops/ccl)
# ---------------------------------------------------------------------------

def spiral_volume():
  """A square spiral path: one region whose boundary is a single long
  branch-poor curve, so sorted depth segments span thousands of
  events and moves unwind far from their scope opening."""
  vol = np.zeros((65, 65, 1), dtype=np.uint32)
  x0 = y0 = 0
  x1 = y1 = 64
  while x1 > x0:
    vol[x0:x1 + 1, y0, 0] = 1
    vol[x1, y0:y1 + 1, 0] = 1
    vol[x0:x1 + 1, y1, 0] = 1
    if y0 + 2 <= y1:
      vol[x0, y0 + 2:y1 + 1, 0] = 1
    x0 += 2; y0 += 2; x1 -= 2; y1 -= 2
  return np.asfortranarray(vol)


# (shape, num_labels, seed, smooth) volumes, or a named special volume
REPLAY_CASES = {
  "replay_kernel_interpret-0": [((64, 48, 3), 14, 123, 0)],
  "replay_kernel_interpret-6": [((64, 48, 3), 14, 123, 6)],
  "big_matches_numpy-9x9x4": [((9, 9, 4), 4, 31, 0)],
  "big_matches_numpy-16x16x3-branches": [((16, 16, 3), 5, 32, 4)],
  "big_matches_numpy-16x16x3-noisy": [((16, 16, 3), 2, 33, 0)],
  "big_matches_numpy-33x17x3": [((33, 17, 3), 6, 34, 6)],
  "big_matches_numpy-constant": [((8, 8, 2), 1, 35, 0)],
  "big_matches_numpy-5x1x3": [((5, 1, 3), 3, 36, 0)],
  "big_wide_slices-513": [((513, 6, 2), 5, 41, 3)],
  "big_wide_slices-600": [((600, 9, 2), 7, 42, 4)],
  "big_wide_slices-520": [((520, 5, 1), 2, 43, 0)],
  "big_long_scope_across_chunks": ["spiral"],
  "big_long_stream_two_key_sort": [((128, 128, 1), 2, 44, 0)],
  "big_compact_cancel_path": ["spiral", ((33, 17, 3), 6, 34, 6),
                              ((16, 16, 3), 2, 33, 0)],
}


@pytest.mark.parametrize("case", list(REPLAY_CASES))
def test_xla_replay_matches_oracle(case):
  """The XLA replay (decode._decode_vcg_batch) must reproduce the numpy
  oracle's VCG for every slice, and the full device decode the
  volume, across wide slices, long streams (int64 sort keys above
  16384 codepoints) and long-range scope unwinds."""
  import jax.numpy as jnp
  from crackle_tpu import codec
  from crackle_tpu.headers import CrackFormat
  from crackle_tpu.kernels import decode
  from crackle_tpu.ops import crackcode
  for spec in REPLAY_CASES[case]:
    vol = spiral_volume() if spec == "spiral" else random_volume(*spec)
    sz = vol.shape[2]
    binary = crackle.compress(vol)
    inputs = engine.prepare_slice_inputs(binary, 0, sz)
    head = inputs["head"]
    permissible = head.crack_format == CrackFormat.PERMISSIBLE
    vcg = np.asarray(decode.decode_slices_to_vcg(
      jnp.asarray(inputs["packed"]), jnp.asarray(inputs["nbytes"]),
      jnp.asarray(inputs["nodes"]), jnp.asarray(inputs["n_chains"]),
      sx=head.sx, sy=head.sy, permissible=permissible))
    codes = codec.crack_codes(binary)
    for z in range(sz):
      want = crackcode.slice_code_to_vcg(
        codes[z], head.sx, head.sy, permissible)
      np.testing.assert_array_equal(vcg[z], want)
    if case == "big_long_stream_two_key_sort":
      assert inputs["packed"].shape[1] * 4 > 16384
    np.testing.assert_array_equal(engine.decode_window(binary, 0, sz), vol)


@pytest.mark.parametrize("sy,sx", [
  (40, 48), (41, 48), (42, 48), (43, 48), (44, 48), (45, 48),
])
def test_ccl_sweep_variants_match_xla(sy, sx):
  """The XLA sweep CCL (decode._ccl_batch) must produce the exact
  first-visit numbering of the host CCL oracle (ops/ccl) on random
  connectivity graphs; distinct shapes per case bust trace caching."""
  import jax.numpy as jnp
  from crackle_tpu.kernels import decode as _dec
  from crackle_tpu.ops.ccl import color_connectivity_graph_slice
  rng = np.random.RandomState(sy)
  vcg = (rng.randint(0, 16, size=(2, sy * sx)) & 0b1010).astype(
    np.uint8)
  cc, N = _dec._ccl_batch(jnp.asarray(vcg), sx, sy)
  for b in range(2):
    want, n = color_connectivity_graph_slice(vcg[b], sx, sy)
    np.testing.assert_array_equal(np.asarray(cc)[b], want.astype(np.int32))
    assert int(np.asarray(N)[b]) == n


@pytest.mark.parametrize("dtype", [np.uint32, np.uint64])
def test_xla_paint_matches_host_paint(dtype):
  """decode.paint_flat (the one device paint for DeviceStream, window
  decode and the sharded decode) must equal the host flat-label paint
  (ops/labels.decode_flat label maps indexed by the CCL image)."""
  import jax.numpy as jnp
  from crackle_tpu import codec
  from crackle_tpu.kernels import decode as _dec
  from crackle_tpu.ops import labels as labels_ops
  vol = random_volume((24, 20, 4), 9, 11, 4).astype(dtype)
  if dtype == np.uint64:
    vol = vol * np.uint64(0x1_0000_0003)
  vol = np.asfortranarray(vol)
  binary = crackle.compress(vol)
  head = crackle.header(binary)
  cc, _N = engine.decode_window_ccl(binary, 0, 4)
  offs, keys, lo, hi = engine._flat_device_tables(head, binary)
  got = np.asarray(_dec.paint_flat(
    jnp.asarray(cc), jnp.asarray(offs), keys, lo, hi))
  lb = bytes(codec.raw_labels(binary))
  for z in range(4):
    label_map = labels_ops.decode_flat(head, lb, z, z + 1, head.dtype)
    np.testing.assert_array_equal(got[z].astype(head.dtype),
                                  label_map[cc[z]])


@pytest.mark.parametrize("order", [1, 3, 5, 7])
def test_markov_stream_device_path(order):
  """Markov streams are DeviceStream-eligible: the serial rank decode
  runs once at upload (host, threaded across slices like the
  reference's markov.hpp:268-323 pool); every window decode after
  that is pure device work, crc-gated."""
  vol = random_volume((40, 40, 6), 20, 71, 5)
  binary = crackle.compress(vol)
  bm = crackle.reencode(binary, markov_model_order=order)
  stream = engine.upload_stream(bm)
  assert stream is not None
  labels, cc, N = stream.decode_window(0, 6, check_crcs=True)
  got = np.asarray(labels).astype(vol.dtype) \
    .reshape(6, 40, 40).transpose(2, 1, 0)
  np.testing.assert_array_equal(got, vol)


def test_pins_device_stream_windows():
  """Condensed-pins streams park in device memory via upload_stream
  (like flat streams) and serve arbitrary z windows with crc
  checking."""
  rng = np.random.RandomState(9)
  vol = rng.randint(0, 4, size=(20, 18, 10)).astype(np.uint32)
  for _ in range(12):
    ax = rng.randint(0, 3)
    m = rng.rand(*vol.shape) < 0.6
    vol = np.where(m, np.roll(vol, 1, axis=ax), vol)
  vol = np.asfortranarray(vol)
  binary = crackle.compress(vol, allow_pins=1)
  head = crackle.header(binary)
  assert head.label_format == 2, "volume did not trigger pin encoding"
  stream = engine.upload_stream(binary)
  assert stream is not None and stream.pins is not None
  for z0, z1 in [(0, 10), (3, 7), (9, 10)]:
    labels, cc, N = stream.decode_window(z0, z1, check_crcs=True)
    got = np.asarray(labels).astype(vol.dtype) \
      .reshape(z1 - z0, 18, 20).transpose(2, 1, 0)
    np.testing.assert_array_equal(got, vol[:, :, z0:z1])


def test_split_decode_long_slices(monkeypatch):
  """Slices beyond the device replay capacity split at chain
  boundaries into virtual slices; piece VCGs merge on device and the
  CCL matches the host engine exactly. (Splitting requires multiple
  chains — a checkerboard of squares gives one closed-loop chain per
  square; single-giant-chain streams like binary noise stay on the
  host path by design.)"""
  from crackle_tpu.kernels import engine
  from crackle_tpu.ops.ccl import connected_components_slice
  # isolated 3x3 islands on background: each island's boundary loop
  # is its own connected crack component, hence its own chain
  vol = np.ones((48, 40, 3), np.uint32)
  k = 2
  for x0 in range(1, 45, 6):
    for y0 in range(1, 37, 6):
      for z in range(3):
        vol[x0:x0 + 3, y0:y0 + 3, z] = k
        k += 1
  vol = np.asfortranarray(vol)
  binary = crackle.compress(vol)
  monkeypatch.setattr(engine, "SPLIT_TARGET_CPS", 512)
  res = engine._decode_ccl_split(binary, 0, 3)
  assert res is not None
  cc, N, head = res
  cc = np.asarray(cc)
  for z in range(3):
    flat = np.ascontiguousarray(vol[:, :, z].T).ravel()
    want, wn = connected_components_slice(flat, 48, 40)
    np.testing.assert_array_equal(cc[z], want.astype(np.int32))
    assert int(np.asarray(N)[z]) == wn

  # dispatcher integration: an artificially tiny cap routes the
  # normal entry point through the split path with crc checking
  monkeypatch.setattr(engine, "MAX_DEVICE_CAP", 1024)
  out = engine.decode_window_ccl(binary, 0, 3, check_crcs=True)
  assert out is not None
  np.testing.assert_array_equal(out[0][2], cc[2])
