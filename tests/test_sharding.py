"""Multi-device sharding tests on the virtual 8-device CPU mesh:
sharded decode must be byte-identical to single-device decode."""
import numpy as np
import pytest
import jax

import crackle_tpu as crackle
from crackle_tpu import parallel


def random_volume(shape, num_labels, seed, smooth=0, dtype=np.uint32):
  rng = np.random.RandomState(seed)
  a = rng.randint(0, num_labels, size=shape).astype(dtype)
  for _ in range(smooth):
    axis = rng.randint(0, len(shape))
    m = rng.rand(*shape) < 0.6
    a = np.where(m, np.roll(a, 1, axis=axis), a)
  return np.asfortranarray(a)


def test_virtual_mesh_has_8_devices():
  assert len(jax.devices()) == 8


def test_sharded_decode_matches():
  vol = random_volume((16, 16, 16), 5, seed=0, smooth=4)
  binary = crackle.compress(vol)
  mesh = parallel.make_mesh()
  out = parallel.decompress_sharded(binary, mesh)
  np.testing.assert_array_equal(out, vol)


def test_sharded_decode_unaligned_z():
  # sz not a multiple of the device count
  vol = random_volume((12, 12, 11), 4, seed=1, smooth=3)
  binary = crackle.compress(vol)
  out = parallel.decompress_sharded(binary, parallel.make_mesh())
  np.testing.assert_array_equal(out, vol)


def test_sharded_voxel_counts():
  vol = random_volume((12, 12, 8), 5, seed=2, smooth=2)
  binary = crackle.compress(vol)
  cts = parallel.voxel_counts_sharded(binary, parallel.make_mesh())
  uniq, counts = np.unique(vol, return_counts=True)
  assert cts == {
    int(u): int(c) for u, c in zip(uniq.tolist(), counts.tolist())
  }


def test_sharded_roundtrip_step_runs():
  import jax.numpy as jnp
  from crackle_tpu.kernels import engine

  mesh = parallel.make_mesh()
  ndev = mesh.devices.size
  vol = random_volume((8, 8, 8), 3, seed=3, smooth=3)
  binary = crackle.compress(vol)
  head = crackle.header(binary)
  pass  # crack format handled via the permissible param

  inputs = engine.prepare_slice_inputs(binary, 0, 8)
  step = parallel.sharded_roundtrip_step(
    mesh, 8, 8, permissible=(head.crack_format == 1)
  )

  from crackle_tpu.ops import labels as labels_ops
  from crackle_tpu.lib import compute_dtype
  lb = bytes(crackle.raw_labels(binary))
  n = labels_ops.decode_num_labels(head, lb)
  cpg = labels_ops.components_per_grid(head, lb).astype(np.int64)
  cum = np.concatenate([[0], np.cumsum(cpg)])
  offset = (8 + n * head.stored_data_width
            + head.component_width() * head.num_grids())
  keys = np.frombuffer(lb, offset=offset, dtype=compute_dtype(n))

  cc, counts, z_index = step(
    jnp.asarray(inputs["packed"]), jnp.asarray(inputs["nbytes"]),
    jnp.asarray(inputs["nodes"]), jnp.asarray(inputs["n_chains"]),
    jnp.asarray(keys.astype(np.int32)),
    jnp.asarray(cum[:8].astype(np.int32)),
  )
  uniq, expected_counts = np.unique(vol, return_counts=True)
  lbls = labels_ops.decode_uniq(head, lb)
  got = np.asarray(counts)
  for u, c in zip(uniq.tolist(), expected_counts.tolist()):
    idx = int(np.searchsorted(lbls, u))
    assert got[idx] == c
  np.testing.assert_array_equal(
    np.asarray(z_index), inputs["nbytes"]
  )


def test_decompress_sharded_formats():
  """The sharded full decode (device-side paint) handles pins, markov,
  u64 and unaligned-z streams (shard count does not divide sz)."""
  import crackle_tpu as crackle
  from crackle_tpu import parallel
  mesh = parallel.make_mesh()
  for kwargs, dtype, off, sz in [
      (dict(allow_pins=1), np.uint32, 0, 8),
      (dict(markov_model_order=5), np.uint32, 0, 8),
      (dict(), np.uint64, 2 ** 40, 8),
      (dict(), np.uint32, 0, 11),  # 11 % 8 != 0
  ]:
    vol = random_volume((18, 14, sz), 5, 7, 5, dtype=dtype)
    if off:
      vol = vol + dtype(off)
    binary = crackle.compress(np.asfortranarray(vol), **kwargs)
    out = parallel.decompress_sharded(binary, mesh)
    assert out is not None
    np.testing.assert_array_equal(out, crackle.decompress(binary))


def test_compress_sharded_byte_identity():
  """Multi-chip encode: per-voxel stages shard over the mesh; the
  assembled stream must be byte-identical to single-process compress.

  The CPU mesh runs the same XLA step as a GPU mesh (a regression
  once made this path silently return None)."""
  from crackle_tpu.parallel import sharding
  for shape, nl, seed, smooth, dtype in [
      ((24, 24, 16), 8, 61, 4, np.uint32),   # z divisible by 8
      ((20, 18, 11), 6, 62, 3, np.uint32),   # ragged z -> padded shard
      ((16, 16, 3), 2, 63, 0, np.uint32),    # noisy -> impermissible
      ((16, 16, 8), 5, 64, 4, np.uint64),    # u64 (lo/hi planes)
  ]:
    vol = random_volume(shape, nl, seed, smooth, dtype=dtype)
    if dtype == np.uint64:
      vol = vol + np.uint64(2) ** 40
    want = crackle.compress(vol)
    got = sharding.compress_sharded(vol, parallel.make_mesh())
    assert got is not None
    assert got == want, f"shape {shape}: sharded encode bytes differ"


def test_dryrun_multichip_as_driver():
  """Run the driver's multichip dryrun exactly as the driver does:
  import __graft_entry__ and call dryrun_multichip(8) on the virtual
  8-device CPU mesh, with no test-only monkeypatching. Round 4
  shipped MULTICHIP ok:false because CI never did this."""
  import sys, os
  sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
  try:
    import __graft_entry__ as graft
    graft.dryrun_multichip(8)
  finally:
    sys.path.pop(0)
