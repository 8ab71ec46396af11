"""Differential tests of the decode-lite analytics against numpy/scipy
oracles (mirrors the reference's cross-library strategy)."""
import numpy as np
import pytest

import crackle_tpu as crackle


def random_volume(shape, num_labels, seed, smooth=0, dtype=np.uint32):
  rng = np.random.RandomState(seed)
  a = rng.randint(0, num_labels, size=shape).astype(dtype)
  for _ in range(smooth):
    axis = rng.randint(0, len(shape))
    m = rng.rand(*shape) < 0.6
    a = np.where(m, np.roll(a, 1, axis=axis), a)
  return np.asfortranarray(a)


def test_voxel_counts():
  vol = random_volume((9, 8, 5), 6, seed=1, smooth=2)
  binary = crackle.compress(vol)
  cts = crackle.voxel_counts(binary)
  uniq, counts = np.unique(vol, return_counts=True)
  assert set(cts.keys()) == set(uniq.tolist())
  for u, c in zip(uniq.tolist(), counts.tolist()):
    assert cts[u] == c


def test_voxel_counts_single_label():
  vol = random_volume((9, 8, 5), 6, seed=2, smooth=2)
  binary = crackle.compress(vol)
  lbl = int(np.unique(vol)[0])
  assert crackle.voxel_counts(binary, label=lbl) == \
      int(np.count_nonzero(vol == lbl))


def test_centroids_against_scipy():
  from scipy import ndimage
  vol = random_volume((9, 8, 5), 5, seed=3, smooth=2)
  binary = crackle.compress(vol)
  cents = crackle.centroids(binary)
  for lbl in np.unique(vol).tolist():
    com = ndimage.center_of_mass(vol == lbl)
    got = cents[lbl]
    np.testing.assert_allclose(got, com, atol=1e-9)


def test_bounding_boxes_against_numpy():
  vol = random_volume((9, 8, 5), 5, seed=5, smooth=2)
  binary = crackle.compress(vol)
  bbxs = crackle.bounding_boxes(binary)
  for lbl in np.unique(vol).tolist():
    xs, ys, zs = np.nonzero(vol == lbl)
    expected = (
      slice(int(xs.min()), int(xs.max()) + 1),
      slice(int(ys.min()), int(ys.max()) + 1),
      slice(int(zs.min()), int(zs.max()) + 1),
    )
    assert bbxs[lbl] == expected, lbl


def test_point_cloud_rectangle():
  """Boundary of an all-background slab is the border ring
  (automated_test:677-708, points unique in our implementation)."""
  arr = np.zeros((13, 8, 1), dtype=np.uint32, order="F")
  binary = crackle.compress(arr)
  ptc = crackle.point_cloud(binary, 0, skip_background=False)
  pts = set(map(tuple, ptc[:, :2].tolist()))
  sx, sy = 13, 8
  expected = set()
  for x in range(sx):
    expected.add((x, 0))
    expected.add((x, sy - 1))
  for y in range(sy):
    expected.add((0, y))
    expected.add((sx - 1, y))
  assert pts == expected


def test_point_cloud_interior_square():
  arr = np.zeros((10, 10, 1), dtype=np.uint32, order="F")
  arr[3:7, 3:7, 0] = 5
  binary = crackle.compress(arr)
  ptc = crackle.point_cloud(binary, 5)
  pts = set(map(tuple, ptc[:, :2].tolist()))
  expected = set()
  for x in range(3, 7):
    for y in range(3, 7):
      if x in (3, 6) or y in (3, 6):
        expected.add((x, y))
  assert pts == expected


def test_voxel_connectivity_graph_4():
  vol = random_volume((7, 7, 3), 3, seed=7, smooth=2)
  binary = crackle.compress(vol)
  vcg = crackle.voxel_connectivity_graph(binary, connectivity=4)
  assert vcg.shape == (7, 7, 3)
  # bit0: +x passable iff labels equal
  for z in range(3):
    sl = vol[:, :, z]
    same_x = sl[:-1, :] == sl[1:, :]
    np.testing.assert_array_equal(
      (vcg[:-1, :, z] & 0b0001) > 0, same_x
    )
    np.testing.assert_array_equal(
      (vcg[1:, :, z] & 0b0010) > 0, same_x
    )
    same_y = sl[:, :-1] == sl[:, 1:]
    np.testing.assert_array_equal(
      (vcg[:, :-1, z] & 0b0100) > 0, same_y
    )
    np.testing.assert_array_equal(
      (vcg[:, 1:, z] & 0b1000) > 0, same_y
    )


def test_voxel_connectivity_graph_6():
  vol = random_volume((7, 7, 4), 3, seed=11, smooth=2)
  binary = crackle.compress(vol)
  vcg = crackle.voxel_connectivity_graph(binary, connectivity=6)
  same_z = vol[:, :, :-1] == vol[:, :, 1:]
  np.testing.assert_array_equal(
    (vcg[:, :, :-1] & 0b010000) > 0, same_z
  )
  np.testing.assert_array_equal(
    (vcg[:, :, 1:] & 0b100000) > 0, same_z
  )
  assert ((vcg[:, :, 0] & 0b100000) > 0).all()
  assert ((vcg[:, :, -1] & 0b010000) > 0).all()


def test_contacts():
  vol = np.zeros((4, 4, 2), dtype=np.uint32, order="F")
  vol[:2, :, :] = 1
  vol[2:, :, :] = 2
  binary = crackle.compress(vol)
  ct = crackle.contacts(binary)
  # interface between 1 and 2 along x: area 4*2 = 8
  assert ct == {(1, 2): 8.0}


def test_contacts_anisotropy():
  vol = np.zeros((4, 4, 2), dtype=np.uint32, order="F")
  vol[:2, :, :] = 1
  vol[2:, :, :] = 2
  binary = crackle.compress(vol)
  ct = crackle.contacts(binary, anisotropy=(2.0, 3.0, 5.0))
  assert ct == {(1, 2): 8 * 15.0}


def test_each():
  vol = random_volume((6, 6, 3), 4, seed=13, smooth=1)
  binary = crackle.compress(vol)
  seen = set()
  for label, img in crackle.each(binary, crop=False):
    seen.add(int(label))
    np.testing.assert_array_equal(img, vol == label)
  assert seen == set(np.unique(vol).tolist())


def test_each_multi():
  vol = random_volume((6, 6, 3), 4, seed=17, smooth=1)
  binary = crackle.compress(vol)
  seen = set()
  for label, tmp_label, img in crackle.each(binary, multi=True):
    seen.add(int(label))
    np.testing.assert_array_equal(img == tmp_label, vol == label)
  assert seen == set(np.unique(vol).tolist())


def test_mode_pooling():
  vol = random_volume((8, 8, 3), 3, seed=19, smooth=5)
  binary = crackle.compress(vol)
  pooled = crackle.mode_pooling_2x2x1(binary)
  out = crackle.decompress(pooled)
  assert out.shape == (4, 4, 3)


def test_connected_components_3d():
  vol = np.zeros((6, 6, 4), dtype=np.uint32, order="F")
  vol[:2, :2, :2] = 5
  vol[4:, 4:, 2:] = 5  # same label, disconnected -> 2 components
  binary = crackle.compress(vol)
  ccl_binary, mapping = crackle.connected_components(
    binary, connectivity=6, return_mapping=True
  )
  out = crackle.decompress(ccl_binary)
  # two regions of label 5 got distinct ids
  id1 = out[0, 0, 0]
  id2 = out[5, 5, 3]
  assert id1 != id2
  assert mapping[int(id1)] == 5
  assert mapping[int(id2)] == 5


def test_cache_meta(tmp_path):
  import pyarrow.parquet as pq
  vol = random_volume((6, 6, 3), 4, seed=23, smooth=1)
  binary = crackle.compress(vol)
  path = str(tmp_path / "meta.parquet")
  crackle.cache_meta(binary, path)
  table = pq.read_table(path)
  uniq, counts = np.unique(vol, return_counts=True)
  np.testing.assert_array_equal(
    table.column('label').to_numpy(), uniq.astype(np.uint64)
  )
  np.testing.assert_array_equal(
    table.column('voxel_count').to_numpy(), counts.astype(np.uint32)
  )


def test_array_facade():
  vol = random_volume((8, 8, 4), 5, seed=29, smooth=2)
  arr = crackle.compressa(vol)
  assert arr.shape == (8, 8, 4)
  assert arr.dtype == vol.dtype
  assert arr.num_labels() == len(np.unique(vol))
  np.testing.assert_array_equal(arr[:, :, 1], vol[:, :, 1])
  np.testing.assert_array_equal(arr[2:5, 1:7, 1:3], vol[2:5, 1:7, 1:3])
  np.testing.assert_array_equal(arr[:, :, :], vol)
  lbl = int(np.unique(vol)[0])
  assert lbl in arr
  assert 10 ** 9 not in arr


def test_array_setitem():
  vol = random_volume((8, 8, 6), 5, seed=31, smooth=2)
  arr = crackle.compressa(vol)
  newdata = random_volume((8, 8, 2), 3, seed=37)
  arr[:, :, 2:4] = newdata
  expected = vol.copy()
  expected[:, :, 2:4] = newdata
  np.testing.assert_array_equal(arr[:, :, :], expected)


def test_remote_array(tmp_path):
  vol = random_volume((8, 8, 5), 4, seed=41, smooth=2)
  binary = crackle.compress(vol)
  path = str(tmp_path / "test.ckl")
  with open(path, 'wb') as f:
    f.write(binary)
  rarr = crackle.rload(path)
  assert rarr.num_labels() == len(np.unique(vol))
  np.testing.assert_array_equal(rarr.labels(), np.unique(vol))
  for z in [0, 2, 4]:
    np.testing.assert_array_equal(rarr[z], vol[:, :, z])


def test_save_load(tmp_path):
  vol = random_volume((8, 8, 3), 4, seed=43)
  p = str(tmp_path / "x.ckl")
  crackle.save(vol, p)
  out = crackle.load(p)
  np.testing.assert_array_equal(out, vol)
  p_gz = str(tmp_path / "x.ckl.gz")
  crackle.save(vol, p_gz)
  out = crackle.load(p_gz)
  np.testing.assert_array_equal(out, vol)
  arr = crackle.aload(p)
  np.testing.assert_array_equal(arr[:, :, :], vol)


# ---------------------------------------------------------------------------
# batched device statistics (kernels/stats.py)
# ---------------------------------------------------------------------------

def test_device_stats_match_host(monkeypatch):
  """voxel_counts / centroids / bounding_boxes through the device
  segment-reduction stats must equal the host loop exactly."""
  import crackle_tpu.ops.analytics as A
  from crackle_tpu import codec

  vol = random_volume((40, 24, 6), 7, 51, 5)
  binary = crackle.compress(vol)
  calls = []
  real = A._device_stats_run
  monkeypatch.setattr(A, "_device_stats_run",
                      lambda b: calls.append(1) or real(b))
  monkeypatch.setattr(codec, "_ENGINE", "jax")
  vc_d = A.voxel_counts(binary)
  cen_d = A.centroids(binary)
  bb_d = A.bounding_boxes(binary, no_slice_conversion=True)
  assert len(calls) == 3

  monkeypatch.setattr(codec, "_ENGINE", "numpy")
  vc_h = A.voxel_counts(binary)
  cen_h = A.centroids(binary)
  bb_h = A.bounding_boxes(binary, no_slice_conversion=True)
  assert len(calls) == 3

  assert vc_d == vc_h
  assert set(cen_d) == set(cen_h)
  for k in cen_h:
    np.testing.assert_allclose(cen_d[k], cen_h[k], rtol=1e-12)
  assert set(bb_d) == set(bb_h)
  for k in bb_h:
    np.testing.assert_array_equal(bb_d[k], bb_h[k])
