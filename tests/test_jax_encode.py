"""Device-side encode components must agree with the host ops."""
import numpy as np
import jax.numpy as jnp

import crackle_tpu as crackle
from crackle_tpu.kernels import encode as enc
from crackle_tpu.ops.ccl import connected_components_slice


def random_slices(B, sy, sx, nl, seed, smooth=0):
  rng = np.random.RandomState(seed)
  a = rng.randint(0, nl, size=(B, sy, sx)).astype(np.uint32)
  for _ in range(smooth):
    axis = 1 + rng.randint(0, 2)
    a = np.where(rng.rand(B, sy, sx) < 0.6, np.roll(a, 1, axis=axis), a)
  return a


def test_labels_to_vcg_matches_equality():
  a = random_slices(3, 16, 16, 4, seed=0, smooth=2)
  vcg = np.asarray(enc.labels_to_vcg(jnp.asarray(a), 16, 16))
  v = vcg.reshape(3, 16, 16)
  same_x = a[:, :, :-1] == a[:, :, 1:]
  np.testing.assert_array_equal((v[:, :, :-1] & 1) > 0, same_x)
  np.testing.assert_array_equal((v[:, :, 1:] & 2) > 0, same_x)
  same_y = a[:, :-1, :] == a[:, 1:, :]
  np.testing.assert_array_equal((v[:, :-1, :] & 4) > 0, same_y)
  np.testing.assert_array_equal((v[:, 1:, :] & 8) > 0, same_y)
  # border bits clear
  assert ((v[:, :, -1] & 1) == 0).all()
  assert ((v[:, :, 0] & 2) == 0).all()


def test_device_ccl_matches_host():
  a = random_slices(4, 24, 17, 5, seed=1, smooth=3)
  cc, N = enc.ccl_from_labels(jnp.asarray(a), 17, 24)
  cc, N = np.asarray(cc), np.asarray(N)
  for z in range(4):
    expected, n_exp = connected_components_slice(
      a[z].ravel(), 17, 24
    )
    assert N[z] == n_exp
    np.testing.assert_array_equal(cc[z], expected.astype(np.int32))


def test_format_stats():
  a = np.asfortranarray(random_slices(1, 8, 8, 3, seed=2)[0].T)
  flat = a.ravel(order='F')
  pairs, mx = enc.format_stats(jnp.asarray(flat))
  assert int(pairs) == int(np.count_nonzero(flat[1:] == flat[:-1]))
  assert int(mx) == int(flat.max())


def test_component_labels_match_flat_mapping():
  a = random_slices(3, 12, 12, 4, seed=3, smooth=2)
  cc, N = enc.ccl_from_labels(jnp.asarray(a), 12, 12)
  tables = np.asarray(enc.component_labels(
    jnp.asarray(a), cc, N, 12, 12
  ))
  cch = np.asarray(cc)
  for z in range(3):
    n = int(np.asarray(N)[z])
    _, first_idx = np.unique(cch[z], return_index=True)
    expected = a[z].ravel()[first_idx]
    np.testing.assert_array_equal(tables[z, :n], expected)


# ---------------------------------------------------------------------------
# full device encode: byte identity with the host encoder
# ---------------------------------------------------------------------------

import pytest


@pytest.fixture
def device_encode():
  """Turn the device path on (codec.device_path_on) so the XLA encode
  stages run here on the CPU backend."""
  from crackle_tpu import codec
  prev = codec.get_engine()
  codec.set_engine('jax')
  yield
  codec.set_engine(prev)


def random_volume(shape, nl, seed, smooth=0, dtype=np.uint32):
  rng = np.random.RandomState(seed)
  a = rng.randint(0, nl, size=shape).astype(dtype)
  for _ in range(smooth):
    axis = rng.randint(0, len(shape))
    a = np.where(rng.rand(*shape) < 0.6, np.roll(a, 1, axis=axis), a)
  return np.asfortranarray(a)


DEVICE_ENCODE_CASES = [
  ((32, 32, 4), 8, 50, 4, np.uint32),    # permissible / flat
  ((24, 24, 3), 3, 51, 0, np.uint32),    # noisy -> impermissible
  ((16, 16, 2), 5, 52, 3, np.uint8),
  ((40, 17, 3), 300, 53, 2, np.uint16),
  ((16, 16, 3), 6, 54, 3, np.uint64),    # two-plane equality path
  ((16, 16, 1), 1, 55, 0, np.uint32),    # constant slice
]


@pytest.mark.parametrize("shape,nl,seed,smooth,dtype",
                         DEVICE_ENCODE_CASES)
def test_device_encode_byte_identity(device_encode, shape, nl, seed,
                                     smooth, dtype):
  """encode_flat_device must produce byte-identical streams to the
  host encoder (the golden-fixture-validated path)."""
  vol = random_volume(shape, nl, seed, smooth, dtype)
  want = crackle.compress(vol)
  got = enc.encode_flat_device(vol)
  assert got is not None
  assert got == want


def test_device_encode_from_jax_array(device_encode):
  """codec.compress routes device-resident arrays through the device
  encode; the result must round-trip and match the host bytes."""
  vol = random_volume((20, 20, 3), 6, 56, 4)
  want = crackle.compress(vol)
  got = crackle.compress(jnp.asarray(vol))
  assert got == want
  np.testing.assert_array_equal(crackle.decompress(got), vol)


def test_device_encode_forced_engine(device_encode):
  """set_engine('jax') routes numpy inputs through the device
  encode stages too."""
  from crackle_tpu import codec
  vol = random_volume((20, 20, 3), 6, 57, 4)
  want_engine = codec.get_engine()
  codec.set_engine('jax')
  try:
    got = crackle.compress(vol)
  finally:
    codec.set_engine(want_engine)
  assert got == crackle.compress(vol)
