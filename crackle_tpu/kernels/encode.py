"""Device-side encode components.

The crack-code DFS trace is intrinsically sequential and stays on the
host (native C++); everything else about encoding is data-parallel and
runs on device:

  * boundary extraction: the voxel connectivity graph of a label
    volume is pure elementwise comparison,
  * per-slice CCL with format-normative numbering (the sweep CCL
    shared with decode),
  * format choice statistics (pixel_pairs, max label) as reductions,
  * per-label/per-component histograms for the label map.

These are the building blocks for a fully sharded encode where only
the per-slice trace round-trips to the host.
"""
import functools

import numpy as np
import jax
import jax.numpy as jnp


@functools.partial(jax.jit, static_argnames=("sx", "sy"))
def labels_to_vcg(labels_zyx, sx: int, sy: int):
  """Label slices -> 4-bit voxel connectivity graphs.

  labels_zyx: (B, sy, sx) label image batch.
  Returns (B, sy*sx) uint8 with bits +x, -x, +y, -y passable
  (= labels equal), matching the decoder's convention.
  """
  a = labels_zyx
  B = a.shape[0]
  right = jnp.zeros(a.shape, bool).at[:, :, :-1].set(
    a[:, :, :-1] == a[:, :, 1:]
  )
  left = jnp.zeros(a.shape, bool).at[:, :, 1:].set(
    a[:, :, 1:] == a[:, :, :-1]
  )
  down = jnp.zeros(a.shape, bool).at[:, :-1, :].set(
    a[:, :-1, :] == a[:, 1:, :]
  )
  up = jnp.zeros(a.shape, bool).at[:, 1:, :].set(
    a[:, 1:, :] == a[:, :-1, :]
  )
  vcg = (right.astype(jnp.uint8)
         | (left.astype(jnp.uint8) << 1)
         | (down.astype(jnp.uint8) << 2)
         | (up.astype(jnp.uint8) << 3))
  return vcg.reshape(B, sy * sx)


def ccl_from_labels(labels_zyx, sx: int, sy: int):
  """Per-slice first-visit CCL of a label batch on device.

  Returns (cc (B, sy*sx) int32, N (B,) int32) identical to the host
  ops.ccl.connected_components_slice numbering."""
  from . import decode as _dec
  vcg = labels_to_vcg(labels_zyx, sx, sy)
  return _dec._ccl_batch(vcg, sx, sy)


@jax.jit
def format_stats(labels_flat):
  """(pixel_pairs, max_label) reductions for the encoder's format
  choice (crackle.hpp:48-55 parity)."""
  a = labels_flat
  pairs = jnp.sum(a[1:] == a[:-1])
  return pairs, jnp.max(a) if a.size else jnp.zeros((), a.dtype)


def component_labels(labels_zyx, cc, N, sx: int, sy: int):
  """Per-component source label (the flat-encode per-slice mapping):
  mapping[k] = label at the k-th component's first-visit voxel.

  Device part returns per-slice dense tables (B, CAP_N); the host
  trims each row to N[z]."""
  B = labels_zyx.shape[0]
  n = sx * sy
  cap_n = int(np.max(np.asarray(N))) if B else 0
  cap_n = max(1, 1 << max(int(cap_n) - 1, 0).bit_length())
  flat_labels = labels_zyx.reshape(B, n)

  @functools.partial(jax.jit, static_argnames=("cap",))
  def tables(flat_labels, cc, cap):
    # first-visit voxel of component k is the first index with cc==k;
    # scatter-min of position per component, then gather the label
    idx = jnp.broadcast_to(jnp.arange(n, dtype=jnp.int32)[None, :],
                           (B, n))
    first = jnp.full((B, cap), n, jnp.int32).at[
      jnp.arange(B)[:, None], cc
    ].min(idx, mode='drop')
    first = jnp.minimum(first, n - 1)
    return jnp.take_along_axis(flat_labels, first, axis=1)

  return tables(flat_labels, cc, cap_n)


# ---------------------------------------------------------------------------
# full device encode (flat labels, markov 0)
# ---------------------------------------------------------------------------

@functools.partial(jax.jit, static_argnames=("sx", "sy", "wide"))
def _encode_stage1(planes, sx: int, sy: int, wide: bool):
  """Per-voxel encode stages on device: VCG + CCL + per-slice crc32c
  + flat num_pairs/max reductions.

  planes: (B, sy, sx) int32 label batch, or a (planes_lo, planes_hi)
  tuple for 64-bit labels carried as two int32 planes (the encode
  never needs 64-bit arrays on device)."""
  from . import crc, decode as _dec
  if wide:
    lo, hi = planes
    B = lo.shape[0]
    eq = lambda a, b: (a == b)
    same_x = eq(lo[:, :, :-1], lo[:, :, 1:]) & eq(hi[:, :, :-1],
                                                  hi[:, :, 1:])
    same_y = eq(lo[:, :-1, :], lo[:, 1:, :]) & eq(hi[:, :-1, :],
                                                  hi[:, 1:, :])
    a = lo
  else:
    a = planes
    B = a.shape[0]
    same_x = a[:, :, :-1] == a[:, :, 1:]
    same_y = a[:, :-1, :] == a[:, 1:, :]
  z = jnp.zeros((B, a.shape[1], 1), bool)
  zy = jnp.zeros((B, 1, a.shape[2]), bool)
  right = jnp.concatenate([same_x, z], axis=2)
  left = jnp.concatenate([z, same_x], axis=2)
  down = jnp.concatenate([same_y, zy], axis=1)
  up = jnp.concatenate([zy, same_y], axis=1)
  vcg = (right.astype(jnp.uint8)
         | (left.astype(jnp.uint8) << 1)
         | (down.astype(jnp.uint8) << 2)
         | (up.astype(jnp.uint8) << 3)).reshape(B, sy * sx)
  cc, N = _dec._ccl_batch(vcg, sx, sy)
  crcs = crc.crc32c_device(cc.reshape(B, sy * sx))
  # flat F-order pixel pairs within the window (x-fastest; includes
  # the row/slice wrap pairs, lib.hpp pixel_pairs parity)
  flat = a.reshape(B * sy * sx)
  if wide:
    flat_hi = hi.reshape(B * sy * sx)
    pairs = jnp.sum((flat[1:] == flat[:-1])
                    & (flat_hi[1:] == flat_hi[:-1]))
  else:
    pairs = jnp.sum(flat[1:] == flat[:-1])
  return vcg, cc, N, crcs, pairs


@jax.jit
def _pack_vcg_nibbles(vcg):
  """(B, n) uint8 4-bit VCGs -> (B, ceil(n/2)) uint8, two pixels per
  byte (even pixel in the low nibble). Halves the device->host fetch
  on the encode path — the VCG is the only O(volume) transfer."""
  B, n = vcg.shape
  if n % 2:
    vcg = jnp.pad(vcg, ((0, 0), (0, 1)))
  v = vcg.reshape(B, -1, 2)
  return v[:, :, 0] | (v[:, :, 1] << 4)


def encode_flat_device(labels, parallel: int = 0,
                       fortran_order: bool = True):
  """Device-path compress for flat labels / markov 0: the per-voxel
  stages (boundary VCG, first-visit CCL, per-component source-label
  tables, per-slice CRC32C, format-choice reductions) run batched on
  device; the host tail is the intrinsically serial per-slice DFS
  trace (native, from the fetched VCG) plus byte assembly — the
  data-parallel analog of the reference's thread-pooled encode
  (crackcodes.hpp:498-521, labels.hpp:30-155). The caller decides
  whether the device path is on (codec.device_path_on).

  labels: (sx, sy, sz) unsigned array (numpy or jax, any order).
  Returns the complete .ckl bytes, or None when the shape/stream
  needs the host path (caller falls back)."""
  from .. import native

  if not native.available():
    return None

  if isinstance(labels, jnp.ndarray) and not isinstance(
      labels, np.ndarray):
    sx, sy, sz = labels.shape
    np_dtype = np.dtype(labels.dtype.name)
  else:
    labels = np.asarray(labels)
    sx, sy, sz = labels.shape
    np_dtype = labels.dtype
  if sx * sy * sz == 0:
    return None

  wide = np_dtype.itemsize == 8
  # device layout: (z, y, x) so slices batch and x rides the lanes
  if isinstance(labels, np.ndarray):
    zyx = np.ascontiguousarray(np.transpose(labels, (2, 1, 0)))
    if wide:
      planes = (jnp.asarray((zyx & 0xffffffff).astype(np.uint32)
                            .view(np.int32)),
                jnp.asarray((zyx >> 32).astype(np.uint32)
                            .view(np.int32)))
    else:
      planes = jnp.asarray(zyx.astype(np.uint32).view(np.int32))
  else:
    zyx = jnp.transpose(labels, (2, 1, 0))
    if wide:
      return None  # device u64 arrays need x64; host path handles it
    planes = zyx.astype(jnp.uint32).view(jnp.int32) \
      if zyx.dtype != jnp.int32 else zyx

  vcg_d, cc_d, N_d, crcs_d, pairs_d = _encode_stage1(
    planes, sx, sy, wide)
  N = np.asarray(N_d)
  if wide:
    t_lo = component_labels(planes[0], cc_d, N, sx, sy)
    t_hi = component_labels(planes[1], cc_d, N, sx, sy)
    tables = (np.asarray(t_lo).view(np.uint32).astype(np.uint64)
              | (np.asarray(t_hi).view(np.uint32)
                 .astype(np.uint64) << 32))
  else:
    tables = np.asarray(
      component_labels(planes, cc_d, N, sx, sy)
    ).view(np.uint32).astype(np.uint64)

  crcs = np.asarray(crcs_d).astype(np.uint32)
  num_pairs = int(np.asarray(pairs_d))

  return assemble_flat_stream(
    vcg_d, tables, N, crcs, num_pairs, sx, sy, sz,
    data_width=np_dtype.itemsize, fortran_order=fortran_order,
    parallel=parallel)


def assemble_flat_stream(vcg, tables, N, crcs, num_pairs,
                         sx: int, sy: int, sz: int, *,
                         data_width: int, fortran_order: bool,
                         parallel: int = 0):
  """Host tail shared by the single-device and sharded encodes: the
  per-slice DFS trace from fetched VCGs (threaded) + flat-label and
  container assembly. Byte-identical to codec.compress.

  vcg (sz, sy*sx) u8 — numpy, or a device array (fetched here in
  nibble-packed chunks overlapped with tracing); tables (sz, cap)
  u64, N (sz,), crcs (sz,) u32, num_pairs: flat F-order pixel-pair
  count of the full volume."""
  from .. import codec as _codec
  from ..headers import CrackleHeader, CrackFormat, LabelFormat
  from ..lib import compute_byte_width, width2dtype, crc32c, itoc
  from .. import native

  voxels = sx * sy * sz
  permissible = num_pairs < voxels // 2
  crack_format = (CrackFormat.PERMISSIBLE if permissible
                  else CrackFormat.IMPERMISSIBLE)

  mapping = np.concatenate([tables[z, :N[z]] for z in range(sz)]) \
    if sz else np.zeros(0, np.uint64)
  uniq = np.unique(mapping)
  max_label = int(uniq[-1]) if len(uniq) else 0
  stored_width = compute_byte_width(max_label)
  stored_dtype = width2dtype[stored_width]

  # per-slice DFS trace (threaded; the native call releases the GIL).
  # A device-resident VCG fetches in nibble-packed chunks with the
  # d2h transfers issued asynchronously up front, so tracing chunk k
  # overlaps the transfer of chunk k+1.
  sxy = sx * sy
  codes: list = [None] * sz
  n_threads = _codec._pool_size(parallel, sz)

  def one(z, vz):
    codes[z] = native.encode_slice_vcg(vz, sx, sy, permissible)

  is_dev = not isinstance(vcg, np.ndarray)
  if is_dev:
    packed = _pack_vcg_nibbles(vcg)
    CH = max(1, (4 << 20) // max(sxy // 2, 1))  # ~4 MB chunks
    chunks = [packed[z0:min(z0 + CH, sz)]
              for z0 in range(0, sz, CH)]
    for c in chunks:
      try:
        c.copy_to_host_async()
      except Exception:  # noqa: BLE001 - async prefetch is best-effort
        break

    def unpack(p):
      p = np.asarray(p)
      out = np.empty((p.shape[0], p.shape[1] * 2), np.uint8)
      out[:, 0::2] = p & 0x0F
      out[:, 1::2] = p >> 4
      return out[:, :sxy]

    from concurrent.futures import ThreadPoolExecutor
    with ThreadPoolExecutor(max(n_threads, 1)) as pool:
      futs = []
      z0 = 0
      for c in chunks:
        vcg_np = unpack(c)
        for i in range(vcg_np.shape[0]):
          futs.append(pool.submit(one, z0 + i, vcg_np[i]))
        z0 += vcg_np.shape[0]
      for f in futs:
        f.result()
  elif n_threads <= 1 or sz <= 1:
    for z in range(sz):
      one(z, vcg[z])
  else:
    from concurrent.futures import ThreadPoolExecutor
    with ThreadPoolExecutor(n_threads) as pool:
      list(pool.map(lambda z: one(z, vcg[z]), range(sz)))
  if any(c is None for c in codes):
    return None

  keys = np.searchsorted(uniq, mapping)
  key_width = compute_byte_width(len(uniq))
  component_width = compute_byte_width(sxy)
  labels_binary = b''.join([
    itoc(len(uniq), 8),
    np.ascontiguousarray(uniq.astype(stored_dtype)).tobytes(),
    np.ascontiguousarray(
      np.asarray(N).astype(np.uint64)
      .astype(width2dtype[component_width])
    ).tobytes(),
    np.ascontiguousarray(keys.astype(width2dtype[key_width])).tobytes(),
  ])

  head = CrackleHeader(
    label_format=LabelFormat.FLAT,
    crack_format=crack_format,
    data_width=data_width,
    stored_data_width=stored_width,
    sx=sx, sy=sy, sz=sz,
    num_label_bytes=len(labels_binary),
    fortran_order=fortran_order,
    grid_size=2 ** 31,
    signed=False,
    markov_model_order=0,
    is_sorted=True,
  )
  z_index = np.array([len(c) for c in codes], dtype='<u4').tobytes()
  z_index += itoc(crc32c(z_index), 4)
  return b''.join([
    head.tobytes(),
    z_index,
    labels_binary,
    *codes,
    itoc(crc32c(labels_binary), 4),
    np.asarray(crcs, dtype='<u4').tobytes(),
  ])
