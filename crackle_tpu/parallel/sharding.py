"""Multi-chip / multi-host scaling via jax.sharding.

The codec's parallel axis is z: slices are independent streams, so
decode and the per-slice analytics shard data-parallel over a 1-D
device mesh with no communication; the cross-slice reductions
(label dictionaries, histograms, stream assembly) use XLA collectives
(all_gather / psum) between the devices.

This replaces the reference's shared-memory thread pool
(threadpool.hpp) as the scaling mechanism; see SURVEY.md section 2.5.
"""
import functools
import logging
from typing import Optional, Tuple

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..headers import CrackFormat, LabelFormat
from ..lib import compute_dtype
from .. import codec as _codec
from ..ops import labels as _labels_ops
from ..kernels import decode as _dec
from ..kernels import engine as _engine


logger = logging.getLogger("crackle_tpu.parallel")


def _fallback(fn: str, reason: str):
  """Every None return in this module routes through here so callers
  (and the driver's dryrun) can tell 'unsupported stream' from
  'broken code path' — the round-4 silent-None regression class."""
  logger.warning("%s: falling back to host path: %s", fn, reason)
  return None


def make_mesh(devices=None, axis_name: str = "z") -> Mesh:
  """1-D device mesh over the z (slice) axis."""
  if devices is None:
    devices = jax.devices()
  return Mesh(np.asarray(devices), (axis_name,))


def _pad_batch(arrs: dict, B: int, ndev: int):
  """Pad the batch axis to a multiple of the device count."""
  pad = (-B) % ndev
  if pad == 0:
    return arrs, B
  out = {}
  for k, v in arrs.items():
    if k == "head":
      out[k] = v
      continue
    widths = [(0, pad)] + [(0, 0)] * (v.ndim - 1)
    out[k] = np.pad(v, widths)
  return out, B + pad


def decode_window_ccl_sharded(binary: bytes, z_start: int, z_end: int,
                              mesh: Optional[Mesh] = None):
  """Sharded decode of a z window to per-slice CCL images: each device
  decodes a contiguous block of slices (pure data parallelism)."""
  if mesh is None:
    mesh = make_mesh()
  axis = mesh.axis_names[0]
  ndev = mesh.devices.size

  inputs = _engine.prepare_slice_inputs(binary, z_start, z_end)
  if inputs is None:
    return _fallback("decode_window_ccl_sharded",
                     "prepare_slice_inputs declined the stream")
  head = inputs["head"]
  B = z_end - z_start
  inputs, Bp = _pad_batch(inputs, B, ndev)

  batch_sharding = NamedSharding(mesh, P(axis))
  args = [
    jax.device_put(jnp.asarray(inputs[k]), batch_sharding)
    for k in ("packed", "nbytes", "nodes", "n_chains")
  ]
  permissible = head.crack_format == CrackFormat.PERMISSIBLE
  cc, N = _dec.decode_slices_to_ccl(
    *args, sx=head.sx, sy=head.sy, permissible=permissible
  )
  return np.asarray(cc)[:B], np.asarray(N)[:B], head


def sharded_decode_labels(binary: bytes, z_start: int, z_end: int,
                          mesh: Optional[Mesh] = None):
  """Full decode of a z window — crack replay, CCL AND label painting
  all on device under shard_map (slices data-parallel over the mesh;
  label tables replicated). Returns (labels device array (B, sy*sx)
  with u64 labels as (lo, hi) planes combined, head) or None.

  This is the serving path the reference thread-pools per slice
  (crackle.hpp:584-658); nothing round-trips to the host between the
  packed bytes and the painted labels."""
  if mesh is None:
    mesh = make_mesh()
  axis = mesh.axis_names[0]
  ndev = mesh.devices.size

  head = _codec.header(binary)
  inputs = _engine.prepare_slice_inputs(binary, z_start, z_end)
  if inputs is None:
    return _fallback("sharded_decode_labels",
                     "prepare_slice_inputs declined the stream")
  B = z_end - z_start
  inputs, Bp = _pad_batch(inputs, B, ndev)
  permissible = head.crack_format == CrackFormat.PERMISSIBLE
  batch = NamedSharding(mesh, P(axis))
  repl = NamedSharding(mesh, P())
  sharded = {
    k: jax.device_put(jnp.asarray(inputs[k]), batch)
    for k in ("packed", "nbytes", "nodes", "n_chains")
  }

  if head.label_format == LabelFormat.FLAT:
    uniq, cum, keys = _engine._flat_label_tables(head, binary)
    wide = uniq.dtype.itemsize > 4
    offs = np.pad(cum[z_start:z_end].astype(np.int32),
                  (0, Bp - B)).astype(np.int32)
    u64 = uniq.astype(np.uint64)
    lo = (u64 & 0xffffffff).astype(np.uint32)
    hi = (u64 >> 32).astype(np.uint32)

    def step(packed, nbytes, nodes, n_chains, offs, keys, lo, hi):
      cc, _N = _dec.decode_slices_to_ccl.__wrapped__(
        packed, nbytes, nodes, n_chains, sx=head.sx, sy=head.sy,
        permissible=permissible)
      return _dec.paint_flat(cc, offs, keys, lo, hi if wide else None)

    fn = jax.jit(jax.shard_map(
      step, mesh=mesh,
      in_specs=(P(axis), P(axis), P(axis), P(axis), P(axis), P(),
                P(), P()),
      out_specs=P(axis), check_vma=False,
    ))
    labels = fn(
      sharded["packed"], sharded["nbytes"], sharded["nodes"],
      sharded["n_chains"], jax.device_put(jnp.asarray(offs), batch),
      jax.device_put(jnp.asarray(keys.astype(jnp.int32)), repl),
      jax.device_put(jnp.asarray(lo), repl),
      jax.device_put(jnp.asarray(hi), repl),
    )
    return labels[:B], head

  if head.label_format != LabelFormat.PINS_VARIABLE_WIDTH:
    return _fallback("sharded_decode_labels",
                     f"unsupported label format {head.label_format}")
  tables = _engine._pins_device_tables(head, binary, z_start, z_end)
  if tables is None:
    return _fallback("sharded_decode_labels",
                     "pins table extraction declined the stream")
  pin_locs, pin_labs, single_ids, single_labs, bg32, cap_n = tables
  pad = Bp - B

  def padb(a):
    return jax.device_put(
      jnp.asarray(np.pad(a, [(0, pad)] + [(0, 0)] * (a.ndim - 1),
                         constant_values=-1 if a is pin_locs
                         or a is single_ids else 0)), batch)

  def step_p(packed, nbytes, nodes, n_chains, pl_, pb_, si_, sl_):
    labels, _cc, _N = _dec.decode_slices_full_pins.__wrapped__(
      packed, nbytes, nodes, n_chains, pl_, pb_, si_, sl_,
      jnp.int32(bg32), sx=head.sx, sy=head.sy,
      permissible=permissible, cap_n=cap_n)
    return labels

  fnp = jax.jit(jax.shard_map(
    step_p, mesh=mesh,
    in_specs=(P(axis),) * 8, out_specs=P(axis), check_vma=False,
  ))
  labels = fnp(
    sharded["packed"], sharded["nbytes"], sharded["nodes"],
    sharded["n_chains"], padb(pin_locs), padb(pin_labs),
    padb(single_ids), padb(single_labs),
  )
  return labels[:B], head


def decompress_sharded(binary: bytes, mesh: Optional[Mesh] = None
                       ) -> Optional[np.ndarray]:
  """Decode the full volume with z-slices sharded across the mesh;
  the label paint happens on device inside the sharded step (no host
  cc gather)."""
  head = _codec.header(binary)
  res = sharded_decode_labels(binary, 0, head.sz, mesh)
  if res is None:
    return None  # reason already logged by sharded_decode_labels
  labels, head = res
  out = np.asarray(labels).astype(head.dtype, copy=False)
  vol = out.reshape(head.sz, head.sy, head.sx).transpose(2, 1, 0)
  return np.asfortranarray(vol) if head.fortran_order else \
      np.ascontiguousarray(vol)


# ---------------------------------------------------------------------------
# Sharded reductions: the collective patterns of the codec
# ---------------------------------------------------------------------------

def voxel_counts_sharded(binary: bytes, mesh: Optional[Mesh] = None
                         ) -> Optional[dict]:
  """Per-label voxel counts with the histogram reduced across the mesh
  via psum (the data-parallel equivalent of the reference's
  mutex-merged maps)."""
  if mesh is None:
    mesh = make_mesh()
  axis = mesh.axis_names[0]
  ndev = mesh.devices.size

  head = _codec.header(binary)
  if head.label_format != LabelFormat.FLAT:
    return _fallback("voxel_counts_sharded",
                     f"label format {head.label_format} != FLAT")
  res = decode_window_ccl_sharded(binary, 0, head.sz, mesh)
  if res is None:
    return None  # reason already logged
  cc, N, head = res

  lb = bytes(_codec.raw_labels(binary))
  n_labels = _labels_ops.decode_num_labels(head, lb)
  uniq = _labels_ops.decode_uniq(head, lb)
  cpg = _labels_ops.components_per_grid(head, lb).astype(np.int64)
  cum = np.concatenate([[0], np.cumsum(cpg)])
  offset = (8 + n_labels * head.stored_data_width
            + head.component_width() * head.num_grids())
  keys = np.frombuffer(lb, offset=offset, dtype=compute_dtype(n_labels))

  B = head.sz
  pad = (-B) % ndev
  ccp = np.pad(cc, [(0, pad), (0, 0)])
  offs = np.pad(cum[:B].astype(np.int32), (0, pad))
  valid = np.pad(np.ones(B, bool), (0, pad))

  batch_sharding = NamedSharding(mesh, P(axis))

  @functools.partial(
    jax.jit,
    in_shardings=(batch_sharding, batch_sharding, batch_sharding, None),
    out_shardings=None,
  )
  def histogram(cc, offs, valid, keys):
    key_idx = keys[cc + offs[:, None]]
    key_idx = jnp.where(valid[:, None], key_idx, n_labels)
    flat = key_idx.reshape(-1)
    counts = jnp.zeros((n_labels + 1,), jnp.int64)
    counts = counts.at[flat].add(1)
    return counts[:n_labels]

  counts = np.asarray(
    histogram(jnp.asarray(ccp), jnp.asarray(offs), jnp.asarray(valid),
              jnp.asarray(keys.astype(np.int32)))
  )
  return {int(l): int(c) for l, c in zip(uniq.tolist(), counts.tolist())
          if c > 0}


def compress_sharded(labels: np.ndarray, mesh: Optional[Mesh] = None,
                     parallel: int = 0) -> Optional[bytes]:
  """Multi-chip FLAT encode: z-blocks shard over the mesh; each shard
  runs the per-voxel encode stages (boundary VCG, first-visit CCL,
  per-component label tables, per-slice CRC32C) on its own device
  under shard_map, and the host tail (serial DFS trace + global
  dictionary + byte assembly + the format-choice pair count over the
  unpadded flat volume, kernels/encode.assemble_flat_stream) splices
  the result. Byte-identical to single-process codec.compress.

  Backend-agnostic: the per-voxel step is plain XLA, so a mesh of
  virtual CPU devices exercises the same shard_map structure as a
  mesh of GPUs. 64-bit labels are carried as (lo32, hi32) planes on
  device.

  This is the data-parallel analog of the reference's thread-pooled
  encode (crackcodes.hpp:498-521 / labels.hpp:30-155): slices are the
  parallel axis; the only cross-shard communication is the (host-side)
  dictionary merge, exactly the SURVEY §2.5 mapping."""
  from ..kernels import encode as _enc

  if mesh is None:
    mesh = make_mesh()
  axis = mesh.axis_names[0]
  ndev = mesh.devices.size

  labels = np.asarray(labels)
  if labels.ndim != 3:
    return _fallback("compress_sharded", f"ndim={labels.ndim} != 3")
  if np.issubdtype(labels.dtype, np.signedinteger):
    return _fallback("compress_sharded", "signed dtype")
  sx, sy, sz = labels.shape
  if sz == 0 or sx < 2 or sy < 2:
    return _fallback("compress_sharded", f"degenerate shape {labels.shape}")
  wide = labels.dtype.itemsize == 8
  f_order = bool(labels.flags.f_contiguous)

  zyx = np.ascontiguousarray(np.transpose(labels, (2, 1, 0)))
  pad = (-sz) % ndev
  if pad:
    # pad slices replicate the last slice so their stats are sane;
    # every padded output is dropped before assembly, and the pair
    # count is computed over the unpadded flat volume below
    zyx = np.concatenate([zyx, np.repeat(zyx[-1:], pad, axis=0)])
  batch = NamedSharding(mesh, P(axis))
  if wide:
    z64 = zyx.astype(np.uint64)
    planes = (
      jax.device_put(
        jnp.asarray((z64 & 0xffffffff).astype(np.uint32)
                    .view(np.int32)), batch),
      jax.device_put(
        jnp.asarray((z64 >> 32).astype(np.uint32).view(np.int32)),
        batch),
    )
  else:
    planes = jax.device_put(
      jnp.asarray(zyx.astype(np.uint32).view(np.int32)), batch)

  def step(pl_):
    vcg, cc, N, crcs, _pairs = _enc._encode_stage1.__wrapped__(
      pl_, sx, sy, wide)
    return vcg, cc, N, crcs

  in_spec = (P(axis), P(axis)) if wide else P(axis)
  fn = jax.jit(jax.shard_map(
    step, mesh=mesh, in_specs=(in_spec,),
    out_specs=(P(axis), P(axis), P(axis), P(axis)),
    check_vma=False,
  ))
  vcg_d, cc_d, N_d, crcs_d = fn(planes)
  N = np.asarray(N_d)[:sz]
  if wide:
    t_lo = _enc.component_labels(planes[0], cc_d, np.asarray(N_d),
                                 sx, sy)
    t_hi = _enc.component_labels(planes[1], cc_d, np.asarray(N_d),
                                 sx, sy)
    tables = (np.asarray(t_lo)[:sz].view(np.uint32).astype(np.uint64)
              | (np.asarray(t_hi)[:sz].view(np.uint32)
                 .astype(np.uint64) << 32))
  else:
    tables = np.asarray(_enc.component_labels(
      planes, cc_d, np.asarray(N_d), sx, sy
    ))[:sz].view(np.uint32).astype(np.uint64)
  vcg = vcg_d[:sz]  # stays on device; assemble fetches packed chunks
  crcs = np.asarray(crcs_d)[:sz].astype(np.uint32)

  flat = zyx[:sz].reshape(-1)
  num_pairs = int(np.count_nonzero(flat[1:] == flat[:-1]))

  out = _enc.assemble_flat_stream(
    vcg, tables, N, crcs, num_pairs, sx, sy, sz,
    data_width=labels.dtype.itemsize, fortran_order=f_order,
    parallel=parallel)
  if out is None:
    return _fallback("compress_sharded",
                     "native trace unavailable for a slice")
  return out


def sharded_roundtrip_step(mesh: Mesh, sx: int, sy: int,
                           permissible: bool = False):
  """Build a jitted one-step function exercising the codec's full
  multi-chip pattern: sharded slice decode (dp over z), a label
  histogram reduced with psum, and an all_gather of per-shard slice
  byte lengths (the z-index assembly pattern). Used by the driver's
  multi-chip dry run and scaling benchmarks."""
  axis = mesh.axis_names[0]

  def step(packed, nbytes, nodes, n_chains, keys, offs):
    # data-parallel decode of this shard's slices
    cc, N = _dec.decode_slices_to_ccl.__wrapped__(
      packed, nbytes, nodes, n_chains, sx=sx, sy=sy, permissible=permissible,
    )
    key_idx = keys[cc + offs[:, None]]
    # psum histogram across shards (label dictionary reduction)
    local_counts = jnp.zeros((keys.shape[0],), jnp.int64)
    local_counts = local_counts.at[key_idx.reshape(-1)].add(1)
    counts = jax.lax.psum(local_counts, axis)
    # all_gather per-slice byte lengths in z order (z-index assembly)
    z_index = jax.lax.all_gather(nbytes, axis, tiled=True)
    return cc, counts, z_index

  return jax.jit(jax.shard_map(
    step, mesh=mesh,
    in_specs=(P(axis), P(axis), P(axis), P(axis), P(), P(axis)),
    out_specs=(P(axis), P(), P()),
    check_vma=False,
  ))
