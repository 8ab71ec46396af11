"""Host glue for the JAX decode engine: parses the container sections,
pads per-slice crack streams into fixed-shape device arrays (bucketed
to limit recompiles), launches the batched decode programs, and
assembles the output volume."""
import functools
import logging
from typing import Optional, Tuple

import numpy as np
import jax
import jax.numpy as jnp

from ..headers import CrackleHeader, CrackFormat, LabelFormat
from ..lib import crc32c, ctoi, compute_dtype
from ..ops import crackcode as _cc
from ..ops import labels as _labels_ops
from .. import codec as _codec
from . import decode as _dec


logger = logging.getLogger("crackle_tpu.engine")


def _fallback(fn: str, reason: str):
  """Every None return in this module routes through here so callers
  can tell 'unsupported stream' from 'broken code path'."""
  logger.warning("%s: falling back to host path: %s", fn, reason)
  return None


def _next_pow2(x: int) -> int:
  if x <= 1:
    return 1
  return 1 << (x - 1).bit_length()


# Streams whose longest slice exceeds this codepoint capacity first
# try chain-aligned virtual-slice splitting (prepare_split_inputs);
# only when a SINGLE chain exceeds the cap (binary-noise class: the
# crack graph is one connected component holding ~95% of the stream)
# does the window fall back to the native host decoder. The value is
# inherited from an earlier accelerator backend, where compile time
# grew steeply above it; it has not been measured on the GPU.
MAX_DEVICE_CAP = 1 << 17


def _device_cap_ok(inputs) -> bool:
  return inputs["packed"].shape[1] * 4 <= MAX_DEVICE_CAP


def prepare_slice_inputs(binary: bytes, z_start: int, z_end: int):
  """Parse + pad the crack streams of a z window for device decode.

  Markov streams rank-decode to diff-coded codepoints on the host
  (the bitstream is serial per slice, like the reference's
  markov.hpp:268-323) and re-pack to the 2-bit layout the device
  replay unpacks; everything downstream (scope matching, position
  replay, VCG paint, CCL, label paint) still runs on the device.
  """
  head = _codec.header(binary)
  markov = head.markov_model_order > 0
  model = _codec.decode_markov_model(head, binary) if markov else None

  codes = _codec.crack_codes(binary)[z_start:z_end]
  B = len(codes)

  def prep_one(code):
    if len(code) == 0:
      return b'', np.zeros(0, np.int64)
    index_size = 4 + ctoi(code, 0, 4)
    nodes = _cc.read_boc_index(code, head.sx, head.sy)
    if not markov:
      return code[index_size:], nodes
    from ..models import markov as _markov
    cps = _markov.decode_markov(
      code[index_size:], model, head.markov_model_order
    ).astype(np.int64)
    # re-diff (mod 4) and pack 4 codepoints/byte; zero-pad diffs in
    # the last byte replicate the final codepoint, which can never
    # form a branch/terminate reversal pair, so the replay's
    # validity logic drops them exactly like sub-byte padding in
    # non-markov streams
    diffs = cps.copy()
    diffs[1:] = (cps[1:] - cps[:-1]) & 3
    pad = (-len(diffs)) % 4
    if pad:
      diffs = np.concatenate([diffs, np.zeros(pad, np.int64)])
    q = diffs.reshape(-1, 4)
    by = (q[:, 0] | (q[:, 1] << 2) | (q[:, 2] << 4)
          | (q[:, 3] << 6)).astype(np.uint8)
    return by.tobytes(), nodes

  if markov and B > 8:
    # the rank decode is serial per slice (markov.hpp:268-323) but
    # slices are independent; the native bitstream decoder releases
    # the GIL, so a thread pool parallelizes across slices
    import os as _os
    from concurrent.futures import ThreadPoolExecutor
    with ThreadPoolExecutor(min(_os.cpu_count() or 1, B)) as pool:
      prepped = list(pool.map(prep_one, codes))
  else:
    prepped = [prep_one(c) for c in codes]
  packed_list = [p for p, _ in prepped]
  nodes_list = [n for _, n in prepped]

  max_bytes = max((len(p) for p in packed_list), default=0)
  max_chains = max((len(n) for n in nodes_list), default=0)
  CAP_B = _next_pow2(max(max_bytes, 4))
  CAP_CH = _next_pow2(max(max_chains, 2))

  packed = np.zeros((B, CAP_B), np.uint8)
  nbytes = np.zeros(B, np.int32)
  nodes = np.zeros((B, CAP_CH), np.int32)
  n_chains = np.zeros(B, np.int32)
  for i, (p, nd) in enumerate(zip(packed_list, nodes_list)):
    packed[i, :len(p)] = np.frombuffer(p, np.uint8)
    nbytes[i] = len(p)
    nodes[i, :len(nd)] = nd
    n_chains[i] = len(nd)

  return {
    "head": head,
    "packed": packed,
    "nbytes": nbytes,
    "nodes": nodes,
    "n_chains": n_chains,
  }


# virtual-slice splitting: pieces target this many codepoints so the
# fused replay stays at R <= 512 (compile-cheap, cache-warm bucket)
SPLIT_TARGET_CPS = 1 << 16


def _split_slice_stream(code: bytes, nodes: np.ndarray,
                        max_cps: int):
  """Split one slice's packed move stream (BOC already stripped) at
  chain boundaries into pieces of <= max_cps codepoints.

  Chains replay independently (each starts at its own BOC node with a
  self-contained branch scope), and the pair-classifier state at a
  chain-start codepoint is always "fresh" (it follows a pair-second,
  so it can never itself be a pair-second — classify_codepoints'
  recurrence s[i] = r[i] & ~s[i-1]), so re-basing a piece's first
  codepoint as absolute reproduces the in-stream classification
  exactly. Returns [(packed_bytes, nodes_piece), ...] or None when a
  single chain exceeds max_cps (caller falls back)."""
  cps = _cc.unpack_codepoints(code, 0)
  s, kind = _cc.classify_codepoints(cps)
  ends, ok = _cc.segment_chains(kind, s, len(nodes))
  if not ok:
    return None
  starts = np.concatenate([[0], ends[:-1] + 2]).astype(np.int64)
  bounds = np.concatenate([starts, [ends[-1] + 2]]).astype(np.int64)
  n_chains = len(nodes)
  pieces = []
  i = 0
  while i < n_chains:
    # largest j with bounds[j] - bounds[i] <= max_cps
    j = int(np.searchsorted(bounds, bounds[i] + max_cps,
                            side='right')) - 1
    j = min(j, n_chains)
    if j <= i:
      return None  # one chain alone exceeds max_cps
    piece = cps[bounds[i]:bounds[j]].astype(np.int64)
    d = piece.copy()
    d[1:] = (piece[1:] - piece[:-1]) & 3  # d[0] stays absolute
    pad = (-len(d)) % 4
    if pad:
      d = np.concatenate([d, np.zeros(pad, np.int64)])
    q = d.reshape(-1, 4)
    by = (q[:, 0] | (q[:, 1] << 2) | (q[:, 2] << 4)
          | (q[:, 3] << 6)).astype(np.uint8)
    pieces.append((by.tobytes(), nodes[i:j]))
    i = j
  return pieces


def prepare_split_inputs(binary: bytes, z_start: int, z_end: int,
                         max_cps: int = 0):
  """prepare_slice_inputs for streams whose slices exceed the device
  replay capacity: long slices split into chain-aligned virtual
  slices. Returns (inputs dict over pieces, piece_z (P,) window-local
  source slice of each piece) or None."""
  head = _codec.header(binary)
  if head.markov_model_order > 0:
    return None  # markov prep already re-packs; keep paths separate
  if not max_cps:
    max_cps = min(SPLIT_TARGET_CPS, MAX_DEVICE_CAP)
  codes = _codec.crack_codes(binary)[z_start:z_end]
  packed_list, nodes_list, piece_z = [], [], []
  for wz, code in enumerate(codes):
    if len(code) == 0:
      packed_list.append(b'')
      nodes_list.append(np.zeros(0, np.int64))
      piece_z.append(wz)
      continue
    index_size = 4 + ctoi(code, 0, 4)
    nodes = _cc.read_boc_index(code, head.sx, head.sy)
    body = code[index_size:]
    if len(body) * 4 <= max_cps:
      packed_list.append(body)
      nodes_list.append(nodes)
      piece_z.append(wz)
      continue
    pieces = _split_slice_stream(body, nodes, max_cps)
    if pieces is None:
      return None
    for by, nd in pieces:
      packed_list.append(by)
      nodes_list.append(nd)
      piece_z.append(wz)

  P = len(packed_list)
  max_bytes = max((len(p) for p in packed_list), default=0)
  max_chains = max((len(n) for n in nodes_list), default=0)
  CAP_B = _next_pow2(max(max_bytes, 4))
  CAP_CH = _next_pow2(max(max_chains, 2))
  packed = np.zeros((P, CAP_B), np.uint8)
  nbytes = np.zeros(P, np.int32)
  nodes = np.zeros((P, CAP_CH), np.int32)
  n_chains = np.zeros(P, np.int32)
  for i, (p, nd) in enumerate(zip(packed_list, nodes_list)):
    packed[i, :len(p)] = np.frombuffer(p, np.uint8)
    nbytes[i] = len(p)
    nodes[i, :len(nd)] = nd
    n_chains[i] = len(nd)
  return {
    "head": head,
    "packed": packed,
    "nbytes": nbytes,
    "nodes": nodes,
    "n_chains": n_chains,
  }, np.asarray(piece_z, np.int32)


@functools.partial(jax.jit, static_argnames=("sx", "sy", "B",
                                             "permissible"))
def _split_ccl_step(packed, nbytes, nodes, n_chains, piece_z, sx, sy,
                    B, permissible):
  v = _dec.decode_slices_to_vcg.__wrapped__(
    packed, nbytes, nodes, n_chains, sx=sx, sy=sy,
    permissible=permissible)
  pres = v if permissible else v ^ 0b1111
  merged = jnp.zeros((B, sy * sx), pres.dtype)
  merged = merged.at[piece_z].max(pres)
  vcg = merged if permissible else merged ^ 0b1111
  return _dec._ccl_batch(vcg, sx, sy)


def _decode_ccl_split(binary: bytes, z_start: int, z_end: int):
  """Device decode of a window whose slices exceed MAX_DEVICE_CAP:
  virtual-slice pieces replay to VCG presence on device, merge with a
  per-slice OR, then the normal CCL runs on the merged rasters."""
  res = prepare_split_inputs(binary, z_start, z_end)
  if res is None:
    return None
  inputs, piece_z = res
  if not _device_cap_ok(inputs):
    return None  # a single chain exceeded the device capacity
  head = inputs["head"]
  permissible = head.crack_format == CrackFormat.PERMISSIBLE
  B = z_end - z_start
  cc, N = _split_ccl_step(
    jnp.asarray(inputs["packed"]), jnp.asarray(inputs["nbytes"]),
    jnp.asarray(inputs["nodes"]), jnp.asarray(inputs["n_chains"]),
    jnp.asarray(piece_z), head.sx, head.sy, B, permissible)
  return cc, N, head


def decode_window_ccl_device(binary: bytes, z_start: int, z_end: int):
  """Decode a z window to per-slice first-visit CCL images that STAY
  on device. Returns (cc (B, sy*sx) int32, N (B,) int32, head) —
  the batched input for device analytics (kernels/stats.py)."""
  inputs = prepare_slice_inputs(binary, z_start, z_end)
  if inputs is None or not _device_cap_ok(inputs):
    if inputs is not None:
      # long slices: split into chain-aligned virtual slices and
      # merge the piece VCGs on device
      res = _decode_ccl_split(binary, z_start, z_end)
      if res is not None:
        return res
    return _fallback("decode_window_ccl_device",
                     "stream exceeds MAX_DEVICE_CAP"
                     if inputs is not None else "prepare declined")
  head = inputs["head"]
  permissible = head.crack_format == CrackFormat.PERMISSIBLE
  cc, N = _dec.decode_slices_to_ccl(
    jnp.asarray(inputs["packed"]), jnp.asarray(inputs["nbytes"]),
    jnp.asarray(inputs["nodes"]), jnp.asarray(inputs["n_chains"]),
    sx=head.sx, sy=head.sy, permissible=permissible,
  )
  return cc, N, head


def decode_window_ccl(binary: bytes, z_start: int, z_end: int,
                      check_crcs: bool = True):
  """Decode a z window to per-slice first-visit CCL images on device.

  Returns (cc (B, sy*sx) int32 numpy, N (B,) numpy) or None for
  fallback streams."""
  res = decode_window_ccl_device(binary, z_start, z_end)
  if res is None:
    return None
  cc, N, head = res
  cc = np.asarray(cc)
  N = np.asarray(N)
  if check_crcs:
    _check_crcs_host(binary, head, cc, z_start, z_end)
  return cc, N


def _check_crcs_host(binary: bytes, head, cc: np.ndarray, z_start: int,
                     z_end: int) -> None:
  """Compare host crc32c of each fetched CCL image with the stored
  per-slice crack crc; raises FormatError on the first mismatch."""
  if head.format_version == 0:
    return
  stored = _codec.crack_crcs(binary)
  for i, z in enumerate(range(z_start, z_end)):
    computed = crc32c(np.ascontiguousarray(cc[i].astype('<u4')))
    if computed != int(stored[z]):
      from ..headers import FormatError
      raise FormatError(
        f"crackle: crack code crc mismatch on z={z} "
        f"computed: {computed} stored: {int(stored[z])}"
      )


def _flat_label_tables(head, binary):
  lb = bytes(_codec.raw_labels(binary))
  n_labels = _labels_ops.decode_num_labels(head, lb)
  uniq = _labels_ops.decode_uniq(head, lb)
  cpg = _labels_ops.components_per_grid(head, lb).astype(np.int64)
  cum = np.concatenate([[0], np.cumsum(cpg)])
  offset = (8 + n_labels * head.stored_data_width
            + head.component_width() * head.num_grids())
  keys = np.frombuffer(lb, offset=offset, dtype=compute_dtype(n_labels))
  return uniq, cum, keys


def _pack_by_slice(B: int, zi: np.ndarray, cols: list, fills: list):
  """Group (zi, col...) tuples into per-slice padded (B, CAP) arrays."""
  order = np.argsort(zi, kind='stable')
  zi = zi[order]
  counts = np.bincount(zi, minlength=B)
  CAP = _next_pow2(max(int(counts.max()) if B else 0, 1))
  outs = []
  starts = np.concatenate([[0], np.cumsum(counts)])[:-1]
  within = np.arange(len(zi)) - np.repeat(starts, counts)
  for col, fill in zip(cols, fills):
    out = np.full((B, CAP), fill, np.int32)
    out[zi, within] = col[order]
    outs.append(out)
  return outs


def _pins_device_tables(head, binary: bytes, z_start: int, z_end: int):
  """Host parse of a condensed-pins section into per-slice device
  scatter inputs (labels.hpp:508-617 is the serial equivalent).

  Returns (pin_locs, pin_labs, single_ids, single_labs, bg32, cap_n)
  or None when stored labels exceed 32 bits."""
  if head.stored_data_width > 4:
    return None
  lb = bytes(_codec.raw_labels(binary))
  layout = _labels_ops.decode_condensed_pins_layout(head, lb)
  pins, singles = _labels_ops.decode_condensed_pins(head, lb)
  cpg = layout["components_per_grid"].astype(np.int64)
  cum = np.concatenate([[0], np.cumsum(cpg)])
  B = z_end - z_start
  sxy = head.sx * head.sy

  # cc singles: global component ids -> (slice, window-local id)
  ids, labs = [], []
  for label, ccs in singles.items():
    if len(ccs):
      ids.append(np.asarray(ccs, np.int64))
      labs.append(np.full(len(ccs), np.uint32(label).view(np.int32)))
  if ids:
    ids = np.concatenate(ids)
    labs = np.concatenate(labs)
    zs = np.searchsorted(cum, ids, side='right') - 1
    keep = (zs >= z_start) & (zs < z_end)
    ids, labs, zs = ids[keep], labs[keep], zs[keep]
    local = (ids - cum[zs]).astype(np.int32)
    single_ids, single_labs = _pack_by_slice(
      B, (zs - z_start).astype(np.int64), [local, labs], [-1, 0])
  else:
    single_ids = np.full((B, 1), -1, np.int32)
    single_labs = np.zeros((B, 1), np.int32)

  # pins: (index, depth) -> one (slice, in-slice position) per voxel
  locs, labs2, zz = [], [], []
  for label, plist in pins.items():
    for index, depth in plist:
      z0 = index // sxy
      loc = index - z0 * sxy
      zlo = max(z0, z_start)
      zhi = min(z0 + depth, z_end - 1)
      if zhi < zlo:
        continue
      n = zhi - zlo + 1
      zz.append(np.arange(zlo - z_start, zhi - z_start + 1))
      locs.append(np.full(n, loc, np.int64))
      labs2.append(np.full(n, np.uint32(label).view(np.int32)))
  if zz:
    zz = np.concatenate(zz)
    locs = np.concatenate(locs).astype(np.int32)
    labs2 = np.concatenate(labs2)
    pin_locs, pin_labs = _pack_by_slice(
      B, zz, [locs, labs2], [-1, 0])
  else:
    pin_locs = np.full((B, 1), -1, np.int32)
    pin_labs = np.zeros((B, 1), np.int32)

  n_per = cpg[z_start:z_end]
  cap_n = _next_pow2(max(int(n_per.max()) if len(n_per) else 1, 8))
  bg32 = int(np.uint32(layout["bgcolor"]).view(np.int32))
  return pin_locs, pin_labs, single_ids, single_labs, bg32, cap_n


def decode_window_device(binary: bytes, z_start: int, z_end: int):
  """Fused device decode of a z window: everything stays on device.

  Returns (labels (B, sy*sx) device array, cc, N, head) — the
  device consumption path (decoded segmentation feeds downstream
  device code without a host roundtrip) — or None for fallback
  streams."""
  head = _codec.header(binary)
  if head.label_format == LabelFormat.PINS_VARIABLE_WIDTH:
    tables = _pins_device_tables(head, binary, z_start, z_end)
    if tables is None:
      return _fallback("decode_window_device",
                       "pins tables unavailable for this stream")
    inputs = prepare_slice_inputs(binary, z_start, z_end)
    if inputs is None or not _device_cap_ok(inputs):
      return _fallback("decode_window_device",
                       "stream exceeds MAX_DEVICE_CAP")
    pin_locs, pin_labs, single_ids, single_labs, bg32, cap_n = tables
    permissible = head.crack_format == CrackFormat.PERMISSIBLE
    labels, cc, N = _dec.decode_slices_full_pins(
      jnp.asarray(inputs["packed"]), jnp.asarray(inputs["nbytes"]),
      jnp.asarray(inputs["nodes"]), jnp.asarray(inputs["n_chains"]),
      jnp.asarray(pin_locs), jnp.asarray(pin_labs),
      jnp.asarray(single_ids), jnp.asarray(single_labs),
      jnp.int32(bg32),
      sx=head.sx, sy=head.sy, permissible=permissible, cap_n=cap_n,
    )
    return labels, cc, N, head
  if head.label_format != LabelFormat.FLAT:
    return _fallback("decode_window_device",
                     f"unsupported label format {head.label_format}")
  inputs = prepare_slice_inputs(binary, z_start, z_end)
  if inputs is None or not _device_cap_ok(inputs):
    return _fallback("decode_window_device",
                     "stream exceeds MAX_DEVICE_CAP")
  permissible = head.crack_format == CrackFormat.PERMISSIBLE
  offs, keys, lo, hi = _flat_device_tables(head, binary)
  labels, cc, N = _dec.decode_slices_full(
    jnp.asarray(inputs["packed"]), jnp.asarray(inputs["nbytes"]),
    jnp.asarray(inputs["nodes"]), jnp.asarray(inputs["n_chains"]),
    jnp.asarray(offs[z_start:z_end]), keys, lo, hi,
    sx=head.sx, sy=head.sy, permissible=permissible,
  )
  return labels, cc, N, head


def _flat_device_tables(head, binary: bytes):
  """Flat-format label tables for the device paint (decode.paint_flat):
  per-slice key offsets (sz,) int32 numpy, and device arrays of keys
  int32, uniq low words uint32 and uniq high words uint32 (None unless
  the stored labels are wider than 32 bits)."""
  uniq, cum, keys = _flat_label_tables(head, binary)
  u64 = uniq.astype(np.uint64)
  lo = jnp.asarray((u64 & 0xffffffff).astype(np.uint32))
  hi = (jnp.asarray((u64 >> 32).astype(np.uint32))
        if uniq.dtype.itemsize > 4 else None)
  return (cum[:head.sz].astype(np.int32),
          jnp.asarray(keys.astype(np.int32)), lo, hi)


class DeviceStream:
  """A compressed crackle stream resident in device memory.

  The device serving path for the in-memory-compressed-array use
  case (the reference keeps the compressed binary in host RAM and
  decodes cutouts on demand — array.py:32-341; CrackleRemoteArray
  array.py:342-448 is the ranged-read analog): upload the parsed
  sections once (~the compressed size, typically 1-3% of raw), then
  every window decode runs entirely from device memory with no host
  transfer.

  Flat streams (u32 or u64 labels, any markov order) carry the
  flat-format paint tables; condensed-pins streams carry their
  per-slice pin/single tables instead."""

  def __init__(self, head, packed, nbytes, nodes, n_chains,
               permissible: bool, crcs=None, flat=None, pins=None):
    self.head = head
    self.packed = packed
    self.nbytes = nbytes
    self.nodes = nodes
    self.n_chains = n_chains
    self.permissible = permissible
    self.crcs = crcs  # (sz,) uint32 stored per-slice crack crc32cs
    # flat streams: (key_offsets (sz,), keys, lo, hi) — the
    # decode.paint_flat tables, hi None for labels <= 32 bits
    self.flat = flat
    # pins streams: (pin_locs, pin_labs, single_ids, single_labs,
    # bg32, cap_n) with the per-slice arrays device-resident
    self.pins = pins

  @property
  def nbytes_device(self) -> int:
    arrs = [self.packed, self.nbytes, self.nodes, self.n_chains]
    if self.flat is not None:
      arrs.extend(a for a in self.flat if a is not None)
    if self.pins is not None:
      arrs.extend(self.pins[:4])
    return sum(int(np.prod(a.shape)) * a.dtype.itemsize
               for a in arrs)

  def decode_window(self, z_start: int, z_end: int,
                    check_crcs: bool = False):
    """Decode [z_start, z_end) from device memory. Returns (labels,
    cc, N) — all device-resident, no host round trip.

    check_crcs=True additionally verifies the per-slice crack CRC32Cs
    on the device (kernels/crc.py, against the stored words uploaded
    with the stream) and raises FormatError on mismatch —
    integrity-checked serving with no device->host transfer of the
    decoded volume."""
    full = z_start == 0 and z_end == self.head.sz

    def win(a):
      # full-window skips the per-array device slicing dispatches
      return a if full else a[z_start:z_end]

    if self.pins is not None:
      pl_, pb_, si_, sl_, bg32, cap_n = self.pins
      labels, cc, N = _dec.decode_slices_full_pins(
        win(self.packed), win(self.nbytes), win(self.nodes),
        win(self.n_chains), win(pl_), win(pb_), win(si_), win(sl_),
        jnp.int32(bg32),
        sx=self.head.sx, sy=self.head.sy,
        permissible=self.permissible, cap_n=cap_n,
      )
    else:
      offs, keys, lo, hi = self.flat
      labels, cc, N = _dec.decode_slices_full(
        win(self.packed), win(self.nbytes), win(self.nodes),
        win(self.n_chains), win(offs), keys, lo, hi,
        sx=self.head.sx, sy=self.head.sy,
        permissible=self.permissible,
      )
    if check_crcs and self.crcs is not None:
      from . import crc
      got = crc.crc32c_device(cc)
      bad = jnp.flatnonzero(
        got != self.crcs[z_start:z_end], size=1, fill_value=-1)[0]
      bad = int(np.asarray(bad))
      if bad >= 0:
        from ..headers import FormatError
        raise FormatError(
          f"crackle: crack code crc mismatch on z={z_start + bad}"
        )
    return labels, cc, N


def upload_stream(binary: bytes) -> Optional[DeviceStream]:
  """Parse a crackle stream and park it in device memory as a
  DeviceStream. Returns None when the stream needs a fallback decode
  path."""
  head = _codec.header(binary)
  if head.label_format not in (LabelFormat.FLAT,
                               LabelFormat.PINS_VARIABLE_WIDTH):
    return _fallback("upload_stream",
                     f"unsupported label format {head.label_format}")
  inputs = prepare_slice_inputs(binary, 0, head.sz)
  if inputs is None or not _device_cap_ok(inputs):
    return _fallback("upload_stream", "stream exceeds MAX_DEVICE_CAP")
  flat = pins = None
  if head.label_format == LabelFormat.FLAT:
    offs, keys, lo, hi = _flat_device_tables(head, binary)
    flat = (jnp.asarray(offs), keys, lo, hi)
  else:
    tables = _pins_device_tables(head, binary, 0, head.sz)
    if tables is None:
      return _fallback("upload_stream",
                       "pins tables unavailable (stored width > 4)")
    pin_locs, pin_labs, single_ids, single_labs, bg32, cap_n = tables
    pins = (jnp.asarray(pin_locs), jnp.asarray(pin_labs),
            jnp.asarray(single_ids), jnp.asarray(single_labs),
            bg32, cap_n)
  crcs = None
  if head.format_version > 0:
    crcs = jnp.asarray(np.asarray(_codec.crack_crcs(binary),
                                  dtype='<u4'))
  return DeviceStream(
    head,
    jnp.asarray(inputs["packed"]), jnp.asarray(inputs["nbytes"]),
    jnp.asarray(inputs["nodes"]), jnp.asarray(inputs["n_chains"]),
    permissible=head.crack_format == CrackFormat.PERMISSIBLE,
    crcs=crcs, flat=flat, pins=pins,
  )


def decode_window(binary: bytes, z_start: int, z_end: int,
                  label: Optional[int] = None,
                  check_crcs: bool = True) -> Optional[np.ndarray]:
  """Full device decode of a z window. Returns the (sx, sy, szr)
  volume (a boolean mask when label is given) or None if the stream
  needs the numpy fallback."""
  head = _codec.header(binary)
  if head.label_format == LabelFormat.PINS_VARIABLE_WIDTH:
    if label is not None:
      return None  # single-label pins queries stay on the host path
  elif head.label_format != LabelFormat.FLAT:
    return None

  res = decode_window_device(binary, z_start, z_end) \
    if label is None else None
  if res is not None:
    labels_dev, cc_dev, _N, _ = res
    out = np.asarray(labels_dev).astype(head.dtype, copy=False)
    cc = np.asarray(cc_dev) if check_crcs else None
  else:
    if head.label_format != LabelFormat.FLAT:
      return None
    res = decode_window_ccl(binary, z_start, z_end, check_crcs=False)
    if res is None:
      return None
    cc, _N = res
    uniq, cum, keys = _flat_label_tables(head, binary)
    key_idx = np.asarray(_dec.paint_keys(
      jnp.asarray(cc), jnp.asarray(cum[z_start:z_end].astype(np.int32)),
      jnp.asarray(keys.astype(np.int32)),
    ))
    if label is not None:
      pos = np.searchsorted(uniq, label)
      hit = pos < len(uniq) and uniq[pos] == label
      out = (key_idx == pos) if hit else np.zeros_like(key_idx, bool)
    else:
      out = uniq[key_idx].astype(head.dtype, copy=False)

  if check_crcs:
    _check_crcs_host(binary, head, cc, z_start, z_end)

  vol = out.reshape(z_end - z_start, head.sy, head.sx).transpose(2, 1, 0)
  if head.fortran_order:
    return np.asfortranarray(vol)
  return np.ascontiguousarray(vol)
