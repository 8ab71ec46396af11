"""JAX decode engine.

The per-slice decode pipeline (packed crack bytes -> codepoints ->
symbols -> positions -> VCG -> CCL -> component keys -> labels)
expressed as fixed-shape, data-parallel jnp/lax ops that XLA compiles
for the accelerator:

  * 2-bit unpack + mod-4 cumsum undiff            (elementwise + scan)
  * b/t pair classification via run parity        (cummax)
  * chain segmentation via running minima, with
    chain ids from a cumsum (no searchsorted)     (cummin + cumsum)
  * branch-scope matching via ONE sort by
    (scope depth, position) with the originating
    index embedded in the key, and a reverse
    segmented scan for next-close; depth-1 scopes
    resolve against the chain-end scan instead of
    sort entries                                  (sort + scans)
  * position replay via scatter-add + cumsum
  * VCG painting via one presence scatter
  * CCL via alternating row/column segmented-min
    sweeps to a fixed point (no gathers in the
    loop), then a single-gather first-visit
    renumber
  * label paint via two gathers through the
    flat-format key and label tables

This mirrors crackle_tpu.ops.crackcode / ops.ccl bit-for-bit; the
numpy implementations there are the correctness oracle.
"""
import functools

import numpy as np
import jax
import jax.numpy as jnp

# The scope-matching sort keys need 64-bit integer range.
jax.config.update("jax_enable_x64", True)

UP, RIGHT, DOWN, LEFT = 0, 1, 2, 3


# ---------------------------------------------------------------------------
# Batched slice decode: packed bytes -> VCG
# ---------------------------------------------------------------------------

def _shift_right(x, fill):
  """x shifted one step toward higher indices along the last axis."""
  pad = jnp.full(x.shape[:-1] + (1,), fill, x.dtype)
  return jnp.concatenate([pad, x[..., :-1]], axis=-1)


def _shift_left(x, fill):
  pad = jnp.full(x.shape[:-1] + (1,), fill, x.dtype)
  return jnp.concatenate([x[..., 1:], pad], axis=-1)


def _scatter_add_rows(idx, w, n_bins: int):
  """out[b, idx[b, i]] += w[b, i]; indices outside [0, n_bins) drop."""
  B = idx.shape[0]
  idx = jnp.where((idx >= 0) & (idx < n_bins), idx, n_bins)
  rows = jnp.arange(B, dtype=jnp.int32)[:, None]
  return jnp.zeros((B, n_bins), jnp.int32).at[rows, idx].add(
    w.astype(jnp.int32), mode='drop')


def _scatter_presence_rows(idx, n_bins: int):
  """out[b, j] = 1 where some idx[b, i] == j; others drop."""
  B = idx.shape[0]
  idx = jnp.where((idx >= 0) & (idx < n_bins), idx, n_bins)
  rows = jnp.arange(B, dtype=jnp.int32)[:, None]
  return jnp.zeros((B, n_bins), jnp.uint8).at[rows, idx].set(
    1, mode='drop')


def _decode_vcg_batch(packed, nbytes, nodes, n_chains, sx, sy,
                      permissible):
  """Batched: packed crack bytes (B, CAP_B) -> 4-bit VCG (B, sy*sx).

  Scans classify and segment the codepoint stream, ONE sort matches
  every move to the terminate that unwinds its scope (the move's
  direction bits ride inside the sort key), a scatter-add cancels each
  move's delta at its unwind point, and a presence scatter paints the
  edge rasters. Mirrors the reference's sequential stack replay
  (crackcodes.hpp:523-603 state machine, 706-862 VCG paint)
  bit-for-bit; oracle = ops/crackcode.py.
  """
  B, CAP_B = packed.shape
  CAP = CAP_B * 4
  n_cps = (nbytes * 4).astype(jnp.int32)[:, None]
  n_chains = n_chains[:, None]
  sxe = sx + 1

  # --- unpack 2-bit diffs, undiff via cumsum mod 4 ---
  b = packed.astype(jnp.int32)
  diffs = jnp.stack(
    [b & 3, (b >> 2) & 3, (b >> 4) & 3, (b >> 6) & 3], axis=2
  ).reshape(B, CAP)
  idx = jnp.arange(CAP, dtype=jnp.int32)[None, :]
  in_range = idx < n_cps
  diffs = jnp.where(in_range, diffs, 0)
  cps = (jnp.cumsum(diffs, axis=1) & 3).astype(jnp.int32)

  # --- classify: pair-second via run parity of the reversal flag ---
  prev = _shift_right(cps, 255)
  r = ((cps ^ prev) == 0b10) & in_range
  run_start = jnp.where(r & ~_shift_right(r, False), idx, -1)
  run_start = jax.lax.cummax(jnp.where(r, run_start, -1), axis=1)
  is_second = r & (((idx - run_start) & 1) == 0)

  pair_first = _shift_left(is_second, False)
  second_cp = _shift_left(cps, 0)
  is_term_pair = (second_cp == UP) | (second_cp == LEFT)
  is_branch = pair_first & ~is_term_pair
  is_term = pair_first & is_term_pair
  is_move = ~pair_first & ~is_second & in_range

  # --- chain segmentation ---
  tok = jnp.where(is_branch, 1, 0) - jnp.where(is_term, 1, 0)
  c = jnp.cumsum(tok, axis=1)
  runmin = _shift_right(jax.lax.cummin(c, axis=1), 0)
  runmin = jnp.minimum(runmin, 0)
  is_end = (c < runmin) & in_range

  end_cum = jnp.cumsum(is_end.astype(jnp.int32), axis=1)
  cnt_before = end_cum - is_end  # ends strictly before i
  chain_of = jnp.clip(cnt_before, 0, jnp.maximum(n_chains - 1, 0))
  prev_is_end = _shift_right(is_end, False)
  valid = (cnt_before < n_chains) | prev_is_end

  depth_after = c + chain_of + 1

  # --- branch-scope matching: one sort by (depth, position) ---
  # entries: moves at their depth; terms at the depth of the scope
  # they close (depth_after + 1). Within a depth, order by stream
  # position; a move's unwind point is the next close in its depth
  # segment. Chain-level (depth 1) scopes resolve against the final
  # terminate of their chain, which lands in the same segment.
  # Key layout: (depth * CAP + idx) << 3 | close << 2 | cps, so the
  # sorted keys alone carry everything the downstream stages need.
  # depth <= branches + 1 <= CAP/2 + 2, so the key fits int32 for
  # CAP <= 16384 (the common bucket); int64 (x64) otherwise.
  depth_evt = jnp.where(is_term, depth_after + 1, depth_after)
  is_close_i = is_term & valid
  if (CAP // 2 + 2) * CAP * 8 + CAP * 8 + 8 < 2 ** 31:
    kdt = jnp.int32
  else:
    kdt = jnp.int64
  INF = kdt(np.iinfo(np.dtype(kdt)).max)
  active_i = valid & (is_move | is_term)
  keys = jnp.where(
    active_i,
    (((depth_evt.astype(kdt) * CAP + idx.astype(kdt)) << 3)
     | (is_close_i.astype(kdt) << 2) | cps.astype(kdt)),
    INF,
  )
  skeys = jnp.sort(keys, axis=1)
  is_inf_s = skeys == INF
  cps_s = (skeys & 3).astype(jnp.int32)
  is_close_s = ((skeys >> 2) & 1).astype(jnp.bool_) & ~is_inf_s
  body_s = skeys >> 3
  pos_s = (body_s % CAP).astype(jnp.int32)
  depth_s = (body_s // CAP).astype(jnp.int32)

  # reverse segmented scan: next close at same depth. Single-array
  # last-set scan: sentinel -1 means "keep the running value".
  seg_last = (depth_s != _shift_left(depth_s, -1)) | is_inf_s
  setf = is_close_s | seg_last
  e = jnp.where(setf, jnp.where(is_close_s, pos_s, CAP), -1)

  def comb(a, bb):
    return jnp.where(bb < 0, a, bb)

  nextclose_s = jax.lax.associative_scan(
    comb, e[:, ::-1], axis=1)[:, ::-1]
  nextclose_s = jnp.where(nextclose_s < 0, CAP, nextclose_s)

  # --- scope cancellation ---
  # every move adds its delta at its own index (elementwise) and
  # subtracts it at its unwind point: -delta = w_h + sxe * w_v with
  # w in {-1, 0, 1}.
  move_s = ~is_inf_s & ~is_close_s
  w_h = (jnp.where(move_s & (cps_s == LEFT), 1, 0)
         - jnp.where(move_s & (cps_s == RIGHT), 1, 0))
  w_v = (jnp.where(move_s & (cps_s == UP), 1, 0)
         - jnp.where(move_s & (cps_s == DOWN), 1, 0))
  tgt = jnp.where(move_s & (nextclose_s < CAP), nextclose_s, -1)
  cancel = _scatter_add_rows(tgt, w_h + sxe * w_v, CAP)

  deltas = jnp.where(
    cps == UP, -sxe,
    jnp.where(cps == RIGHT, 1, jnp.where(cps == DOWN, sxe, -1))
  ).astype(jnp.int32)
  deltas = jnp.where(is_move & valid, deltas, 0)

  acc = deltas + cancel

  # --- chain-start node contributions ---
  # every move's delta cancels at or before its chain's final close,
  # so the cumsum restarts at zero on each chain boundary and the
  # start-node base is purely additive per chain: pos = cumsum(acc) +
  # nodes[chain_of]. Only moves read the result.
  base = jnp.take_along_axis(nodes.astype(jnp.int32), chain_of, axis=1)
  pos_after = jnp.cumsum(acc, axis=1) + base
  pos_before = pos_after - deltas

  # --- paint presence rasters ---
  py = pos_before // sxe
  px = pos_before - py * sxe

  NV = sy * sxe
  NH = (sy + 1) * sx
  OOB = NV + NH

  active = is_move & valid
  vh_idx = jnp.where(
    active & (cps == UP), px + sxe * (py - 1),
    jnp.where(
      active & (cps == DOWN), px + sxe * py,
      jnp.where(
        active & (cps == LEFT), NV + (px - 1) + sx * py,
        jnp.where(active & (cps == RIGHT), NV + px + sx * py, OOB)
      )
    )
  )
  # negative/out-of-range indices (corrupt codes) drop
  VH = _scatter_presence_rows(vh_idx, OOB)
  V2 = VH[:, :NV].reshape(B, sy, sxe)
  H2 = VH[:, NV:].reshape(B, sy + 1, sx)

  vcg = (V2[:, :, 1:]
         | (V2[:, :, :sx] << 1)
         | (H2[:, 1:, :] << 2)
         | (H2[:, :sy, :] << 3))
  vcg = vcg.reshape(B, sy * sx)
  if not permissible:
    vcg = vcg ^ 0b1111
  return vcg


# ---------------------------------------------------------------------------
# CCL: alternating row/column segmented-min sweeps
# ---------------------------------------------------------------------------

def _seg_min_scan(L, blocked, axis):
  """Segmented min scan along axis: carry resets where blocked."""
  def comb(a, b):
    av, ab = a
    bv, bb = b
    return (jnp.where(bb, bv, jnp.minimum(av, bv)), ab | bb)
  return jax.lax.associative_scan(comb, (L, blocked), axis=axis)[0]


def _ccl_min(vcg, sx, sy):
  """Min-flat-index component image by sweeps to a fixed point.

  Returns (L (B, sy*sx) int32, sweeps int32): every pixel holds the
  smallest flat index of its 4-connected component; sweeps counts the
  four-scan sweeps run, the last of which changed nothing."""
  B = vcg.shape[0]
  n = sx * sy
  v2 = vcg.reshape(B, sy, sx)
  left_ok = (v2 & 0b0010) > 0   # connected to x-1
  up_ok = (v2 & 0b1000) > 0     # connected to y-1
  # explicit borders
  left_ok = left_ok.at[:, :, 0].set(False)
  up_ok = up_ok.at[:, 0, :].set(False)

  blocked_x_f = ~left_ok
  blocked_x_b = ~jnp.concatenate(
    [left_ok[:, :, 1:], jnp.zeros((B, sy, 1), bool)], axis=2
  )[:, :, ::-1]
  blocked_y_f = ~up_ok
  blocked_y_b = ~jnp.concatenate(
    [up_ok[:, 1:, :], jnp.zeros((B, 1, sx), bool)], axis=1
  )[:, ::-1, :]

  L0 = jnp.broadcast_to(
    jnp.arange(n, dtype=jnp.int32).reshape(1, sy, sx), (B, sy, sx)
  )

  def sweep(L):
    L = _seg_min_scan(L, blocked_x_f, axis=2)
    L = _seg_min_scan(L[:, :, ::-1], blocked_x_b, axis=2)[:, :, ::-1]
    L = _seg_min_scan(L, blocked_y_f, axis=1)
    L = _seg_min_scan(L[:, ::-1, :], blocked_y_b, axis=1)[:, ::-1, :]
    return L

  def cond(state):
    return state[1]

  def body(state):
    L, _, k = state
    L2 = sweep(L)
    return L2, jnp.any(L2 != L), k + 1

  L, _, sweeps = jax.lax.while_loop(
    cond, body, (sweep(L0), jnp.asarray(True), jnp.int32(1)))
  return L.reshape(B, n), sweeps


def _ccl_batch(vcg, sx, sy):
  """Batched 4-connected CCL from VCG with first-visit numbering.

  Components are labeled by their min flat index (_ccl_min), then
  renumbered densely by first raster visit. Returns (cc (B, sy*sx)
  int32, N (B,) int32)."""
  pf, _ = _ccl_min(vcg, sx, sy)
  n = sx * sy
  # first-visit renumber: component roots are min indices
  is_root = pf == jnp.arange(n, dtype=jnp.int32)[None, :]
  rank = jnp.cumsum(is_root.astype(jnp.int32), axis=1) - 1
  cc = jnp.take_along_axis(rank, pf, axis=1)
  N = rank[:, -1] + 1
  return cc, N


def paint_flat(cc, key_offsets, keys, lo, hi=None):
  """Flat-format label paint: window-local component ids -> labels.

  cc (B, n) int32, key_offsets (B,) int32 global index of each slice's
  first component, keys (total components,) int32 index into the
  unique-label table, lo/hi (n_labels,) uint32 low/high words of that
  table. Returns uint32 labels, or uint64 when hi is given. Two
  gathers, with no limit on components per slice."""
  ki = keys[cc + key_offsets[:, None]]
  if hi is None:
    return lo[ki]
  return lo[ki].astype(jnp.uint64) | (hi[ki].astype(jnp.uint64) << 32)


# ---------------------------------------------------------------------------
# Public entry points
# ---------------------------------------------------------------------------

@functools.partial(
  jax.jit, static_argnames=("sx", "sy", "permissible")
)
def decode_slices_to_ccl(packed, nbytes, nodes, n_chains,
                         sx: int, sy: int, permissible: bool):
  """Batched slice decode: packed crack bytes -> first-visit CCL.

  packed:   (B, CAP_B) uint8  packed move bytes (BOC stripped)
  nbytes:   (B,)       int32  valid byte count per slice
  nodes:    (B, CAP_CH) int32 chain start corner nodes (sorted)
  n_chains: (B,)       int32  valid chain count per slice

  Returns (cc_labels (B, sy*sx) int32, N (B,) int32).
  """
  vcg = _decode_vcg_batch(packed, nbytes, nodes, n_chains, sx, sy,
                          permissible)
  return _ccl_batch(vcg, sx, sy)


@functools.partial(
  jax.jit, static_argnames=("sx", "sy", "permissible")
)
def decode_slices_to_vcg(packed, nbytes, nodes, n_chains,
                         sx: int, sy: int, permissible: bool):
  """Batched slice decode to voxel connectivity graphs (B, sy*sx)."""
  return _decode_vcg_batch(packed, nbytes, nodes, n_chains, sx, sy,
                           permissible)


@functools.partial(
  jax.jit, static_argnames=("sx", "sy", "permissible", "cap_n")
)
def decode_slices_full_pins(packed, nbytes, nodes, n_chains,
                            pin_locs, pin_labs, single_ids,
                            single_labs, bg32,
                            sx: int, sy: int, permissible: bool,
                            cap_n: int = 0):
  """Fused device decode of condensed-pins streams.

  The per-slice component->label tables are built on device: each pin
  resolves the component it crosses with one small gather into the
  CCL image (labels.hpp:554-614 walks the same pin voxels serially),
  cc-singles index components directly, everything else is bgcolor.

  pin_locs:    (B, P) int32 in-slice flat positions (-1 = pad)
  pin_labs:    (B, P) int32 label values (uint32 bitcast)
  single_ids:  (B, S) int32 window-local component ids (-1 = pad)
  single_labs: (B, S) int32
  bg32:        scalar int32 background label

  Returns (labels uint32, cc int32, N int32) — device-resident.
  """
  B = packed.shape[0]
  cc, N = decode_slices_to_ccl.__wrapped__(
    packed, nbytes, nodes, n_chains, sx=sx, sy=sy,
    permissible=permissible)

  T = jnp.full((B, cap_n + 1), bg32, jnp.int32)
  rows = jnp.arange(B, dtype=jnp.int32)[:, None]
  s_tgt = jnp.where(
    (single_ids >= 0) & (single_ids < cap_n), single_ids, cap_n)
  T = T.at[rows, s_tgt].set(single_labs, mode='drop')
  ccv = jnp.take_along_axis(cc, jnp.clip(pin_locs, 0, None), axis=1)
  p_tgt = jnp.where(pin_locs >= 0, ccv, cap_n)
  T = T.at[rows, p_tgt].set(pin_labs, mode='drop')

  painted = jnp.take_along_axis(T, jnp.clip(cc, 0, cap_n), axis=1)
  labels = jax.lax.bitcast_convert_type(painted, jnp.uint32)
  return labels, cc, N


@functools.partial(
  jax.jit, static_argnames=("sx", "sy", "permissible")
)
def decode_slices_full(packed, nbytes, nodes, n_chains, key_offsets,
                       keys, lo, hi=None, *,
                       sx: int, sy: int, permissible: bool):
  """Fused decode of flat-label slices straight to painted labels
  (paint_flat: uint32, or uint64 when hi is given).

  Returns (labels (B, sy*sx), cc (B, sy*sx) int32, N (B,)), all on
  the device, for downstream device code to consume directly."""
  cc, N = decode_slices_to_ccl.__wrapped__(
    packed, nbytes, nodes, n_chains, sx=sx, sy=sy,
    permissible=permissible)
  return paint_flat(cc, key_offsets, keys, lo, hi), cc, N


@jax.jit
def paint_keys(cc, key_offsets, keys):
  """cc (B, n) window-local component ids -> uniq-index keys."""
  return keys[cc + key_offsets[:, None]]
