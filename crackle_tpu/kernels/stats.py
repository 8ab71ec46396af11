"""Per-component slice statistics on the device: counts, coordinate
sums (centroids) and x/y extents (bounding boxes) in one pass over the
CCL images.

Reference parity: operations.hpp voxel_counts (321-419), centroids
(421-539), bounding_boxes (541-665) walk each decoded slice with
per-voxel scalar loops on a thread pool. Here the decoded CCL images
(already on device from the decode) reduce with segment sums, minima
and maxima keyed by (slice, component). The host maps component ids
to labels (flat-format key tables) and aggregates, which is
O(total components), not O(voxels).
"""
import functools

import jax
import jax.numpy as jnp

# output channel layout (last axis of the stats block)
CH_COUNT, CH_XSUM, CH_YSUM, CH_XMIN, CH_XMAX, CH_YMIN, CH_YMAX = \
  range(7)


@functools.partial(jax.jit, static_argnames=("sx", "sy", "cap_n"))
def slice_stats(cc, sx: int, sy: int, cap_n: int):
  """cc: (B, sy*sx) int32 CCL images with ids < cap_n ->
  (B, cap_n, 7) int64 stats, channels as CH_* above. Empty components
  carry count 0 and meaningless extents."""
  B = cc.shape[0]
  n = sx * sy
  seg = (cc + (jnp.arange(B, dtype=jnp.int32) * cap_n)[:, None]) \
    .reshape(-1)
  pix = jnp.arange(n, dtype=jnp.int64)
  x = jnp.broadcast_to(pix % sx, (B, n)).reshape(-1)
  y = jnp.broadcast_to(pix // sx, (B, n)).reshape(-1)
  nseg = B * cap_n
  cols = [
    jax.ops.segment_sum(jnp.ones_like(x), seg, nseg),
    jax.ops.segment_sum(x, seg, nseg),
    jax.ops.segment_sum(y, seg, nseg),
    jax.ops.segment_min(x, seg, nseg),
    jax.ops.segment_max(x, seg, nseg),
    jax.ops.segment_min(y, seg, nseg),
    jax.ops.segment_max(y, seg, nseg),
  ]
  return jnp.stack(cols, axis=-1).reshape(B, cap_n, len(cols))
