"""crackle_tpu: a JAX lossless compression codec for 3D dense
segmentation volumes, with the full capabilities of seung-lab/crackle.

The structure of each 2D z-slice (boundaries between labels) is stored
as a Freeman-style crack code on the dual grid, separately from the
coloring (a label map from per-slice connected-component ids to label
values, stored flat or as 3D pins). Crack codes can optionally pass
through an order-k Markov context model. A 29-byte header, per-slice
z-index, and layered CRCs frame the stream, enabling random z access,
label queries, and in-place remapping without decompression.

Unlike the C++/SIMD reference, the compute path here is data-parallel:
vectorized numpy on host and JAX/XLA programs on the accelerator (an
NVIDIA GPU), with z-slices sharded across devices via jax.sharding
(crackle_tpu.parallel).
"""
from .array import CrackleArray, CrackleDeviceArray, CrackleRemoteArray
from .codec import (
  compress, compressa, decompress, labels, labels_for_z_range,
  nbytes, components, component_lengths,
  header, contains, contains_range, crack_codes, num_labels,
  reencode, condense_unique, ok, check,
  raw_labels, background_color, decode_pins,
)
from .ops.analytics import (
  point_cloud, voxel_counts, centroids, bounding_boxes, each, cache_meta,
)
from .operations import (
  astype, ascontiguousarray, asfortranarray,
  remap, refit, renumber,
  min, max,
  zstack, zsplit, zshatter,
  full, zeros, ones,
  add_scalar, subtract_scalar,
  multiply_scalar, floordiv_scalar,
  recompress, connected_components,
  mask, mask_except,
  voxel_connectivity_graph,
  contacts,
  array_equal, structure_equal,
  mode_pooling_2x2x1,
)
from .headers import FormatError, CrackleHeader
from .util import save, load, aload, bload, rload, save_numpy

__version__ = "0.1.0"
