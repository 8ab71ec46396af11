"""Generate + compress the canonical benchmark volumes into
bench_data/ (cached; the .ckl streams are committed, the raw .npy of
the 512^3 volume is too large for git and is regenerated on demand).

Runs on the CPU: encode is host-side, and the GPU stays free for the
benchmark process (one JAX process per card).
"""
import os
import sys
import time

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(
  os.path.abspath(__file__))))
from bench import BENCH_DIR, synthetic_connectomics  # noqa: E402


def main():
  import crackle_tpu as crackle
  os.makedirs(BENCH_DIR, exist_ok=True)

  # canonical 512^3 (the reference's headline benchmark shape,
  # benchmarks/README.md:243-282), v2 generator calibrated to the
  # published ~0.56% connectomics compression profile
  path = os.path.join(BENCH_DIR, "connectomics_v2_512x512x512.ckl")
  if not os.path.exists(path):
    t0 = time.time()
    vol = synthetic_connectomics((512, 512, 512))
    print(f"512^3 gen: {time.time() - t0:.0f}s", flush=True)
    t0 = time.time()
    binary = crackle.compress(vol)
    print(f"512^3 encode: {time.time() - t0:.0f}s, "
          f"ratio {len(binary) / vol.nbytes:.4%}", flush=True)
    with open(path, "wb") as f:
      f.write(binary)
    del vol

  # pins / markov-5 variants of the committed 256^2x128 volume (the
  # device-serving bench sections for the non-flat format paths)
  vp = os.path.join(BENCH_DIR, "connectomics_v2_256x256x128.ckl.npz")
  if os.path.exists(vp):
    vol = np.asfortranarray(np.load(vp)["vol"])
    for name, kwargs in [
        ("connectomics_v2_pins_256x256x128.ckl", dict(allow_pins=1)),
        ("connectomics_v2_mkv5_256x256x128.ckl",
         dict(markov_model_order=5)),
    ]:
      p = os.path.join(BENCH_DIR, name)
      if not os.path.exists(p):
        binary = crackle.compress(vol, **kwargs)
        print(f"{name}: ratio {len(binary) / vol.nbytes:.4%}",
              flush=True)
        with open(p, "wb") as f:
          f.write(binary)
    del vol

  # u64 watershed proxy (ws.npy class: oversegmented, small cells,
  # 64-bit labels; reference cutouts compress to ~1.65%,
  # benchmarks/README.md:50-53)
  wpath = os.path.join(BENCH_DIR, "watershed_u64_256x256x128.ckl")
  if not os.path.exists(wpath):
    import bench as _b
    rng = np.random.RandomState(7)
    sx, sy, sz = 256, 256, 128
    dims = np.array([sx, sy, sz], float)
    pts = rng.rand(4200, 3) * dims
    aniso = np.array([1.0, 1.0, 0.35])
    from scipy.spatial import cKDTree
    tree = cKDTree(pts * aniso)
    xs, ys, zs = np.meshgrid(np.arange(sx), np.arange(sy),
                             np.arange(sz), indexing='ij')
    q = np.stack([xs.ravel(), ys.ravel(), zs.ravel()], axis=1) * aniso
    _, idx = tree.query(q, workers=-1)
    vol = np.asfortranarray(
      (idx.astype(np.uint64) + np.uint64(2) ** 40 + 1)
      .reshape(sx, sy, sz))
    binary = crackle.compress(vol)
    print(f"watershed u64: ratio {len(binary) / vol.nbytes:.4%}",
          flush=True)
    with open(wpath, "wb") as f:
      f.write(binary)
    del vol

  # pathological binary noise (reference per-pattern table,
  # benchmarks/README.md:148-241): 512^2 slices, ~300K codepoints
  npath = os.path.join(BENCH_DIR, "binary_noise_512x512x16.ckl")
  if not os.path.exists(npath):
    rng = np.random.RandomState(99)
    vol = np.asfortranarray(
      rng.randint(0, 2, size=(512, 512, 16)).astype(np.uint32))
    t0 = time.time()
    binary = crackle.compress(vol)
    print(f"noise encode: {time.time() - t0:.0f}s, "
          f"ratio {len(binary) / vol.nbytes:.4%}", flush=True)
    with open(npath, "wb") as f:
      f.write(binary)
  print("done", flush=True)


if __name__ == "__main__":
  main()
