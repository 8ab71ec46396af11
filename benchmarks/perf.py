"""Per-pattern encode/decode throughput benchmark (reference parity:
benchmarks/perf.py). Measures MVx/s for both the host engine and, on
a GPU, the device engine, across the reference's test patterns:
connectomics-like, watershed-like (u64), random noise, binary noise,
and empty volumes.

Usage: python benchmarks/perf.py [--shape 256,256,64] [--engine auto]
"""
import argparse
import sys
import time

import numpy as np

sys.path.insert(0, __file__.rsplit('/', 2)[0])
import crackle_tpu as crackle


def connectomics_like(shape, seed=42):
  # the calibrated two-scale generator (bench.synthetic_connectomics):
  # a 256x256x64 cutout compresses to ~0.565% flat / 0.544% pins /
  # 0.403% markov-5, matching the published connectomics.npy profile
  # (benchmarks/README.md:10-14 in the reference)
  import bench
  return bench.synthetic_connectomics(shape, seed=seed)


def watershed_like(shape, seed=1):
  # u64 oversegmentation (ws.npy profile ~1.65%): dense uniform
  # anisotropic Voronoi, one seed per ~2000 voxels
  from scipy.spatial import cKDTree
  rng = np.random.RandomState(seed)
  sx, sy, sz = shape
  n_seeds = max(sx * sy * sz // 2000, 10)
  pts = rng.rand(n_seeds, 3) * np.array(shape)
  aniso = np.array([1.0, 1.0, 0.35])
  tree = cKDTree(pts * aniso)
  xs, ys, zs = np.meshgrid(*[np.arange(s) for s in shape],
                           indexing='ij')
  q = np.stack([xs.ravel(), ys.ravel(), zs.ravel()], axis=1) * aniso
  _, idx = tree.query(q, workers=-1)
  return np.asfortranarray(
    (idx.astype(np.uint64) + np.uint64(2) ** 40 + 1).reshape(shape))


def random_noise(shape, seed=2):
  return np.asfortranarray(
    np.random.RandomState(seed).randint(0, 2000, size=shape)
    .astype(np.uint32)
  )


def binary_noise(shape, seed=3):
  return np.asfortranarray(
    (np.random.RandomState(seed).rand(*shape) > 0.5).astype(np.uint8)
  )


def empty(shape, seed=None):
  return np.zeros(shape, dtype=np.uint32, order="F")


PATTERNS = {
  "connectomics": connectomics_like,
  "watershed_u64": watershed_like,
  "random_noise": random_noise,
  "binary_noise": binary_noise,
  "empty": empty,
}


def mvx(voxels, dt):
  return voxels / dt / 1e6


def main():
  ap = argparse.ArgumentParser()
  ap.add_argument("--shape", default="256,256,64")
  ap.add_argument("--engine", default="auto",
                  choices=["auto", "numpy", "jax"])
  ap.add_argument("--patterns", default=",".join(PATTERNS))
  args = ap.parse_args()

  shape = tuple(int(s) for s in args.shape.split(","))
  crackle.codec.set_engine(args.engine)
  voxels = int(np.prod(shape))

  print(f"shape={shape} engine={args.engine}")
  print(f"{'pattern':16s} {'ratio':>9s} {'enc MVx/s':>10s} "
        f"{'dec MVx/s':>10s}")

  for name in args.patterns.split(","):
    vol = PATTERNS[name](shape)
    t0 = time.perf_counter()
    binary = crackle.compress(vol)
    enc_dt = time.perf_counter() - t0

    out = crackle.decompress(binary)  # warm any jit caches
    assert np.array_equal(out, vol), name
    times = []
    for _ in range(3):
      t0 = time.perf_counter()
      out = crackle.decompress(binary)
      times.append(time.perf_counter() - t0)
    dec_dt = min(times)

    print(f"{name:16s} {len(binary) / vol.nbytes:9.4%} "
          f"{mvx(voxels, enc_dt):10.1f} {mvx(voxels, dec_dt):10.1f}")


if __name__ == "__main__":
  main()
