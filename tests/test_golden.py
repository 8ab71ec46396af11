"""Differential tests against fixtures produced by the ACTUAL
reference implementation (generated by tests/golden/generate.py, which
compiles /root/reference/src/crackle.hpp). Two directions:

  1. our compress() is BYTE-IDENTICAL to the reference stream,
  2. our decompress() decodes reference-produced bytes exactly.

This pins interop so it cannot silently regress. The matrix covers dtype u8-u64 x {flat, condensed
pins, optimized pins} x markov orders {0,1,3,5,7} x edge cases
(uniform, zeros, arange, binary noise, single slice).
"""
import json
import os
import sys

import numpy as np
import pytest

import crackle_tpu as crackle

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, 'golden'))
from volumes import CASES, make_volume  # noqa: E402

FIXDIR = os.path.join(HERE, 'golden', 'fixtures')


def _load(name: str) -> bytes:
  with open(os.path.join(FIXDIR, name + '.ckl'), 'rb') as f:
    return f.read()


def test_manifest_matches_cases():
  """The checked-in fixtures were generated from the CASES matrix in
  its current form (stale fixtures would test the wrong volumes)."""
  with open(os.path.join(FIXDIR, 'manifest.json')) as f:
    manifest = json.load(f)
  assert [m['name'] for m in manifest] == [c[0] for c in CASES]
  for m, (name, spec, opts) in zip(manifest, CASES):
    assert m['spec'] == json.loads(json.dumps(spec)), name
    assert m['opts'] == json.loads(json.dumps(opts)), name


@pytest.mark.parametrize(
  'name,spec,opts', CASES, ids=[c[0] for c in CASES])
def test_compress_byte_identical(name, spec, opts):
  vol = make_volume(spec)
  want = _load(name)
  got = crackle.compress(vol, **opts)
  assert got == want, (
    f'{name}: {len(got)} vs {len(want)} bytes; first diff at '
    f'{next((i for i, (a, b) in enumerate(zip(got, want)) if a != b), -1)}')


@pytest.mark.parametrize(
  'name,spec,opts', CASES, ids=[c[0] for c in CASES])
def test_decompress_reference_bytes(name, spec, opts):
  vol = make_volume(spec)
  out = crackle.decompress(_load(name))
  assert out.dtype == vol.dtype
  np.testing.assert_array_equal(out, vol)
