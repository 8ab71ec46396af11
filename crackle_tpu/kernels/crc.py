"""CRC32C on the device as bit-linear algebra.

CRC is linear over GF(2): with R0(m) = the register after folding
message m into a ZERO-initialised register, and A = the advance-by-
one-zero-byte 32x32 GF(2) matrix,

    crc(m) = R0(m) XOR A^len(m)(0xFFFFFFFF) XOR 0xFFFFFFFF

and R0 satisfies R0(m1 ++ m2) = A^len(m2)(R0(m1)) XOR R0(m2), with
R0 of an all-zero prefix = 0 (leading zeros are free). That turns
per-slice CRC32C of the decoded CCL images (the format's per-slice
integrity words, README.md:233-253, crackle.hpp:599-611) into
matrix products with a FIXED-SIZE table:

  1. front-pad each (W,)-word message with zero words to a multiple
     of W_BLK and split into blocks;
  2. per block, R0 = XOR over bitplanes j of parity((bits_j) @ K[j])
     where K is the (32, W_BLK, 32) contribution table of ONE block —
     each per-j matmul sums at most W_BLK ones, so the f32
     accumulation is exact and the parity is taken per plane
     (no cross-plane f32 accumulation: 32*W can exceed 2^24);
  3. a log-depth fold combines block registers with batched
     (n, 32) @ (32, 32) GF(2) matmuls against precomputed A^(2^l)
     advance matrices.

Operands are bf16 0/1 values with float32 accumulation, so every
product is exact on any backend (tensor cores included: TF32 rounding
never applies to bf16 inputs). Table memory is 2 KB/word * W_BLK
(bf16) regardless of message length; the host-side numpy
intermediates are O(W_BLK) as well.

The reference computes these CRCs serially via hardware/table kernels
(third_party/fastcrc); this is the data-parallel equivalent, letting
the device-resident serving path (engine.DeviceStream) verify stream
integrity without a device->host round trip.
"""
import functools

import numpy as np
import jax
import jax.numpy as jnp

_POLY = 0x82F63B78  # reflected Castagnoli

W_BLK = 512  # words per block; table = (32, W_BLK, 32) bf16 = 1 MB


def _byte_table() -> np.ndarray:
  """T[i] = register contribution of one message byte i (the standard
  reflected table; linear in i over GF(2))."""
  T = np.zeros(256, dtype=np.uint64)
  for i in range(256):
    crc = i
    for _ in range(8):
      crc = (crc >> 1) ^ _POLY if (crc & 1) else (crc >> 1)
    T[i] = crc
  return T.astype(np.uint32)


def _matmul_gf2(Ma, Mb):
  """Columns of Ma @ Mb over GF(2); each M is 32 u32 columns."""
  out = np.zeros(32, dtype=np.uint32)
  for b in range(32):
    v = Mb[b]
    acc = np.uint32(0)
    for k in range(32):
      if (v >> np.uint32(k)) & np.uint32(1):
        acc ^= Ma[k]
    out[b] = acc
  return out


@functools.lru_cache(maxsize=64)
def _advance_matrix_pow(n_bytes: int) -> tuple:
  """Columns (as u32) of A^n_bytes where A = advance register by one
  zero byte: A(r) = (r >> 8) ^ T[r & 0xff]."""
  T = _byte_table()
  cols = np.zeros(32, dtype=np.uint32)
  for b in range(32):
    r = np.uint32(1 << b)
    cols[b] = (r >> np.uint32(8)) ^ T[r & np.uint32(0xFF)]
  M = cols
  R = np.array([np.uint32(1 << b) for b in range(32)], dtype=np.uint32)
  n = n_bytes
  while n:
    if n & 1:
      R = _matmul_gf2(M, R)
    M = _matmul_gf2(M, M)
    n >>= 1
  return tuple(int(x) for x in R)


def _apply_cols_np(cols: np.ndarray, vals: np.ndarray) -> np.ndarray:
  """Apply a GF(2) 32x32 matrix (u32 columns) to an array of u32."""
  acc = np.zeros_like(vals)
  for b in range(32):
    acc ^= np.where((vals >> np.uint32(b)) & np.uint32(1),
                    cols[b], np.uint32(0))
  return acc


@functools.lru_cache(maxsize=1)
def _block_table_np() -> np.ndarray:
  """D (W_BLK, 32) uint32: D[w][j] = contribution of bit j of
  little-endian u32 word w to R0 of one W_BLK-word block; built
  back-to-front by doubling."""
  T = _byte_table()
  # bit j of a word = byte j//8 of the word, bit j%8 within the byte;
  # its contribution inside the final word is T[1<<(j%8)] advanced by
  # the 3 - j//8 bytes that follow it within the word.
  last = np.zeros(32, dtype=np.uint32)
  for j in range(32):
    v = T[np.uint32(1 << (j % 8))]
    for _ in range(3 - (j // 8)):
      v = (v >> np.uint32(8)) ^ T[v & np.uint32(0xFF)]
    last[j] = v
  D = last[None, :]
  while D.shape[0] < W_BLK:
    m = D.shape[0]
    cols = np.array(_advance_matrix_pow(4 * m), np.uint32)
    D = np.concatenate([_apply_cols_np(cols, D), D], axis=0)
  return D[-W_BLK:]


@functools.lru_cache(maxsize=1)
def _device_block_table():
  """(32, W_BLK, 32) bf16 bitplane table K: K[j][w][b] = bit b of the
  contribution of bit j of block word w."""
  D = _block_table_np()
  bits = (D[:, :, None] >> np.arange(32, dtype=np.uint32)[None, None, :]
          ) & np.uint32(1)  # (W_BLK, 32j, 32b)
  # numpy-resident (bf16 via ml_dtypes): the first call can happen
  # inside a jit trace, where jnp.asarray would leak a tracer into
  # the cache; as a numpy constant it embeds per-trace instead
  return np.transpose(bits, (1, 0, 2)).astype(np.float32) \
    .astype(jnp.bfloat16)


@functools.lru_cache(maxsize=16)
def _device_advance_bits(n_bytes: int):
  """(32, 32) bf16 M with M[i][b] = bit b of column i of A^n_bytes:
  regbits' = parity(regbits @ M)."""
  cols = np.array(_advance_matrix_pow(n_bytes), np.uint32)
  M = (cols[:, None] >> np.arange(32, dtype=np.uint32)[None, :]
       ) & np.uint32(1)
  return M.astype(np.float32).astype(jnp.bfloat16)  # numpy-resident


@functools.lru_cache(maxsize=1024)
def _c0(n_words: int) -> int:
  """crc of the all-zero n-word message: init 0xFFFFFFFF advanced by
  4n bytes, xorout 0xFFFFFFFF."""
  cols = np.array(_advance_matrix_pow(4 * n_words), np.uint32)
  c0 = _apply_cols_np(cols, np.array([0xFFFFFFFF], np.uint32))[0]
  return int(c0 ^ np.uint32(0xFFFFFFFF))


def _block_r0(blocks, K):
  """R0 parity bits of each block. blocks: (n, W_BLK) uint32.
  Returns (n, 32) int32 in {0, 1}. Each per-plane matmul sums at most
  W_BLK ones — exact in f32 — and parities XOR across planes."""
  S = jnp.zeros((blocks.shape[0], 32), jnp.int32)
  for j in range(32):
    bits_j = ((blocks >> jnp.uint32(j)) & jnp.uint32(1)) \
      .astype(jnp.bfloat16)
    dot = jax.lax.dot_general(
      bits_j, K[j], (((1,), (0,)), ((), ())),
      preferred_element_type=jnp.float32,
    )
    S = S ^ (dot.astype(jnp.int32) & 1)
  return S


def crc32c_words_traced(words, c0):
  """crc32c of each row of `words` ((B, W) int32/uint32 bitcast of the
  little-endian message). Call inside jit. Returns (B,) uint32."""
  B, W = words.shape
  w32 = jax.lax.bitcast_convert_type(words, jnp.uint32)
  npad = (-W) % W_BLK
  if npad:
    # leading zero words leave R0 unchanged; the true length enters
    # only through c0
    w32 = jnp.concatenate(
      [jnp.zeros((B, npad), jnp.uint32), w32], axis=1)
  nblk = w32.shape[1] // W_BLK
  K = _device_block_table()
  R = _block_r0(w32.reshape(B * nblk, W_BLK), K).reshape(B, nblk, 32)

  # log-depth fold: combine(left, right) = advance(left) XOR right,
  # zero-block left pads are absorbed for free (advance(0) = 0)
  level = 0
  while nblk > 1:
    if nblk % 2:
      R = jnp.concatenate(
        [jnp.zeros((B, 1, 32), jnp.int32), R], axis=1)
      nblk += 1
    M = _device_advance_bits(4 * W_BLK * (1 << level))
    left = R[:, 0::2].reshape(B * (nblk // 2), 32)
    adv = jax.lax.dot_general(
      left.astype(jnp.bfloat16), M, (((1,), (0,)), ((), ())),
      preferred_element_type=jnp.float32,
    ).astype(jnp.int32) & 1
    R = adv.reshape(B, nblk // 2, 32) ^ R[:, 1::2]
    nblk //= 2
    level += 1

  crc = jnp.sum(
    R[:, 0].astype(jnp.uint32) << jnp.arange(32, dtype=jnp.uint32)[None, :],
    axis=1, dtype=jnp.uint32)
  return crc ^ c0


@jax.jit
def _crc32c_jit(words, c0):
  return crc32c_words_traced(words, c0)


def crc32c_device(words) -> jnp.ndarray:
  """Device CRC32C of each (W,)-word row; rows are independent
  messages of 4*W bytes. Accepts (B, W) int32/uint32."""
  _B, W = words.shape
  return _crc32c_jit(words, jnp.uint32(_c0(W)))
