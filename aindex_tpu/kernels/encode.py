"""Device-side (JAX) encoding and k-mer window extraction.

The reference extracts k-mers with per-byte scalar loops
(/root/reference/src/dna_bitseq.hpp:124-151, src/hash.cpp:1006-1022). On the
device this becomes a vectorised sliding window over a base-code tensor: k static
shift-or steps produce every window's 2-bit packed code at once, and window
validity is a difference of prefix sums over an invalid-base indicator —
no halo seeking, no data-dependent control flow (SURVEY.md section 2.7).

All functions are jit-compatible with static ``k``.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from aindex_tpu.constants import INVALID_CODE


@functools.partial(jax.jit)
def ascii_to_base_codes(ascii_u8: jax.Array) -> jax.Array:
    """ASCII byte tensor -> 2-bit base codes (INVALID_CODE for non-ACGT).

    Pure elementwise arithmetic, no table lookup: XLA fuses it into the
    consumer, where a 256-entry table would cost a gather per byte. The
    ASCII codes
    of A/C/G/T happen to encode the base in bits 1-2: ``x = (c >> 1) & 3``
    gives A=0 C=1 G=3 T=2, and ``x ^ (x >> 1)`` swaps 2<->3 into the
    canonical A=0 C=1 G=2 T=3 (/root/reference/src/kmers.hpp:15-20).
    Case-insensitive (bit 5 never reaches bits 1-2); anything outside
    ACGT/acgt maps to INVALID_CODE, verified bit-identical to the 256-entry
    host LUT for every byte value.
    """
    up = ascii_u8 & jnp.uint8(0xDF)  # fold lowercase onto uppercase
    valid = (up == 65) | (up == 67) | (up == 71) | (up == 84)  # A C G T
    x = (ascii_u8 >> 1) & jnp.uint8(3)
    code = x ^ (x >> 1)
    return jnp.where(valid, code, jnp.uint8(INVALID_CODE))


@jax.jit
def unpack_base_codes(packed: jax.Array, validbits: jax.Array) -> jax.Array:
    """Packed ingest (codec.pack_ascii_chunk) -> uint8 base codes with
    INVALID_CODE at invalid positions.

    ``packed`` uint32[..., W] carries 16 bases/word, ``validbits``
    uint8[..., 2W] one bit/base (both little-endian). Pure broadcast
    shift/mask work — no gathers.
    """
    shifts = 2 * jnp.arange(16, dtype=jnp.uint32)
    b = ((packed[..., :, None] >> shifts) & 3).astype(jnp.uint8)
    b = b.reshape(*packed.shape[:-1], -1)
    v = (validbits[..., :, None] >> jnp.arange(8, dtype=jnp.uint8)) & 1
    v = v.reshape(*validbits.shape[:-1], -1).astype(jnp.bool_)
    return jnp.where(v, b, jnp.uint8(INVALID_CODE))


@functools.partial(jax.jit, static_argnames=("k", "out_dtype"))
def window_codes(base_codes: jax.Array, k: int, out_dtype=jnp.uint32):
    """Packed k-mer codes for every window of a base-code array.

    Args:
      base_codes: uint8[..., L] 2-bit base codes (INVALID_CODE = invalid).
      k: window length (static). Use out_dtype=jnp.uint32 for k <= 16,
         jnp.uint64 for k <= 32.

    Returns:
      (codes, valid): codes[..., L-k+1] packed windows, valid[..., L-k+1]
      bool mask (False if any base in the window is invalid).

    Replaces the scalar packing loop of dna_bitset::ukmer
    (/root/reference/src/dna_bitseq.hpp:124-151) with k fused shift-or steps.
    """
    L = base_codes.shape[-1]
    n_win = L - k + 1
    if n_win <= 0:
        raise ValueError(f"sequence length {L} shorter than k={k}")
    invalid = (base_codes >= 4).astype(jnp.int32)
    # Window validity via prefix sums: window i is valid iff no invalid base
    # occurs in [i, i+k).
    csum = jnp.cumsum(invalid, axis=-1)
    head = jnp.zeros_like(csum[..., :1])
    csum = jnp.concatenate([head, csum], axis=-1)
    valid = (csum[..., k:] - csum[..., :-k]) == 0

    b = (base_codes & 3).astype(out_dtype)
    acc = jax.lax.slice_in_dim(b, 0, n_win, axis=-1)
    for j in range(1, k):
        acc = (acc << 2) | jax.lax.slice_in_dim(b, j, j + n_win, axis=-1)
    return acc, valid


@functools.partial(jax.jit, static_argnames=("k", "out_dtype"))
def packed_window_codes(packed: jax.Array, validbits: jax.Array, k: int,
                        out_dtype=jnp.uint32):
    """``window_codes`` over the packed ingest format (unpack fused in)."""
    return window_codes(unpack_base_codes(packed, validbits), k,
                        out_dtype=out_dtype)


@functools.partial(jax.jit, static_argnames=("k",))
def revcomp_code13(codes: jax.Array, k: int = 13) -> jax.Array:
    """Reverse complement of <=16-mer codes held in uint32 (branch-free).

    32-bit analogue of reverseDNA (/root/reference/src/kmers.cpp:355-388):
    complement = NOT of each 2-bit field, then mirror the 2-bit fields and
    shift down to the low 2k bits. Elementwise integer ops only.
    """
    x = (~codes).astype(jnp.uint32)
    m2 = jnp.uint32(0x33333333)
    m4 = jnp.uint32(0x0F0F0F0F)
    m8 = jnp.uint32(0x00FF00FF)
    x = ((x >> 2) & m2) | ((x & m2) << 2)
    x = ((x >> 4) & m4) | ((x & m4) << 4)
    x = ((x >> 8) & m8) | ((x & m8) << 8)
    x = (x >> 16) | (x << 16)
    return x >> (32 - 2 * k)


@functools.partial(jax.jit, static_argnames=("k",))
def revcomp_code64(codes: jax.Array, k: int) -> jax.Array:
    """Reverse complement of <=32-mer codes held in uint64 (branch-free)."""
    x = (~codes).astype(jnp.uint64)
    m2 = jnp.uint64(0x3333333333333333)
    m4 = jnp.uint64(0x0F0F0F0F0F0F0F0F)
    m8 = jnp.uint64(0x00FF00FF00FF00FF)
    m16 = jnp.uint64(0x0000FFFF0000FFFF)
    x = ((x >> 2) & m2) | ((x & m2) << 2)
    x = ((x >> 4) & m4) | ((x & m4) << 4)
    x = ((x >> 8) & m8) | ((x & m8) << 8)
    x = ((x >> 16) & m16) | ((x & m16) << 16)
    x = (x >> 32) | (x << 32)
    return x >> (64 - 2 * k)


@functools.partial(jax.jit, static_argnames=("k",))
def canonical_code64(codes: jax.Array, k: int) -> jax.Array:
    """min(code, revcomp) canonical form on device
    (/root/reference/src/count_kmers.cpp:132-136)."""
    return jnp.minimum(codes, revcomp_code64(codes, k))


def pad_to(arr: np.ndarray, length: int, fill) -> np.ndarray:
    """Host-side right-pad helper producing static shapes for jit."""
    if arr.shape[-1] >= length:
        return arr[..., :length]
    pad = [(0, 0)] * (arr.ndim - 1) + [(0, length - arr.shape[-1])]
    return np.pad(arr, pad, constant_values=fill)
