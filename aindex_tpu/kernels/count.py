"""Device-side k-mer counting kernels.

The reference counts with per-thread atomic fetch_add into a shared table
(/root/reference/src/count_kmers13.cpp:141-160, src/hash.hpp:224-243). Here
it is a masked scatter-add over a dense device table (atomic adds on a GPU;
integer adds commute, so the counts are exact and the same in every run),
mergeable across devices with a single psum (SURVEY.md section 2.7).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from aindex_tpu.constants import SPACE_13
from aindex_tpu.kernels.encode import (ascii_to_base_codes, unpack_base_codes,
                                       window_codes)


@functools.partial(jax.jit, static_argnames=("shape", "dtype"))
def zeros_dev(shape, dtype=jnp.uint32) -> jax.Array:
    """Allocate zeros ON DEVICE. ``jnp.zeros`` outside jit materialises the
    buffer on the host and transfers it (256 MB for the dense table);
    under jit it is a device-side fill."""
    return jnp.zeros(shape, dtype)


@functools.partial(jax.jit, static_argnames=("space",))
def scatter_count(codes: jax.Array, valid: jax.Array, space: int = SPACE_13,
                  dtype=jnp.uint32) -> jax.Array:
    """Dense histogram of k-mer codes: counts[c] = # valid windows with code c.

    Invalid windows contribute weight 0 (they still target a real slot, but
    add nothing), keeping the scatter shape static.
    """
    flat_codes = codes.reshape(-1).astype(jnp.int32)
    weights = valid.reshape(-1).astype(dtype)
    zeros = jnp.zeros((space,), dtype=dtype)
    return zeros.at[flat_codes].add(weights, mode="drop")


@functools.partial(jax.jit, static_argnames=("space",))
def scatter_count_into(counts: jax.Array, codes: jax.Array, valid: jax.Array,
                       space: int = SPACE_13) -> jax.Array:
    """Accumulating variant for streaming over read batches (donate counts)."""
    flat_codes = codes.reshape(-1).astype(jnp.int32)
    weights = valid.reshape(-1).astype(counts.dtype)
    return counts.at[flat_codes].add(weights, mode="drop")


@functools.partial(jax.jit, static_argnames=("k", "space"))
def count_batch_13(counts: jax.Array, ascii_batch: jax.Array, k: int = 13,
                   space: int = SPACE_13) -> jax.Array:
    """Fused: ASCII read batch -> base codes -> windows -> scatter-add.

    ``ascii_batch`` is uint8[B, L] padded with a non-ACGT byte (e.g. 0);
    padding windows are masked out by the validity computation. Forward
    strand only, matching count_kmers13 semantics
    (/root/reference/src/count_kmers13.cpp:141-160 — no canonicalisation).
    """
    base = ascii_to_base_codes(ascii_batch)
    codes, valid = window_codes(base, k, out_dtype=jnp.uint32)
    return scatter_count_into(counts, codes, valid, space)


@functools.partial(jax.jit, static_argnames=("k", "space"))
def count_batch_13_packed(counts: jax.Array, packed: jax.Array,
                          validbits: jax.Array, k: int = 13,
                          space: int = SPACE_13) -> jax.Array:
    """``count_batch_13`` over the packed ingest format
    (codec.pack_ascii_chunk): 0.375 bytes/base on the wire instead of 1 —
    the H2D link bounds build throughput, not device compute."""
    base = unpack_base_codes(packed, validbits)
    codes, valid = window_codes(base, k, out_dtype=jnp.uint32)
    return scatter_count_into(counts, codes, valid, space)
