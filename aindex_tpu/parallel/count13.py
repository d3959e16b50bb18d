"""Data-parallel dense 13-mer counting over a device mesh.

Mesh replacement for the reference's atomic shared-table counting
(/root/reference/src/count_kmers13.cpp:141-160): each device scatter-adds the
windows of its read shard into a local table, then a single ``psum`` over the
``data`` axis merges partials into the replicated table (SURVEY.md §2.7).
Integer adds commute, so the result is exact and the same in every run,
whatever order the GPU's scatter atomics land in.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import shard_map
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from aindex_tpu.constants import K13, SPACE_13
from aindex_tpu.kernels.encode import unpack_base_codes, window_codes
from aindex_tpu.parallel.mesh import DATA_AXIS


def _local_count(packed: jax.Array, validbits: jax.Array, k: int,
                 space: int) -> jax.Array:
    base = unpack_base_codes(packed, validbits)
    codes, valid = window_codes(base, k, out_dtype=jnp.uint32)
    flat = codes.reshape(-1).astype(jnp.int32)
    w = valid.reshape(-1).astype(jnp.uint32)
    return jnp.zeros((space,), jnp.uint32).at[flat].add(w, mode="drop")


@functools.partial(jax.jit, static_argnames=("mesh", "k", "space"))
def count13_sharded(packed: jax.Array, validbits: jax.Array, *, mesh: Mesh,
                    k: int = K13, space: int = SPACE_13) -> jax.Array:
    """Count forward k<=16-mers of a packed [B, W]+[B, 2W] ingest batch
    (codec.pack_ascii_chunk) row-sharded over ``data``.

    Returns the fully-merged table, replicated on every device.
    """
    fn = shard_map(
        lambda p, v: jax.lax.psum(_local_count(p, v, k, space), DATA_AXIS),
        mesh=mesh,
        in_specs=(P(DATA_AXIS), P(DATA_AXIS)),
        out_specs=P(),
    )
    return fn(packed, validbits)


@functools.partial(jax.jit, static_argnames=("mesh", "k", "space"),
                   donate_argnums=(0,))
def count13_sharded_accumulate(counts: jax.Array, packed: jax.Array,
                               validbits: jax.Array, *, mesh: Mesh,
                               k: int = K13,
                               space: int = SPACE_13) -> jax.Array:
    """Streaming variant: add this batch's merged counts into ``counts``."""
    return counts + count13_sharded(packed, validbits, mesh=mesh, k=k,
                                    space=space)


def pack_reads_batch(reads: list[str], n_shards: int, length: int | None = None
                     ) -> np.ndarray:
    """Host-side packing of variable-length reads into a [B, L] uint8 batch.

    Reads are newline-padded (invalid windows) to a common length and the
    batch is padded to a multiple of ``n_shards`` rows so the ``data`` axis
    divides evenly — the static-shape analogue of the reference's per-thread
    byte ranges.
    """
    if length is None:
        length = max((len(r) for r in reads), default=1)
    pad_byte = ord("\n")
    rows = len(reads)
    b = -(-rows // n_shards) * n_shards if rows else n_shards
    out = np.full((b, length), pad_byte, dtype=np.uint8)
    for i, r in enumerate(reads):
        enc = np.frombuffer(r[:length].encode("ascii"), dtype=np.uint8)
        out[i, :len(enc)] = enc
    return out
