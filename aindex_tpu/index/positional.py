"""Positional "aindex": CSR mapping k-mer slot -> every blob position.

The reference fills this with per-slot atomic write cursors — racy ordering
(/root/reference/src/hash.cpp:1024-1051, src/compute_aindex13.cpp:206-215).
This build is sort-based and deterministic (SURVEY.md section 7.4),
streaming entirely on device:

  phase 1: CSR offsets = exclusive prefix-sum of the tf histogram (already
           produced by the counting phase);
  phase 2: per blob chunk, stable-sort occurrences by slot, rank each
           occurrence within its slot run, and scatter positions straight
           into their final CSR cells at offsets[slot] + cursor[slot] + rank;
           a persistent device cursor array carries per-slot fill counts
           across chunks.

No atomics, no host-side concatenation of the occurrence stream, and
positions within a slot come out sorted ascending — stricter than the
reference's nondeterministic order.

On-disk format matches the reference: ``.index.bin`` = uint64 positions
(1-based, 0 = empty), ``.indices.bin`` = uint64 CSR offsets[n_slots+1]
(/root/reference/src/hash.hpp:470-486, queries at
src/python_wrapper.cpp:800-822 return 0-based and skip zeros).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from aindex_tpu.constants import SUFFIX_INDEX, SUFFIX_INDICES
from aindex_tpu.core.reads import blob_chunks
from aindex_tpu.index.sparse23 import Sparse23Index
from aindex_tpu.kernels.encode import packed_window_codes


@jax.jit
def _csr_offsets(tf: jax.Array) -> jax.Array:
    """Exclusive prefix-sum of the slot histogram -> int64 offsets[n+1]
    (the reference's indices[i+1] = indices[i] + tf[i] loop,
    /root/reference/src/hash.hpp:374-378)."""
    c = jnp.cumsum(tf.astype(jnp.int64))
    return jnp.concatenate([jnp.zeros((1,), jnp.int64), c])


def _scatter_chunk(positions_out: jax.Array, cursor: jax.Array,
                   offsets: jax.Array, slots: jax.Array, pos: jax.Array,
                   valid: jax.Array) -> tuple[jax.Array, jax.Array]:
    """Place one chunk's (slot, position) occurrences into their final CSR
    cells. Deterministic replacement for the reference's per-slot atomic
    cursors (/root/reference/src/hash.cpp:1024-1051): a stable device sort
    by slot + in-run rank gives each occurrence its unique cell.

    positions_out uint64[total] (donated), cursor int32[n_slots] (donated),
    offsets int64[n_slots], slots int64[n], pos int64[n], valid bool[n].
    """
    n_slots = cursor.shape[0]
    sentinel = jnp.int64(n_slots)
    key = jnp.where(valid, slots, sentinel)
    order = jnp.argsort(key, stable=True)      # pos ascending within a slot
    s = key[order]
    p = pos[order]
    first = jnp.searchsorted(s, s, side="left")
    rank = jnp.arange(s.shape[0], dtype=jnp.int64) - first
    live = s < sentinel
    safe = jnp.where(live, s, 0)
    base = offsets[safe] + cursor[safe].astype(jnp.int64)
    out_idx = jnp.where(live, base + rank, positions_out.shape[0])
    positions_out = positions_out.at[out_idx].set(
        (p + 1).astype(positions_out.dtype), mode="drop")
    counts = jnp.zeros_like(cursor).at[safe].add(
        live.astype(cursor.dtype), mode="drop")
    return positions_out, cursor + counts


_scatter_chunk_donated = jax.jit(_scatter_chunk, donate_argnums=(0, 1))


class PositionalIndex:
    def __init__(self, offsets: np.ndarray, positions: np.ndarray):
        self.offsets = np.asarray(offsets, dtype=np.uint64)    # [n_slots + 1]
        self.positions = np.asarray(positions, dtype=np.uint64)  # 1-based

    @property
    def n_slots(self) -> int:
        return len(self.offsets) - 1

    @property
    def total(self) -> int:
        return len(self.positions)

    @property
    def max_tf(self) -> int:
        if self.n_slots == 0:
            return 0
        return int(np.max(np.diff(self.offsets.astype(np.int64))))

    # -- construction ------------------------------------------------------

    @classmethod
    def from_slot_positions(cls, slots: np.ndarray, positions0: np.ndarray,
                            n_slots: int) -> "PositionalIndex":
        """slots int64[n] (slot per occurrence), positions0 int64[n] 0-based."""
        order = np.argsort(slots, kind="stable")
        sorted_pos = positions0[order].astype(np.uint64) + np.uint64(1)
        counts = np.bincount(slots, minlength=n_slots).astype(np.uint64)
        offsets = np.zeros(n_slots + 1, dtype=np.uint64)
        np.cumsum(counts, out=offsets[1:])
        return cls(offsets, sorted_pos)

    @classmethod
    def _build_streaming(cls, n_slots: int, tf: np.ndarray | jax.Array,
                         chunk_iter) -> "PositionalIndex":
        """Device-streaming CSR fill over (slots, pos0, valid) chunk triples.

        ``tf`` is the per-slot occurrence histogram from the counting phase;
        the positions array is allocated once at its sum and every chunk
        scatters its occurrences directly into final cells (SURVEY.md §7.4
        "sort, not atomics")."""
        from aindex_tpu.kernels.count import zeros_dev
        offsets = _csr_offsets(jnp.asarray(tf))
        total = int(offsets[-1])
        if total == 0:
            return cls(np.asarray(offsets, dtype=np.uint64),
                       np.zeros(0, np.uint64))
        positions = zeros_dev((total,), jnp.uint64)
        cursor = zeros_dev((n_slots,), jnp.int32)
        off_dev = offsets[:-1]
        for slots, pos0, valid in chunk_iter:
            positions, cursor = _scatter_chunk_donated(
                positions, cursor, off_dev, slots, pos0, valid)
        return cls(np.asarray(offsets, dtype=np.uint64), np.asarray(positions))

    @classmethod
    def build_dense13(cls, blob: np.ndarray, k: int = 13,
                      chunk: int = 1 << 22,
                      tf: np.ndarray | jax.Array | None = None,
                      mesh=None, on_progress=None) -> "PositionalIndex":
        """13-mer positional index: slot = forward 2-bit code (the reference
        does a forward-only MPHF lookup per position,
        /root/reference/src/compute_aindex13.cpp:137-149).

        ``tf`` is the dense forward-count table when already built (the
        pipeline's phase 2 output); recomputed in a first streaming pass
        otherwise — mirroring the reference, whose CSR sizing also reads the
        counting phase's .tf.bin (/root/reference/src/compute_aindex13.cpp:59-64).

        With ``mesh``, the fill runs data-parallel with the positions
        array sharded by slot range (parallel.positional) — the mesh-scale
        replacement for the reference's threaded atomic-cursor fill; the
        result is byte-identical to the single-device build.
        """
        if tf is None:
            from aindex_tpu.index.dense13 import Dense13Index
            tf = Dense13Index.build_from_blob(blob, chunk=chunk).tf
        if mesh is not None:
            from aindex_tpu.parallel.positional import build_positional_sharded

            def resolve(codes, valid):
                return jnp.where(valid, codes.astype(jnp.int64),
                                 jnp.int64(-1))

            return build_positional_sharded(blob, 4 ** k, np.asarray(tf),
                                            resolve, mesh, k, chunk,
                                            on_progress)

        def chunks():
            from aindex_tpu.core.codec import pack_ascii_chunk
            for piece, off in blob_chunks(blob, k, chunk):
                codes, valid = packed_window_codes(
                    *map(jnp.asarray, pack_ascii_chunk(piece)), k,
                    out_dtype=jnp.uint32)
                pos0 = jnp.arange(codes.shape[0], dtype=jnp.int64) + off
                if on_progress is not None:
                    on_progress(min(off + chunk, blob.size))
                yield codes.astype(jnp.int64), pos0, valid

        return cls._build_streaming(4 ** k, tf, chunks())

    @classmethod
    def build_sparse23(cls, blob: np.ndarray, index: Sparse23Index,
                       chunk: int = 1 << 22,
                       mesh=None, on_progress=None) -> "PositionalIndex":
        """23-mer positional index: slot = verified canonical MPHF slot
        (/root/reference/src/hash.cpp:960-1060 lu_compressed_worker). The
        index's own tf array sizes the CSR; slot -1 (absent / invalid
        window) occurrences are dropped on device.

        With ``mesh``, the fill runs data-parallel + slot-range-sharded
        (see build_dense13); the verified slot probe runs inside each
        device's shard against the replicated query table."""
        k = index.k
        if mesh is not None:
            from aindex_tpu.parallel.positional import build_positional_sharded

            def resolve(codes, valid):
                _, slot, _ = index._resolve_device(codes, valid)
                return slot.astype(jnp.int64)

            return build_positional_sharded(blob, index.n, index.tf_host,
                                            resolve, mesh, k, chunk,
                                            on_progress)

        def chunks():
            from aindex_tpu.core.codec import pack_ascii_chunk
            for piece, off in blob_chunks(blob, k, chunk):
                codes, valid = packed_window_codes(
                    *map(jnp.asarray, pack_ascii_chunk(piece)), k,
                    out_dtype=jnp.uint64)
                _, slot, _ = index._resolve(codes, valid)
                slot = slot.astype(jnp.int64)
                pos0 = jnp.arange(slot.shape[0], dtype=jnp.int64) + off
                if on_progress is not None:
                    on_progress(min(off + chunk, blob.size))
                yield slot, pos0, slot >= 0

        return cls._build_streaming(index.n, index.tf, chunks())

    def reorder(self, old_slot_for_new: np.ndarray) -> "PositionalIndex":
        """CSR with rows permuted: new slot j holds old slot
        ``old_slot_for_new[j]``'s positions. Used to reorder a reference-built
        13-mer positional index (MPHF-slot keyed,
        /root/reference/src/compute_aindex13.cpp:206-215) into k-mer code
        order at load time."""
        old = np.asarray(old_slot_for_new, dtype=np.int64)
        off = self.offsets.astype(np.int64)
        lens = (off[1:] - off[:-1])[old]
        new_off = np.zeros(len(old) + 1, dtype=np.int64)
        np.cumsum(lens, out=new_off[1:])
        total = int(new_off[-1])
        # vectorised segment gather: absolute source index per output element
        src = (np.arange(total, dtype=np.int64)
               - np.repeat(new_off[:-1], lens)
               + np.repeat(off[:-1][old], lens))
        return PositionalIndex(new_off.astype(np.uint64), self.positions[src])

    # -- persistence ---------------------------------------------------

    def save(self, prefix: str) -> None:
        self.positions.tofile(prefix + SUFFIX_INDEX)
        self.offsets.tofile(prefix + SUFFIX_INDICES)

    @classmethod
    def load(cls, index_path: str, indices_path: str) -> "PositionalIndex":
        positions = np.fromfile(index_path, dtype=np.uint64)
        offsets = np.fromfile(indices_path, dtype=np.uint64)
        return cls(offsets, positions)

    # -- queries ---------------------------------------------------------

    def positions_by_slot(self, slot: int) -> np.ndarray:
        """0-based blob positions for a slot (zeros skipped, as in
        /root/reference/src/python_wrapper.cpp:800-822)."""
        if slot < 0 or slot >= self.n_slots:
            return np.zeros(0, dtype=np.uint64)
        s, e = int(self.offsets[slot]), int(self.offsets[slot + 1])
        chunk = self.positions[s:e]
        return chunk[chunk > 0] - np.uint64(1)

    def positions_by_slots(self, slots: np.ndarray
                           ) -> tuple[np.ndarray, np.ndarray]:
        """Batch form: one vectorised gather for many slots.

        Returns (positions, lengths): ``positions`` is the 0-based positions
        of slot[0], then slot[1], ... concatenated; ``lengths[i]`` is the
        count for slot[i] (split with ``np.split(positions,
        np.cumsum(lengths)[:-1])``). Out-of-range slots contribute length 0.
        The reference has no batch path — its per-call loop is the position
        analysis bottleneck (/root/reference/src/python_wrapper.cpp:800-822).
        """
        slots = np.asarray(slots, dtype=np.int64)
        ok = (slots >= 0) & (slots < self.n_slots)
        safe = np.where(ok, slots, 0)
        # index first, then cast: converting the full offsets array would
        # copy gigabytes per call for the dense 4^13 CSR
        starts = np.where(ok, self.offsets[safe].astype(np.int64), 0)
        ends = np.where(ok, self.offsets[safe + 1].astype(np.int64), 0)
        lens = ends - starts
        out_off = np.zeros(len(slots) + 1, dtype=np.int64)
        np.cumsum(lens, out=out_off[1:])
        src = (np.arange(int(out_off[-1]), dtype=np.int64)
               - np.repeat(out_off[:-1], lens)
               + np.repeat(starts, lens))
        pos = self.positions[src]
        keep = pos > 0
        csum = np.zeros(len(pos) + 1, dtype=np.int64)
        np.cumsum(keep, out=csum[1:])
        kept_lens = csum[out_off[1:]] - csum[out_off[:-1]]
        return pos[keep] - np.uint64(1), kept_lens
