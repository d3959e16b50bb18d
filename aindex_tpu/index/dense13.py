"""Dense 13-mer index: the complete 4^13 k-mer space as one device table.

The reference builds an emphf MPHF over all 4^13 13-mers and counts into
MPHF-slot order (/root/reference/src/count_kmers13.cpp:27,141-160). Here
the k-mer's own 2-bit code *is* the slot (SURVEY.md section 7.1): the table
is a dense uint32[67,108,864] device array (256 MB of device memory), counting is a
masked scatter-add, and every query family is one or two gathers.

Counting is forward-strand only, matching count_kmers13 (no
canonicalisation; fwd+rc are combined at query time,
/root/reference/src/count_kmers13.cpp:141-160).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from aindex_tpu.constants import K13, SPACE_13
from aindex_tpu.core import codec
from aindex_tpu.core.reads import blob_chunks
from aindex_tpu.kernels import coverage as cov_kernels
from aindex_tpu.kernels.count import count_batch_13, count_batch_13_packed
from aindex_tpu.kernels.lookup import gather_tf_both_13, gather_tf_valid

_count_step = jax.jit(
    functools.partial(count_batch_13, k=K13, space=SPACE_13),
    donate_argnums=(0,),
)
_count_step_packed = jax.jit(
    functools.partial(count_batch_13_packed, k=K13, space=SPACE_13),
    donate_argnums=(0,),
)


def _count_blob_sharded(blob: np.ndarray, mesh, chunk: int,
                        on_progress=None) -> jax.Array:
    """Mesh-streamed dense count: [n_data, chunk] batches, psum-merged.

    The double-buffered device_put overlaps the host pack + H2D copy of
    batch i+1 with the device compute of batch i — the device analogue of
    the reference's producer-thread input queue
    (/root/reference/src/count_kmers13.cpp:166-183). Batches cross the
    link in the packed ingest format (codec.pack_ascii_chunk)."""
    from jax.sharding import NamedSharding, PartitionSpec as P
    from aindex_tpu.core.reads import blob_chunk_batches
    from aindex_tpu.parallel.count13 import count13_sharded_accumulate
    from aindex_tpu.parallel.mesh import DATA_AXIS
    from aindex_tpu.parallel import distributed as dist

    n_data = mesh.shape[DATA_AXIS]
    data_spec = NamedSharding(mesh, P(DATA_AXIS))
    rows = dist.local_data_rows(mesh) if dist.is_multiprocess() \
        else range(n_data)
    # device-side fill, replicated: no 268 MB of host zeros over the link
    counts = jax.jit(lambda: jnp.zeros((SPACE_13,), jnp.uint32),
                     out_shardings=NamedSharding(mesh, P()))()
    pending = None
    done = 0
    step = (chunk - 12) * n_data                 # bytes advanced per batch
    for batch in blob_chunk_batches(blob, K13, chunk, n_data,
                                    row_range=rows):
        packed, vbits = codec.pack_ascii_chunk(batch)
        nxt = (dist.put_row_sharded(packed, data_spec, n_data),  # async H2D
               dist.put_row_sharded(vbits, data_spec, n_data))
        if pending is not None:
            counts = count13_sharded_accumulate(counts, *pending, mesh=mesh)
        pending = nxt
        done = min(done + step, blob.size)
        if on_progress is not None:
            on_progress(done)
    if pending is not None:
        counts = count13_sharded_accumulate(counts, *pending, mesh=mesh)
    counts.block_until_ready()
    return counts


@jax.jit
def _build_total_table(tf: jax.Array) -> jax.Array:
    """tf + tf permuted by the revcomp involution (one-time table fusion)."""
    from aindex_tpu.kernels.encode import revcomp_code13
    codes = jnp.arange(SPACE_13, dtype=jnp.uint32)
    rc = revcomp_code13(codes, K13)
    return tf + tf[rc.astype(jnp.int32)]


@jax.jit
def _encode_batch_dev(mat: jax.Array):
    """[B, 13] ASCII -> (codes[B] uint32, valid[B]) on device — for large
    query batches on a fast link, shipping raw ASCII and encoding on the
    device replaces the host encode (the window kernel with exactly one
    window per row)."""
    from aindex_tpu.kernels.encode import ascii_to_base_codes, window_codes
    base = ascii_to_base_codes(mat)
    codes, valid = window_codes(base, K13, out_dtype=jnp.uint32)
    return codes.reshape(-1), valid.reshape(-1)


@jax.jit
def _gather_total(tf_total: jax.Array, codes: jax.Array, valid: jax.Array) -> jax.Array:
    tf = tf_total[codes.astype(jnp.int32)].astype(jnp.uint32)
    return jnp.where(valid, tf, jnp.zeros((), tf.dtype))


@jax.jit
def _gather_codes_u32(table: jax.Array, codes: jax.Array) -> jax.Array:
    """One device gather + free width cast — the full-rate codes-in query."""
    return table[codes.astype(jnp.int32)].astype(jnp.uint32)


@jax.jit
def _gather_codes_valid_u32(table: jax.Array, codes: jax.Array,
                            valid: jax.Array) -> jax.Array:
    tf = table[codes.astype(jnp.int32)].astype(jnp.uint32)
    return jnp.where(valid, tf, jnp.zeros((), tf.dtype))


def _narrow(table: jax.Array) -> jax.Array:
    """Shrink a count table to the minimal exact dtype.

    Query tables are stored at the smallest width that holds the actual
    max count — exact, never saturating — so a random gather moves fewer
    bytes and more of the table fits in cache."""
    max_v = int(jnp.max(table))
    if max_v < (1 << 8):
        return table.astype(jnp.uint8)
    if max_v < (1 << 16):
        return table.astype(jnp.uint16)
    return table


class Dense13Index:
    """Complete dense 13-mer frequency table resident on device."""

    k = K13
    space = SPACE_13

    def __init__(self, tf: jax.Array | np.ndarray,
                 tf_host: np.ndarray | None = None):
        if tf.shape != (SPACE_13,):
            raise ValueError(f"expected shape ({SPACE_13},), got {tf.shape}")
        # Accepts a device table (build paths) OR a host table (file loads)
        # — the device replica materialises lazily on first device query,
        # so loading an index for host-engine use never pays the 256 MB
        # H2D.
        self._tf = tf
        self._tf_host: np.ndarray | None = tf_host
        self._tf_total: jax.Array | None = None
        self._tf_query: jax.Array | None = None
        self._tf_total_host: np.ndarray | None = None

    @property
    def tf(self) -> jax.Array:
        if not isinstance(self._tf, jax.Array):
            with jax.ensure_compile_time_eval():
                self._tf = jnp.asarray(self._tf)
        return self._tf

    @tf.setter
    def tf(self, value) -> None:
        self._tf = value

    @property
    def tf_total(self) -> jax.Array:
        """Fused fwd+rc table: tf_total[c] = tf[c] + tf[revcomp(c)].

        Materialised once (one full-table permutation gather) so that every
        total-tf query afterwards is a single gather instead of two. Stored
        at the minimal exact width (see ``_narrow``).
        """
        if self._tf_total is None:
            self._tf_total = _narrow(_build_total_table(self.tf))
        return self._tf_total

    @property
    def tf_query(self) -> jax.Array:
        """Minimal-width copy of tf for forward-strand query gathers."""
        if self._tf_query is None:
            self._tf_query = _narrow(self.tf)
        return self._tf_query

    # -- construction --------------------------------------------------

    @classmethod
    def build_from_blob(cls, blob: np.ndarray, chunk: int = 1 << 22,
                        mesh=None, on_progress=None) -> "Dense13Index":
        """Count all forward-strand 13-mers of a concatenated sequence blob.

        The blob is streamed through the device in fixed-size overlapping
        chunks; separators/newlines/N's invalidate their windows on device.

        With ``mesh``, each batch of ``data``-axis-many chunks counts
        data-parallel and merges with one psum into the replicated table
        (the mesh-scale replacement for the reference's shared atomic table,
        /root/reference/src/count_kmers13.cpp:141-160). Host->device copies
        are double-buffered: batch i+1 transfers while batch i computes.
        """
        if mesh is not None:
            return cls(_count_blob_sharded(blob, mesh, chunk, on_progress))
        total = blob.size
        return cls._count_chunk_iter(
            ((p, min(o + chunk, total)) for p, o in blob_chunks(blob, K13, chunk)),
            on_progress)

    @classmethod
    def _count_chunk_iter(cls, chunk_iter, on_progress=None) -> "Dense13Index":
        """Double-buffered count over (chunk, bytes_done) pairs: the host
        pack + H2D copy of chunk i+1 overlaps the device compute of chunk
        i. Chunks cross the link packed (codec.pack_ascii_chunk, 0.375
        bytes/base) — builds are ingest-bound, not compute-bound."""
        from aindex_tpu.kernels.count import zeros_dev
        counts = zeros_dev((SPACE_13,), jnp.uint32)
        pending = None
        for piece, done in chunk_iter:
            packed, vbits = codec.pack_ascii_chunk(piece)
            nxt = (jax.device_put(packed), jax.device_put(vbits))  # async H2D
            if pending is not None:
                counts = _count_step_packed(counts, *pending)
            pending = nxt
            if on_progress is not None:
                on_progress(done)
        if pending is not None:
            counts = _count_step_packed(counts, *pending)
        counts.block_until_ready()
        return cls(counts)

    @classmethod
    def build_from_stream(cls, pieces, chunk: int = 1 << 22,
                          on_progress=None) -> "Dense13Index":
        """Count from a stream of newline-terminated sequence byte pieces
        (constant memory — the CLI ``count`` path for multi-GB inputs)."""
        from aindex_tpu.core.reads import stream_blob_chunks
        return cls._count_chunk_iter(
            ((p, o + chunk) for p, o in stream_blob_chunks(pieces, K13, chunk)),
            on_progress)

    @classmethod
    def build_from_sequences(cls, sequences: list[str], chunk: int = 1 << 22) -> "Dense13Index":
        text = "".join(s + "\n" for s in sequences)
        blob = np.frombuffer(text.encode("ascii"), dtype=np.uint8)
        return cls.build_from_blob(blob, chunk)

    # -- persistence (.tf.bin = uint64 x 4^13, code order;
    #    reference format is MPHF-slot order — parity is at kmer->tf level) --

    def save(self, tf_path: str) -> None:
        if self._tf_host is None:
            # cache the pull: the positional phase right after save()
            # needs the same host table for its CSR offsets
            self._tf_host = np.asarray(self.tf)
        np.asarray(self._tf_host, dtype=np.uint64).tofile(tf_path)

    @classmethod
    def load(cls, tf_path: str, pf_path: str | None = None) -> "Dense13Index":
        """Load a dense uint64 x 4^13 table.

        Our tables are in k-mer code order. Reference-built tables
        (count_kmers13, /root/reference/src/count_kmers13.cpp:358-388) are in
        MPHF-slot order; pass the matching emphf ``pf_path`` (the reference's
        13-mer ``.pf``) to reorder on load — 4^13 vectorised Jenkins lookups,
        a one-time cost."""
        raw = np.fromfile(tf_path, dtype=np.uint64, count=SPACE_13)
        if raw.size != SPACE_13:
            raise ValueError(f"{tf_path}: expected {SPACE_13} uint64 entries, got {raw.size}")
        if pf_path is not None:
            from aindex_tpu.index.emphf import EmphfPF, unpermute_dense_tf
            raw = unpermute_dense_tf(raw, EmphfPF.load(pf_path), K13)
        return cls._from_raw_u64(raw, tf_path)

    @classmethod
    def _from_raw_u64(cls, raw: np.ndarray, origin: str) -> "Dense13Index":
        u32max = np.iinfo(np.uint32).max
        over = raw > u32max
        if over.any():
            # counts beyond uint32 (a >600 Gbp corpus): the device table
            # saturates, the uint64 host table stays exact — host-engine
            # queries and save() keep full precision
            import logging
            logging.getLogger(__name__).warning(
                "%s: %d of %d counts exceed uint32 (max %d); device-path "
                "queries saturate at %d, host-path queries stay exact",
                origin, int(over.sum()), raw.size, int(raw.max()), u32max)
            clipped = np.minimum(raw, u32max).astype(np.uint32)
            return cls(clipped, tf_host=raw)
        clipped = raw.astype(np.uint32)
        # keep the host copy: it enables the zero-transfer host query engine
        # (core.hostdev) at no extra cost; the device replica materialises
        # lazily on first device query
        return cls(clipped, tf_host=clipped)

    # -- host-side helpers ----------------------------------------------

    #: batch size from which string->code encoding moves to the device
    #: (raw ASCII costs 3.25x the H2D bytes of uint32 codes). "auto"
    #: resolves from the measured link; None = always encode on host.
    DEVICE_ENCODE_MIN: int | str | None = "auto"

    def _device_encode_min(self) -> int | None:
        """Resolved device-encode threshold: class override, or the
        measured-link policy (core.hostdev.device_encode_min — engages on
        PCIe-class links)."""
        if self.DEVICE_ENCODE_MIN == "auto":
            from aindex_tpu.core.hostdev import device_encode_min
            return device_encode_min()
        return self.DEVICE_ENCODE_MIN

    def _encode(self, kmers: list[str]):
        dmin = self._device_encode_min()
        if dmin is not None and len(kmers) >= dmin:
            joined = "".join(kmers)
            mat = np.frombuffer(joined.encode("ascii"),
                                dtype=np.uint8).reshape(-1, K13)
            return _encode_batch_dev(jnp.asarray(mat))
        codes, valid = codec.encode_kmers(kmers, K13)
        return codes.astype(np.uint32), valid

    @property
    def tf_host(self) -> np.ndarray:
        if self._tf_host is None:
            self._tf_host = np.asarray(self.tf)
        return self._tf_host

    def invalidate_host_cache(self) -> None:
        self._tf_host = None
        self._tf_total_host = None

    def _host_tables(self) -> tuple[np.ndarray, np.ndarray] | None:
        """(tf, tf_total) host tables for the zero-transfer query engine.

        Only available when the host copy already exists (file-loaded or
        previously materialised): we never trigger an implicit 256 MB D2H
        pull — on the slow links where the host engine is chosen, that
        transfer is exactly what must not happen.
        """
        if self._tf_host is None:
            return None
        if self._tf_total_host is None:
            codes = np.arange(SPACE_13, dtype=np.uint32)
            rc = codec.revcomp_code(codes.astype(np.uint64), K13).astype(np.int64)
            self._tf_total_host = self._tf_host + self._tf_host[rc]
        return self._tf_host, self._tf_total_host

    def _query_host_ascii(self, kmers: list[str], kind: str):
        """Fused native host engine: raw ASCII batch -> tf in one C pass
        (encode + prefetched table gather, threaded;
        native.dense_query_ascii). None when the policy prefers the
        device, the host tables are absent/uint64 (saturated counts keep
        the exact numpy path), the batch is ragged, or native is missing
        — caller falls back to encode + _host_query/device."""
        from aindex_tpu import native
        from aindex_tpu.core.hostdev import prefer_host_ascii_queries
        tables = self._host_tables()
        if tables is None or not prefer_host_ascii_queries() \
                or not native.available():
            return None
        tf, tf_total = tables
        if tf.dtype != np.uint32 or tf_total.dtype != np.uint32:
            return None
        raw = "".join(kmers).encode("ascii")
        if len(raw) != len(kmers) * K13:
            return None  # ragged batch
        if kind == "total":
            return native.dense_query_ascii(raw, len(kmers), K13, tf_total)
        if kind == "fwd":
            return native.dense_query_ascii(raw, len(kmers), K13, tf)
        return native.dense_query_ascii(raw, len(kmers), K13, tf, both=True)

    def _host_query(self, kind: str, codes: np.ndarray, valid: np.ndarray):
        """Host gather mirror of the device query kernels; None if the host
        tables are absent or the policy prefers the device."""
        from aindex_tpu.core.hostdev import prefer_host_ascii_queries
        tables = self._host_tables()
        if tables is None or not prefer_host_ascii_queries():
            return None
        tf, tf_total = tables
        idx = codes.astype(np.int64)
        zero = np.uint32(0)
        if kind == "total":
            return np.where(valid, tf_total[idx], zero)
        if kind == "fwd":
            return np.where(valid, tf[idx], zero)
        rc = codec.revcomp_code(codes.astype(np.uint64), K13).astype(np.int64)
        return (np.where(valid, tf[idx], zero),
                np.where(valid, tf[rc], zero))

    # -- queries (batch-first; scalar wrappers in the API facade) --------

    def get_tf_values(self, kmers: list[str]) -> np.ndarray:
        """Forward-strand tf per k-mer (get_tf_value_13mer semantics,
        /root/reference/src/python_wrapper.cpp:482-503).

        The gather is XLA's own: one random-element gather per query."""
        fused = self._query_host_ascii(kmers, "fwd")
        if fused is not None:
            return fused
        codes, valid = self._encode(kmers)
        if isinstance(codes, np.ndarray):
            host = self._host_query("fwd", codes, valid)
            if host is not None:
                return host
        # canonical uint32 at the API boundary: the device gather returns
        # the narrowed table dtype (uint8/uint16), which must not leak —
        # output dtype would otherwise vary with the measured link policy
        return np.asarray(gather_tf_valid(self.tf_query, jnp.asarray(codes),
                                          jnp.asarray(valid))
                          ).astype(np.uint32, copy=False)

    def get_total_tf_values(self, kmers: list[str]) -> np.ndarray:
        """fwd + rc sum per k-mer (/root/reference/src/python_wrapper.cpp:522-543).

        One XLA gather against the fused tf_total table (see ``tf_total``)."""
        fused = self._query_host_ascii(kmers, "total")
        if fused is not None:
            return fused
        codes, valid = self._encode(kmers)
        if isinstance(codes, np.ndarray):
            host = self._host_query("total", codes, valid)
            if host is not None:
                return host
        return np.asarray(_gather_total(self.tf_total, jnp.asarray(codes),
                                        jnp.asarray(valid)))

    def get_tf_both_directions(self, kmers: list[str]) -> tuple[np.ndarray, np.ndarray]:
        fused = self._query_host_ascii(kmers, "both")
        if fused is not None:
            return fused
        codes, valid = self._encode(kmers)
        if isinstance(codes, np.ndarray):
            host = self._host_query("both", codes, valid)
            if host is not None:
                return host
        fwd, rc = gather_tf_both_13(self.tf_query, jnp.asarray(codes),
                                    jnp.asarray(valid))
        return (np.asarray(fwd).astype(np.uint32, copy=False),
                np.asarray(rc).astype(np.uint32, copy=False))

    # -- codes-in queries (device array in -> device array out) ----------

    def get_tf_values_codes(self, codes, valid=None) -> jax.Array:
        """Forward-strand tf per pre-encoded 2-bit 13-mer code.

        The full-rate query entry point: accepts a device-resident (or
        host) uint32 code array and returns a device uint32 array — no
        string encode, no host round-trip, one device gather. Encode host
        strings once with
        ``aindex_tpu.core.codec.encode_kmers`` (or on device via
        ``kernels.encode.window_codes``), keep the codes on device, and
        query at gather rate. ``valid=None`` asserts all codes are valid
        (skips the mask).
        """
        codes = jnp.asarray(codes)
        if valid is None:
            return _gather_codes_u32(self.tf_query, codes)
        return _gather_codes_valid_u32(self.tf_query, codes,
                                       jnp.asarray(valid))

    def get_total_tf_values_codes(self, codes, valid=None) -> jax.Array:
        """fwd + rc tf per pre-encoded code, against the fused total table
        (see ``tf_total``) — one gather. Device in -> device out; the
        codes-path twin of get_total_tf_values."""
        codes = jnp.asarray(codes)
        if valid is None:
            return _gather_codes_u32(self.tf_total, codes)
        return _gather_codes_valid_u32(self.tf_total, codes,
                                       jnp.asarray(valid))

    def get_tf_by_index(self, index: int) -> int:
        """tf by raw table index (get_tf_by_index_13mer,
        /root/reference/src/python_wrapper.cpp:992-998)."""
        return int(self.tf_host[index])

    def get_tf_array(self) -> np.ndarray:
        return self.tf_host

    def sequence_coverage(self, seq: str, cutoff: int = 0) -> np.ndarray:
        """Per-position forward tf vector over a sequence
        (aindex/core/aindex.py:314-322 with 13-mer dispatch)."""
        return cov_kernels.coverage_dense(self.tf_query, seq, K13, cutoff)

    def sequence_coverage_batch(self, seqs: list[str], cutoff: int = 0
                                ) -> list[np.ndarray]:
        """Coverage for many sequences in few device calls (length-bucketed)."""
        return cov_kernels.coverage_dense_batch(self.tf_query, seqs, K13, cutoff)

    def set_stats(self, coverage: int) -> dict:
        """Coverage-profile statistics over the dense table (set_stats,
        /root/reference/src/hash.hpp:297-323; code-indexed slots)."""
        from aindex_tpu.core.stats import coverage_stats
        return coverage_stats(self.tf_host, coverage)

    def save_values(self, path: str, skip_zeros: bool = True
                    ) -> tuple[int, int, int]:
        """Code-ordered ``kmer\\ttf`` text dump; returns (zeros, ones,
        other) (save_values, /root/reference/src/hash.hpp:261-289 — the
        dense mode's slot IS the 2-bit code)."""
        from aindex_tpu.core.stats import save_values
        codes = np.arange(SPACE_13, dtype=np.uint64)
        return save_values(path, codes, self.tf_host, K13, skip_zeros)

    def stats(self) -> dict:
        """total/non_zero/max/total_count (get_13mer_statistics,
        /root/reference/src/python_wrapper.cpp:1038-1068). Served from the
        host table when present (stats on a just-loaded index must not
        force the lazy 256 MB device replica)."""
        if self._tf_host is not None:
            tf = self._tf_host
            return {
                "total_kmers": SPACE_13,
                "non_zero_kmers": int(np.count_nonzero(tf)),
                "max_frequency": int(tf.max()) if tf.size else 0,
                "total_count": int(tf.sum(dtype=np.uint64)),
            }
        tf = self.tf
        return {
            "total_kmers": SPACE_13,
            "non_zero_kmers": int(jnp.sum(tf > 0)),
            "max_frequency": int(jnp.max(tf)),
            "total_count": int(jnp.sum(tf.astype(jnp.uint64))),
        }
