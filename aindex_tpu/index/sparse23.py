"""Sparse canonical 23-mer index: MPHF + checker + tf as device arrays.

Device re-architecture of PHASH_MAP (/root/reference/src/hash.hpp:82-353):

* counting is canonical (min of forward/revcomp code,
  /root/reference/src/count_kmers.cpp:132-136) and sort-based — windows are
  extracted on device, then reduced by np.unique instead of thread-local
  hash maps + merge (/root/reference/src/count_kmers.cpp:47-64,334-341);
* the MPHF (aindex_tpu.index.mphf) maps canonical code -> slot;
* ``checker`` stores the canonical code per slot and rejects MPHF false
  positives for alien keys, exactly as /root/reference/src/hash.hpp:123-140;
* all query families are batched device gathers.

Note on lexicographic vs numeric canonical order: ASCII 'A'<'C'<'G'<'T' is
monotone with the 2-bit encoding, so string-min (reference get_pfid,
/root/reference/src/hash.hpp:150-170) equals numeric code-min.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from aindex_tpu.constants import K23, SUFFIX_KMERS_BIN, SUFFIX_PF, SUFFIX_TF
from aindex_tpu.core import codec
from aindex_tpu.core.reads import blob_chunks
from aindex_tpu.index.mphf import MPHF
from aindex_tpu.kernels import coverage as cov_kernels
from aindex_tpu.kernels.encode import (ascii_to_base_codes, canonical_code64,
                                       window_codes)
from aindex_tpu.kernels.lookup import mphf_lookup


@functools.partial(jax.jit, static_argnames=("k",))
def _extract_canonical(ascii_chunk: jax.Array, k: int):
    base = ascii_to_base_codes(ascii_chunk)
    codes, valid = window_codes(base, k, out_dtype=jnp.uint64)
    return canonical_code64(codes, k), valid


@functools.partial(jax.jit, static_argnames=("k",))
def _extract_windows(ascii_chunk: jax.Array, k: int):
    base = ascii_to_base_codes(ascii_chunk)
    return window_codes(base, k, out_dtype=jnp.uint64)


@jax.jit
def _query_kernel(g_packed, slots, checker, tf, seed, domain, canon, valid):
    slot = mphf_lookup(g_packed, slots, canon, seed, domain)
    ok = (checker[slot] == canon) & valid
    zero = jnp.zeros((), tf.dtype)
    return jnp.where(ok, tf[slot], zero), jnp.where(ok, slot, jnp.full((), -1, slot.dtype))


def _is_reference_mphf(mphf) -> bool:
    from aindex_tpu.index.emphf import EmphfMPHFAdapter
    return isinstance(mphf, EmphfMPHFAdapter)


def count_canonical_kmers(blob: np.ndarray, k: int = K23, chunk: int = 1 << 22,
                          reduce: str = "auto", mesh=None, on_progress=None
                          ) -> tuple[np.ndarray, np.ndarray]:
    """(unique canonical codes, counts) over all valid windows of the blob.

    Deterministic, race-free replacement for the reference's thread-local
    hash maps + merge (/root/reference/src/count_kmers.cpp:47-64,334-341;
    SURVEY.md section 2.7). Reduction backends:

    * ``mesh`` given: data-parallel multi-device reduction, key-range
      sharded with one all_gather per batch
      (aindex_tpu.parallel.spectrum23);
    * ``reduce="device"``: per-chunk sort + segment-reduce entirely on
      device (aindex_tpu.kernels.spectrum) — only the already-unique
      partial spectra come back to the host;
    * ``reduce="host"``: entirely on the host (shift-or windows +
      np.unique), zero link traffic — the right engine when the D2H link
      is slow (the device engine must return ~12 bytes per unique window);
    * ``reduce="auto"`` (default): measured-link policy
      (core.hostdev.spectrum_reduce_mode, override with
      ``AINDEX_TPU_SPECTRUM_REDUCE``).
    """
    from aindex_tpu.kernels.spectrum import (chunk_spectrum_packed,
                                             host_chunk_spectrum,
                                             merge_spectra)
    if mesh is not None:
        from aindex_tpu.parallel.spectrum23 import count_canonical_kmers_sharded
        return count_canonical_kmers_sharded(blob, mesh, k, chunk,
                                             on_progress=on_progress)
    if reduce == "auto":
        from aindex_tpu.core.hostdev import spectrum_reduce_mode
        reduce = spectrum_reduce_mode()
    if reduce not in ("device", "host"):
        raise ValueError(f"reduce must be 'auto', 'device' or 'host', "
                         f"got {reduce!r}")
    parts: list[tuple[np.ndarray, np.ndarray]] = []

    if reduce == "host":
        for piece, off in blob_chunks(blob, k, chunk):
            keys, counts = host_chunk_spectrum(piece, k)
            if keys.size:
                parts.append((keys, counts))
            if on_progress is not None:
                on_progress(min(off + chunk, blob.size))
        return merge_spectra(parts)

    pending = None  # (device_chunk, bytes_done): H2D overlaps device compute

    def reduce_one(piece_dev):
        keys, counts, n_unique = chunk_spectrum_packed(*piece_dev, k)
        n = int(n_unique)
        if n:
            parts.append((np.asarray(keys[:n]), np.asarray(counts[:n])))

    def to_device(piece):
        # packed ingest: 0.375 bytes/base on the wire
        packed, vbits = codec.pack_ascii_chunk(piece)
        return (jax.device_put(packed), jax.device_put(vbits))

    for piece, off in blob_chunks(blob, k, chunk):
        nxt = (to_device(piece), min(off + chunk, blob.size))
        if pending is not None:
            reduce_one(pending[0])
            if on_progress is not None:
                on_progress(pending[1])
        pending = nxt
    if pending is not None:
        reduce_one(pending[0])
        if on_progress is not None:
            on_progress(pending[1])
    return merge_spectra(parts)


def count_canonical_kmers_stream(pieces, k: int = K23, chunk: int = 1 << 22,
                                 on_progress=None
                                 ) -> tuple[np.ndarray, np.ndarray]:
    """Streaming spectrum over newline-terminated sequence byte pieces.

    Constant host memory: only ~one chunk of input plus the per-chunk
    unique partial spectra are ever resident (the CLI `count` path for
    multi-GB inputs; contrast read_sequences' full string list)."""
    from aindex_tpu.core.reads import stream_blob_chunks
    from aindex_tpu.kernels.spectrum import chunk_spectrum_packed, merge_spectra
    parts: list[tuple[np.ndarray, np.ndarray]] = []
    for piece, off in stream_blob_chunks(pieces, k, chunk):
        packed, vbits = codec.pack_ascii_chunk(piece)
        keys, counts, n_unique = chunk_spectrum_packed(
            jnp.asarray(packed), jnp.asarray(vbits), k)
        n = int(n_unique)
        if n:
            parts.append((np.asarray(keys[:n]), np.asarray(counts[:n])))
        if on_progress is not None:
            on_progress(off + chunk)
    return merge_spectra(parts)


class SharedQueryOps:
    """Coverage + continuation-query surface shared by the single-device
    index and the mesh-sharded engine (parallel/query23.py). Requires
    ``self.k``, ``self._encode(kmers)``, ``self._ext_tf(ext_codes,
    cutoff)`` and ``self._resolve_tf_device(codes, valid)``."""
    # -- coverage (requires self._resolve_tf_device) -----------------------

    def sequence_coverage(self, seq: str, cutoff: int = 0) -> np.ndarray:
        ascii_u8 = np.frombuffer(seq.encode("ascii"), dtype=np.uint8)
        if ascii_u8.size < self.k:
            return np.zeros(0, dtype=np.uint32)
        return self._coverage_ascii(ascii_u8[None, :], cutoff)[0]

    def _coverage_ascii(self, mat: np.ndarray, cutoff: int) -> np.ndarray:
        """Coverage over [B, L] ASCII rows: windows -> verified query ->
        cutoff (batched analogue of get_sequence_coverage over
        get_tf_value, /root/reference/src/hash.hpp:123-140)."""
        codes, valid = _extract_windows(jnp.asarray(mat), self.k)
        shape = codes.shape
        tf = self._resolve_tf_device(codes.reshape(-1), valid.reshape(-1))
        tf = tf.reshape(shape)
        if cutoff:
            tf = jnp.where(tf >= jnp.uint32(cutoff), tf, jnp.zeros((), tf.dtype))
        return np.asarray(tf)

    def sequence_coverage_batch(self, seqs: list[str], cutoff: int = 0
                                ) -> list[np.ndarray]:
        """Coverage for many sequences in few device calls (length-bucketed)."""
        out = [None] * len(seqs)
        buckets = {}
        for i, s in enumerate(seqs):
            if len(s) < self.k:
                out[i] = np.zeros(0, dtype=np.uint32)
            else:
                buckets.setdefault(cov_kernels._length_bucket(len(s), self.k),
                                   []).append(i)
        for blen, members in buckets.items():
            rows = 8
            while rows < len(members):
                rows <<= 1
            mat = np.full((rows, blen), ord("\n"), dtype=np.uint8)
            for row, i in enumerate(members):
                enc = np.frombuffer(seqs[i].encode("ascii"), dtype=np.uint8)
                mat[row, :len(enc)] = enc
            cov = self._coverage_ascii(mat, cutoff)
            for row, i in enumerate(members):
                out[i] = cov[row, :len(seqs[i]) - self.k + 1]
        return out

    # -- De Bruijn continuation queries ------------------------------------

    def debruijn_next(self, kmers: list[str], cutoff: int = 0) -> np.ndarray:
        """tf of the 4 right extensions of each k-mer, shape (B, 4) in ACGT
        order (/root/reference/src/debrujin.cpp:30-75). cutoff zeroes counts
        <= cutoff, as in the reference (:44-49)."""
        codes, _ = self._encode(kmers)
        mask = np.uint64((1 << (2 * self.k)) - 1)
        ext = ((codes[:, None] << np.uint64(2)) | np.arange(4, dtype=np.uint64)) & mask
        return self._ext_tf(ext, cutoff)

    def debruijn_prev(self, kmers: list[str], cutoff: int = 0) -> np.ndarray:
        """tf of the 4 left extensions, shape (B, 4) in ACGT order
        (/root/reference/src/debrujin.cpp:120-170)."""
        codes, _ = self._encode(kmers)
        shift = np.uint64(2 * (self.k - 1))
        ext = (codes[:, None] >> np.uint64(2)) | (np.arange(4, dtype=np.uint64) << shift)
        return self._ext_tf(ext, cutoff)

    def _cont_info(self, ext_codes: np.ndarray, cutoff: int) -> dict:
        """Batched CONT record (/root/reference/src/debrujin.hpp:14-34):
        per k-mer the 4 extension tfs plus n (nonzero count), sum, and the
        best hit. The reference's if-chain takes the LAST base in ACGT
        order among the maxima (debrujin.cpp:56-75: every comparison is
        >=, later ifs overwrite), so ties resolve toward T — reproduced
        exactly, including the all-zero case (best_hit = 'T', tf 0)."""
        tf = self._ext_tf(ext_codes, cutoff).astype(np.uint32)
        best = 3 - np.argmax(tf[:, ::-1], axis=1)  # last argmax in ACGT
        rows = np.arange(tf.shape[0])
        return {
            "tf": tf,
            "n": (tf > 0).sum(axis=1).astype(np.uint32),
            "sum": tf.sum(axis=1, dtype=np.uint64).astype(np.uint32),
            "best_hit": np.array(list("ACGT"))[best],
            "best_hit_tf": tf[rows, best],
            "best_ukmer": ext_codes[rows, best].astype(np.uint64),
        }

    def debruijn_next_info(self, kmers: list[str], cutoff: int = 0) -> dict:
        """print_next's full CONT, batched
        (/root/reference/src/debrujin.cpp:30-76): dict of arrays ``tf``
        [B, 4] in ACGT order, ``n``, ``sum``, ``best_hit`` (char),
        ``best_hit_tf``, ``best_ukmer`` (the 2-bit code of the winning
        right extension)."""
        codes, _ = self._encode(kmers)
        mask = np.uint64((1 << (2 * self.k)) - 1)
        ext = ((codes[:, None] << np.uint64(2))
               | np.arange(4, dtype=np.uint64)) & mask
        return self._cont_info(ext, cutoff)

    def debruijn_prev_info(self, kmers: list[str], cutoff: int = 0) -> dict:
        """print_prev's full CONT, batched
        (/root/reference/src/debrujin.cpp:120-167; its shift is hardcoded
        to k=23 — generalised to this index's k)."""
        codes, _ = self._encode(kmers)
        shift = np.uint64(2 * (self.k - 1))
        ext = (codes[:, None] >> np.uint64(2)) | (
            np.arange(4, dtype=np.uint64) << shift)
        return self._cont_info(ext, cutoff)

class Sparse23Index(SharedQueryOps):
    """Sparse canonical k-mer index (default k=23) with device-side queries."""

    def __init__(self, mphf, checker: np.ndarray, tf: np.ndarray, k: int = K23):
        if _is_reference_mphf(mphf) and k > 30:
            # the cuckoo accelerator needs keys < 2^62 and the emphf MPHF has
            # no device walk — fail at construction, not first query
            raise ValueError(
                f"k={k} with a reference emphf MPHF is unsupported: no "
                f"device query path exists for k > 30")
        self.k = k
        self.mphf = mphf  # MPHF or emphf.EmphfMPHFAdapter (duck-typed)
        self.checker_host = np.asarray(checker, dtype=np.uint64)
        self.tf_host = np.asarray(tf, dtype=np.uint32)
        # Device replicas are LAZY: they serve only the MPHF-walk fallback
        # query path (_query_kernel) — the quot/cuckoo engines and all host
        # paths never touch them, so eager copies would be H2D for nothing.
        self._checker_dev: jax.Array | None = None
        self._tf_dev: jax.Array | None = None
        self._gp_dev: jax.Array | None = None
        self._slots_dev: jax.Array | None = None
        if hasattr(mphf, "g_packed"):  # native murmur-hash MPHF: device walk
            self.seed = jnp.uint64(mphf.seed)
            self.domain = jnp.uint64(mphf.domain)
        else:  # reference-format (emphf) MPHF: device queries use the cuckoo
            self.seed = None
            self.domain = None
        # Indexes built here store true-canonical keys, so one probe of the
        # canonical form suffices. Reference-built artifacts are keyed by
        # kmer_counter's buggy "canonical" (its reverse_complement_fast does a
        # full bit reversal, swapping the bits WITHIN each base — C and G map
        # to themselves, /root/reference/src/count_kmers.cpp:116-130), so
        # keys are not predictable from the query; we then use the reference
        # QUERY semantics instead: probe the forward key, else the (correct)
        # revcomp (get_freq, /root/reference/src/hash.hpp:123-140).
        self.canonical_keys = not _is_reference_mphf(mphf)
        self._cuckoo = None
        self._quot = None

    @property
    def n(self) -> int:
        return self.mphf.n

    @property
    def quot(self):
        """Preferred device/host query engine (index/quotcuckoo.py):
        verified (key -> tf) in two 8-byte row gathers, plus a separate
        slot column for position paths.
        Built lazily; None when the fingerprint-width floor makes the
        layout wasteful for this (n, k) (the wide ``cuckoo`` then serves)."""
        if self._quot is None and self.k <= 30:
            from aindex_tpu.index import quotcuckoo
            if quotcuckoo.eligible(self.n, self.k):
                self._quot = quotcuckoo.QuotCuckoo.build(
                    self.checker_host, self.tf_host,
                    np.arange(self.n, dtype=np.int32), self.k)
        return self._quot

    @property
    def cuckoo(self):
        """Wide-row fallback engine (see aindex_tpu.index.cuckoo): verified
        (key -> tf, slot) in two 16-byte row gathers. Built lazily;
        requires keys < 2^62 (k <= 30)."""
        if self._cuckoo is None and self.k <= 30:
            from aindex_tpu.index.cuckoo import CuckooTable
            self._cuckoo = CuckooTable.build(
                self.checker_host, self.tf_host,
                np.arange(self.n, dtype=np.int32))
        return self._cuckoo

    def _host_engine(self):
        """The built host-lookup engine (quot preferred, wide fallback);
        None for k > 30."""
        return self.quot or self.cuckoo

    def _query(self, canon: np.ndarray, valid):
        """(tf, slot) device query on canonical keys; slot -1 when absent.
        ``valid=None`` asserts every key is real (maskless fast path)."""
        qc = self.quot
        if qc is not None:
            from aindex_tpu.index.quotcuckoo import quot_query
            return quot_query(*qc.device, *qc.slot_device,
                              jnp.asarray(canon),
                              None if valid is None else jnp.asarray(valid),
                              *qc.mults, m=qc.m, lb=qc.lb, w=qc.w)
        from aindex_tpu.index.cuckoo import cuckoo_query
        ck = self.cuckoo
        if ck is not None:
            return cuckoo_query(ck.device, jnp.asarray(canon),
                                None if valid is None else jnp.asarray(valid),
                                ck.seed1, ck.seed2, m=ck.m)
        if self.g_packed is None:
            raise RuntimeError(
                f"no device query path for k={self.k}: the cuckoo accelerator "
                "needs k <= 30 and the emphf MPHF has no device walk")
        canon = jnp.asarray(canon)
        if valid is None:
            valid = jnp.ones(canon.shape, dtype=bool)
        return _query_kernel(self.g_packed, self.slots, self.checker, self.tf,
                             self.seed, self.domain,
                             canon, jnp.asarray(valid))

    def _resolve(self, codes, valid):
        """(tf, slot, strand) for LITERAL k-mer codes; strand 0/1/2 =
        absent/forward/revcomp.

        Canonical-keyed indexes (built here): one probe of min(code, rc).
        Reference-keyed indexes: probe forward, else revcomp — the
        reference's own query rule (get_freq,
        /root/reference/src/hash.hpp:123-140), which is the only sound rule
        over kmer_counter's unpredictable buggy-canonical keys.

        Host-origin batches (numpy codes) route to the host cuckoo engine
        when the H2D link is slower than the host gather
        (core.hostdev policy); device-resident inputs stay on device."""
        if isinstance(codes, np.ndarray) and self.k <= 30:
            from aindex_tpu.core.hostdev import prefer_host_ascii_queries
            if prefer_host_ascii_queries():
                return self._resolve_host(codes, np.asarray(valid))
        return self._resolve_device(codes, valid)

    def _resolve_device_maskless(self, codes):
        """_resolve_device with no validity mask (codes-in fast path)."""
        return self._resolve_device(codes, None)

    def _query_tf(self, canon, valid):
        """tf-only device query on canonical keys: two 8-byte row gathers
        on the quotient engine, no slot-column gather."""
        qc = self.quot
        if qc is not None:
            from aindex_tpu.index.quotcuckoo import quot_query_tf
            return quot_query_tf(*qc.device, jnp.asarray(canon),
                                 None if valid is None else jnp.asarray(valid),
                                 *qc.mults, m=qc.m, lb=qc.lb, w=qc.w)
        tf, _ = self._query(canon, valid)
        return tf

    def _resolve_tf_device(self, codes, valid):
        """tf per literal k-mer code, device path, no slot/strand: the
        engine for get_tf_values_codes and coverage (the north-star
        query), fused into one compiled kernel on the quotient engine.
        Falls back to the full _resolve_device for reference-keyed indexes
        (their fwd-else-rc rule needs per-probe hit flags) and for
        quot-ineligible (n, k)."""
        if getattr(self, "_device_released", False):
            raise RuntimeError(
                "device arrays were released by shard_to(); query through "
                "the sharded engine (AIndex facade) or the host paths")
        qc = self.quot if self.canonical_keys else None
        if qc is None:
            tf, _, _ = self._resolve_device(codes, valid)
            return tf.astype(jnp.uint32)
        from aindex_tpu.index.quotcuckoo import quot_tf_canonical
        codes_j = jnp.asarray(codes)
        valid_j = None if valid is None else jnp.asarray(valid)
        return quot_tf_canonical(*qc.device, codes_j, valid_j, *qc.mults,
                                 k=self.k, m=qc.m, lb=qc.lb, w=qc.w)

    def _coverage_ascii(self, mat: np.ndarray, cutoff: int) -> np.ndarray:
        """Quot-engine override of SharedQueryOps._coverage_ascii: the
        rows flatten with a newline column and cross the link in the
        packed ingest format (0.375 B/base instead of 1), then window
        extraction +
        canonicalise + probes run fused in ONE compiled kernel
        (quot_tf_windows_packed) instead of two dispatches plus a
        materialised uint64 window tensor."""
        qc = self.quot if (self.canonical_keys and
                           not getattr(self, "_device_released", False)) \
            else None
        if qc is None:
            return super()._coverage_ascii(mat, cutoff)
        from aindex_tpu.index.quotcuckoo import quot_tf_windows_packed
        rows, L = mat.shape
        flat = np.concatenate([
            np.hstack([mat, np.full((rows, 1), ord("\n"), np.uint8)]).ravel(),
            np.full(self.k, ord("\n"), np.uint8)])
        packed, vbits = codec.pack_ascii_chunk(flat)
        tf = quot_tf_windows_packed(
            *qc.device, jnp.asarray(packed), jnp.asarray(vbits), *qc.mults,
            k=self.k, m=qc.m, lb=qc.lb, w=qc.w, rows=rows, stride=L + 1)
        if cutoff:
            tf = jnp.where(tf >= jnp.uint32(cutoff), tf,
                           jnp.zeros((), tf.dtype))
        return np.asarray(tf)

    def _query_host_ascii(self, raw: bytes, n: int):
        """Fused native host engine: raw ASCII k-mer run -> (tf, slot,
        strand) in one C pass (native.sparse_query_ascii_quot / the wide
        twin); None when the native library is unavailable (caller falls
        back to encode + _resolve)."""
        from aindex_tpu import native
        if not native.available():
            return None
        qc = self.quot
        if qc is not None:
            return native.sparse_query_ascii_quot(
                raw, n, self.k, self.canonical_keys, qc.fp_tf_host,
                qc.slot_host, qc.m, qc.lb, qc.w, qc.mults)
        ck = self.cuckoo
        if ck is None:
            return None
        return native.sparse_query_ascii(raw, n, self.k, self.canonical_keys,
                                         ck.table_host, ck.m, ck.seed1,
                                         ck.seed2)

    def _resolve_host(self, codes: np.ndarray, valid: np.ndarray):
        """Host mirror of _resolve over the cuckoo table (no H2D): same
        (tf, slot, strand) contract, vectorised numpy throughout."""
        codes = np.asarray(codes, dtype=np.uint64)
        rc = codec.revcomp_code(codes, self.k)
        ck = self._host_engine()

        def probe(keys, v):
            found, tf, slot = ck.lookup_host(keys)
            found &= v
            return (np.where(found, tf, np.uint32(0)),
                    np.where(found, slot, np.int32(-1)).astype(np.int32))

        if self.canonical_keys:
            tf, slot = probe(np.minimum(codes, rc), valid)
            found = slot >= 0
            strand = np.where(found, np.where(codes <= rc, 1, 2), 0).astype(np.int32)
            return tf, slot, strand
        tf_f, slot_f = probe(codes, valid)
        tf_r, slot_r = probe(rc, valid)
        hit_f = slot_f >= 0
        tf = np.where(hit_f, tf_f, tf_r)
        slot = np.where(hit_f, slot_f, slot_r)
        strand = np.where(hit_f, 1, np.where(slot_r >= 0, 2, 0)).astype(np.int32)
        return tf, slot, strand

    # -- lazy device replicas (MPHF-walk fallback path only) ---------------

    def _lazy_dev(self, attr: str, make):
        if getattr(self, "_device_released", False):
            return None
        cached = getattr(self, attr)
        if cached is None:
            with jax.ensure_compile_time_eval():
                cached = make()
            setattr(self, attr, cached)
        return cached

    @property
    def checker(self):
        return self._lazy_dev("_checker_dev",
                              lambda: jnp.asarray(self.checker_host))

    @property
    def tf(self):
        return self._lazy_dev("_tf_dev", lambda: jnp.asarray(self.tf_host))

    @property
    def g_packed(self):
        if not hasattr(self.mphf, "g_packed"):
            return None
        return self._lazy_dev("_gp_dev",
                              lambda: jnp.asarray(self.mphf.g_packed))

    @property
    def slots(self):
        if not hasattr(self.mphf, "slots"):
            return None
        return self._lazy_dev("_slots_dev",
                              lambda: jnp.asarray(self.mphf.slots))

    def release_device(self) -> None:
        """Drop every device-resident array (MPHF walk tables, checker/tf
        replicas, quot/cuckoo query tables) and pin the device paths shut.

        Called by AIndex.shard_to once the mesh-sharded engine owns the
        queries: without this, every host would keep a full replica of the
        index in HBM and sharding would save nothing. Host arrays stay
        (save/iteration/stats and the host ASCII engines still work)."""
        self._checker_dev = None
        self._tf_dev = None
        self._gp_dev = None
        self._slots_dev = None
        if self._quot is not None:
            self._quot.release_device()
        if self._cuckoo is not None:
            self._cuckoo._device = None
        self._device_released = True

    def _resolve_device(self, codes, valid):
        if getattr(self, "_device_released", False):
            raise RuntimeError(
                "device arrays were released by shard_to(); query through "
                "the sharded engine (AIndex facade) or the host paths")
        from aindex_tpu.kernels.encode import revcomp_code64
        codes_j = jnp.asarray(codes).astype(jnp.uint64)
        valid_j = None if valid is None else jnp.asarray(valid)
        rc = revcomp_code64(codes_j, self.k)
        if self.canonical_keys:
            canon = jnp.minimum(codes_j, rc)
            tf, slot = self._query(canon, valid_j)
            found = slot >= 0
            strand = jnp.where(found,
                               jnp.where(codes_j <= rc, 1, 2), 0).astype(jnp.int32)
            return tf, slot, strand
        b = codes_j.shape[0]
        tf2, slot2 = self._query(jnp.concatenate([codes_j, rc]),
                                 None if valid_j is None else
                                 jnp.concatenate([valid_j, valid_j]))
        hit_f = slot2[:b] >= 0
        hit_r = slot2[b:] >= 0
        tf = jnp.where(hit_f, tf2[:b], tf2[b:])
        slot = jnp.where(hit_f, slot2[:b], slot2[b:])
        strand = jnp.where(hit_f, 1, jnp.where(hit_r, 2, 0)).astype(jnp.int32)
        return tf, slot, strand

    # -- construction --------------------------------------------------

    @classmethod
    def build_from_blob(cls, blob: np.ndarray, k: int = K23,
                        min_tf: int = 1, chunk: int = 1 << 22,
                        mesh=None) -> "Sparse23Index":
        keys, counts = count_canonical_kmers(blob, k, chunk, mesh=mesh)
        if min_tf > 1:
            keep = counts >= min_tf
            keys, counts = keys[keep], counts[keep]
        return cls.from_spectrum(keys, counts, k)

    @classmethod
    def build_from_sequences(cls, sequences: list[str], k: int = K23,
                             min_tf: int = 1) -> "Sparse23Index":
        text = "".join(s + "\n" for s in sequences)
        blob = np.frombuffer(text.encode("ascii"), dtype=np.uint8)
        return cls.build_from_blob(blob, k, min_tf)

    @classmethod
    def from_spectrum(cls, keys: np.ndarray, counts: np.ndarray, k: int = K23
                      ) -> "Sparse23Index":
        """Build MPHF + slot-ordered arrays from a (key, count) spectrum —
        the analogue of index_hash_pp (/root/reference/src/hash.cpp:779-881).
        The per-key slots come out of the peel itself (build_with_slots),
        so no lookup pass over the key set is needed. Spectrum keys come
        from a sorted-unique reduction, so distinctness is proven by one
        O(n) strictly-ascending scan instead of the MPHF's re-sort check
        (~15% of an end-to-end build); unsorted user input falls back to
        the full check."""
        ks = np.ascontiguousarray(keys, dtype=np.uint64)
        ascending = ks.size < 2 or bool(np.all(ks[1:] > ks[:-1]))
        mphf, slot = MPHF.build_with_slots(ks, assume_unique=ascending)
        n = mphf.n
        checker = np.zeros(n, dtype=np.uint64)
        tf = np.zeros(n, dtype=np.uint32)
        if n:
            checker[slot] = keys
            tf[slot] = np.minimum(counts, np.iinfo(np.uint32).max).astype(np.uint32)
        return cls(mphf, checker, tf, k)

    # -- persistence -----------------------------------------------------

    def save(self, prefix: str) -> None:
        """Write <prefix>.pf + .tf.bin (uint32/slot) + .kmers.bin (uint64/slot)
        — the artifact triple of compute_index
        (/root/reference/src/compute_index.cpp:59-67). The .pf is written in
        whichever format the index carries (our ATPF format for murmur-built
        indexes; the reference's emphf layout for reference-loaded ones)."""
        self.mphf.save(prefix + SUFFIX_PF)
        self.tf_host.tofile(prefix + SUFFIX_TF)
        self.checker_host.tofile(prefix + SUFFIX_KMERS_BIN)

    def export_reference(self, prefix: str) -> None:
        """Write a fully reference-compatible artifact set: an emphf-layout
        .pf (loadable by the reference C++, /root/reference/src/emphf/
        mphf.hpp:99-113) plus .tf.bin/.kmers.bin permuted into ITS slot
        order, so reference tooling can consume an index built here."""
        from aindex_tpu.index.emphf import EmphfMPHFAdapter
        if isinstance(self.mphf, EmphfMPHFAdapter):
            self.save(prefix)  # already in reference slot order + format
            return
        keys = self.checker_host
        adapter = EmphfMPHFAdapter.build(keys, self.k)
        new_slot = adapter.lookup(keys)  # our slot i -> reference slot
        tf = np.zeros_like(self.tf_host)
        checker = np.zeros_like(self.checker_host)
        tf[new_slot] = self.tf_host
        checker[new_slot] = keys
        adapter.save(prefix + SUFFIX_PF)
        tf.tofile(prefix + SUFFIX_TF)
        checker.tofile(prefix + SUFFIX_KMERS_BIN)

    @classmethod
    def load(cls, prefix: str, k: int = K23) -> "Sparse23Index":
        """Load an artifact triple by prefix (see load_files)."""
        return cls.load_files(prefix + SUFFIX_PF, prefix + SUFFIX_TF,
                              prefix + SUFFIX_KMERS_BIN, k)

    @classmethod
    def load_files(cls, pf_path: str, tf_path: str, kmers_path: str,
                   k: int = K23) -> "Sparse23Index":
        """Load from explicit artifact paths (the reference wrapper's
        ``load(hash, tf, kmers_bin, ...)`` form,
        /root/reference/src/python_wrapper.cpp:228-245). The .pf may be
        either our ATPF format or the reference's emphf layout
        (auto-detected) — reference-built index files load as-is, with the
        reference's own slot ids."""
        from aindex_tpu.index.emphf import EmphfMPHFAdapter, EmphfPF
        with open(pf_path, "rb") as f:
            magic = f.read(8)
        if magic == MPHF.MAGIC:
            mphf = MPHF.load(pf_path)
        elif EmphfPF.is_emphf_file(pf_path):
            mphf = EmphfMPHFAdapter.load(pf_path, k)
        else:
            raise ValueError(f"{pf_path}: neither ATPF nor emphf .pf format")
        tf = np.fromfile(tf_path, dtype=np.uint32)
        checker = np.fromfile(kmers_path, dtype=np.uint64)
        if tf.size != mphf.n or checker.size != mphf.n:
            raise ValueError(
                f"artifact size mismatch for {pf_path}: n={mphf.n}, "
                f"tf={tf.size}, kmers={checker.size}")
        return cls(mphf, checker, tf, k)

    # -- encoding helpers --------------------------------------------------

    #: batch size from which string->code encoding moves to the device;
    #: "auto" resolves from the measured link (core.hostdev
    #: .device_encode_min: engages on PCIe-class links, where shipping raw
    #: ASCII at 2.9x the bytes of uint64 codes is cheap). None = always
    #: host.
    DEVICE_ENCODE_MIN: int | str | None = "auto"

    def _device_encode_min(self) -> int | None:
        if self.DEVICE_ENCODE_MIN == "auto":
            from aindex_tpu.core.hostdev import device_encode_min
            return device_encode_min()
        return self.DEVICE_ENCODE_MIN

    def _encode(self, kmers: list[str]):
        dmin = self._device_encode_min()
        if dmin is not None and len(kmers) >= dmin:
            joined = "".join(kmers)
            mat = np.frombuffer(joined.encode("ascii"),
                                dtype=np.uint8).reshape(-1, self.k)
            codes, valid = _extract_windows(jnp.asarray(mat), self.k)
            return codes.reshape(-1), valid.reshape(-1)
        return codec.encode_kmers(kmers, self.k)

    # -- queries -----------------------------------------------------------

    def _resolve_ascii(self, kmers: list[str]):
        """(tf, slot, strand) for a host string batch via the best engine:
        the fused native C pass (encode + canonical + cuckoo probes, no
        intermediate arrays) when the link policy prefers the host, else
        encode + _resolve (which itself routes host/device)."""
        if self.k <= 30:
            from aindex_tpu.core.hostdev import prefer_host_ascii_queries
            if prefer_host_ascii_queries():
                raw = "".join(kmers).encode("ascii")
                if len(raw) == len(kmers) * self.k:  # guard ragged input
                    out = self._query_host_ascii(raw, len(kmers))
                    if out is not None:
                        return out
        codes, valid = self._encode(kmers)
        return self._resolve(codes, valid)

    def get_tf_values(self, kmers: list[str]) -> np.ndarray:
        """tf per k-mer (get_freq semantics,
        /root/reference/src/hash.hpp:123-140): verified probe of the
        canonical form (our indexes) or forward-then-revcomp (reference
        indexes — see _resolve)."""
        tf, _, _ = self._resolve_ascii(kmers)
        return np.asarray(tf)

    def get_tf_values_codes(self, codes, valid=None) -> jax.Array:
        """Verified tf per pre-encoded 2-bit k-mer code (device path).

        Device array in -> device uint32 array out: no string encode, no
        host round-trip, no link-policy routing — the full-rate sparse
        query entry point. On the quotient engine this is one fused kernel
        (revcomp + canonical + two 8-byte row gathers, no slot column).
        Encode once (``codec.encode_kmers`` or
        ``kernels.encode.window_codes``), keep the codes on device, and
        query at gather rate. ``valid=None`` asserts every code is a
        valid k-mer.
        """
        return self._resolve_tf_device(jnp.asarray(codes), valid)

    def get_tf_both_directions(self, kmers: list[str]) -> tuple[np.ndarray, np.ndarray]:
        """(fwd tf, rc tf). Both entries equal the verified canonical tf:
        the reference's per-direction probe itself applies fwd-else-rc
        (get_tf_value_23mer, /root/reference/src/python_wrapper.cpp:610-627),
        so get_tf_both_directions_23mer (:1258-1273) — which probes the
        literal k-mer and then its revcomp with that same rule — returns
        (tf, tf) for any present k-mer and (0, 0) otherwise.

        Exception: a reference-keyed index (canonical_keys=False) may store
        BOTH strands as distinct keys with different counts, in which case
        the reference returns (tf[kmer], tf[revcomp]); the second probe is
        therefore resolved independently there instead of reusing the
        first."""
        tf, _, _ = self._resolve_ascii(kmers)
        tf = np.asarray(tf)
        if self.canonical_keys:
            return tf, tf.copy()
        tf_rc, _, _ = self._resolve_ascii([codec.revcomp(km) for km in kmers])
        return tf, np.asarray(tf_rc)

    def get_pfids(self, kmers: list[str]) -> np.ndarray:
        """Slot id per k-mer; n (invalid marker) when absent
        (get_pfid, /root/reference/src/hash.hpp:150-170)."""
        _, slot, _ = self._resolve_ascii(kmers)
        slot = np.asarray(slot).astype(np.int64)
        return np.where(slot < 0, self.n, slot)

    def get_hash_values(self, kmers: list[str]) -> np.ndarray:
        """Raw (unverified) MPHF ids of the literal k-mer strings
        (/root/reference/src/python_wrapper.cpp:629-641)."""
        codes, _ = codec.encode_kmers(kmers, self.k)  # host walk needs np
        return np.asarray(self.mphf.lookup(codes)).astype(np.int64)

    def get_strands(self, kmers: list[str]) -> np.ndarray:
        """0 = not found, 1 = stored forward, 2 = stored as revcomp
        (/root/reference/src/python_wrapper.cpp:726-742)."""
        _, _, strand = self._resolve_ascii(kmers)
        return np.asarray(strand)

    def get_kmer_by_kid(self, kid: int) -> str:
        if kid >= self.n or kid < 0:
            return ""
        return codec.decode_kmer(int(self.checker_host[kid]), self.k)

    def get_kmer_info(self, kid: int) -> tuple[int, str, str]:
        """(tf, kmer, rkmer) — /root/reference/src/python_wrapper.cpp:744-755."""
        if kid >= self.n or kid < 0:
            return 0, "", ""
        code = int(self.checker_host[kid])
        kmer = codec.decode_kmer(code, self.k)
        rkmer = codec.decode_kmer(codec.revcomp_code(code, self.k), self.k)
        return int(self.tf_host[kid]), kmer, rkmer

    # -- De Bruijn continuation queries ------------------------------------

    def _ext_tf(self, ext_codes: np.ndarray, cutoff: int) -> np.ndarray:
        flat = ext_codes.reshape(-1)
        tf, _, _ = self._resolve(flat, np.ones(flat.shape, dtype=bool))
        tf = np.asarray(tf).reshape(ext_codes.shape)
        if cutoff > 0:
            tf = np.where(tf <= cutoff, 0, tf)
        return tf


    def set_stats(self, coverage: int) -> dict:
        """Coverage-profile statistics record: zero/unique/distinct/total/
        max_count plus the clamped tf histogram ``profile`` (set_stats,
        /root/reference/src/hash.hpp:297-323)."""
        from aindex_tpu.core.stats import coverage_stats
        return coverage_stats(self.tf_host, coverage)

    def save_values(self, path: str, skip_zeros: bool = True
                    ) -> tuple[int, int, int]:
        """Slot-ordered ``kmer\\ttf`` text dump; returns (zeros, ones,
        other) tallies (save_values, /root/reference/src/hash.hpp:261-289)."""
        from aindex_tpu.core.stats import save_values
        return save_values(path, self.checker_host, self.tf_host, self.k,
                           skip_zeros)

    def stats(self) -> dict:
        """zero/unique/distinct/total/max spectrum statistics
        (Stats, /root/reference/src/hash.hpp:38-80)."""
        tf = self.tf_host
        non_zero = int(np.count_nonzero(tf))
        return {
            "total_kmers": int(self.n),
            "non_zero_kmers": non_zero,
            "unique_kmers": int(np.count_nonzero(tf == 1)),
            "max_frequency": int(tf.max()) if tf.size else 0,
            "total_count": int(tf.sum(dtype=np.uint64)),
        }
