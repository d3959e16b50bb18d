"""Multi-device parity tests on a virtual 8-device CPU mesh (SURVEY.md §4:
sharded counts/queries must match the single-device path bit-exactly)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from aindex_tpu.core.reads import ReadsStore
from aindex_tpu.index.dense13 import Dense13Index
from aindex_tpu.index.sparse23 import Sparse23Index
from aindex_tpu.core.codec import pack_ascii_chunk
from aindex_tpu.parallel.count13 import count13_sharded, pack_reads_batch


def _packed(batch):
    packed, vbits = pack_ascii_chunk(batch)
    return jnp.asarray(packed), jnp.asarray(vbits)
from aindex_tpu.parallel.mesh import make_mesh
from aindex_tpu.parallel.query23 import ShardedSparse23

import oracle


@pytest.fixture(scope="module")
def reads():
    rng = np.random.default_rng(99)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    reads = [bytes(bases[rng.integers(0, 4, size=40 + int(rng.integers(0, 30)))]).decode()
             for _ in range(37)]  # deliberately not divisible by 8
    reads.append("ACGT" * 12)
    reads.append("AATT" + "N" * 4 + "GGCCGGCCGGCCGGCCGGCCGGC")
    return reads


def test_sharded_count_matches_oracle_and_single_device(reads, eight_devices):
    mesh = make_mesh(n_data=8, devices=eight_devices)
    batch = pack_reads_batch(reads, n_shards=8)
    table = np.asarray(count13_sharded(*_packed(batch), mesh=mesh))

    golden = oracle.count_forward(reads, 13)
    store = ReadsStore.from_sequences(reads)
    single = Dense13Index.build_from_blob(store.blob)

    assert (table == single.tf_host).all()
    assert table.sum(dtype=np.uint64) == sum(golden.values())


def test_sharded_count_data_axis_sizes(reads, eight_devices):
    """Same result regardless of how many devices shard the batch."""
    tables = []
    for n in (1, 2, 4, 8):
        mesh = make_mesh(n_data=n, devices=eight_devices[:n])
        batch = pack_reads_batch(reads, n_shards=n)
        tables.append(np.asarray(count13_sharded(*_packed(batch), mesh=mesh)))
    for t in tables[1:]:
        assert (t == tables[0]).all()


@pytest.mark.parametrize("n_index", [2, 4, 8])
def test_sharded_23mer_query_matches_single_device(reads, eight_devices, n_index):
    store = ReadsStore.from_sequences(reads)
    index = Sparse23Index.build_from_blob(store.blob)
    mesh = make_mesh(n_data=1, n_index=n_index, devices=eight_devices[:n_index])
    sharded = ShardedSparse23(index, mesh)

    golden = oracle.count_canonical(reads, 23)
    kmers = sorted(golden)[:300] + ["A" * 23, "ACGTN" + "A" * 18]
    got = sharded.get_tf_values(kmers)
    want = index.get_tf_values(kmers)
    assert (got == want).all()
    assert [int(v) for v in got[:300]] == [golden[km] for km in kmers[:300]]

    # codes-in twin serves from the same sharded tables (both strands)
    from aindex_tpu.core import codec
    kms = sorted(golden)[:100] + [oracle.rc(km) for km in sorted(golden)[:50]]
    codes, _ = codec.encode_kmers(kms, 23)
    got_c = np.asarray(sharded.get_tf_values_codes(codes))
    assert got_c.dtype == np.uint32
    np.testing.assert_array_equal(got_c, np.asarray(index.get_tf_values(kms)))
    mask = np.zeros(len(kms), bool)
    mask[::2] = True
    got_m = np.asarray(sharded.get_tf_values_codes(codes, mask))
    np.testing.assert_array_equal(got_m, np.where(mask, got_c, 0))


def test_2d_mesh_count_and_query(reads, eight_devices):
    """data x index 2-D mesh: count over data axis while the sparse table
    lives sharded on the index axis."""
    mesh = make_mesh(n_data=2, n_index=4, devices=eight_devices)
    batch = pack_reads_batch(reads, n_shards=2)
    table = np.asarray(count13_sharded(*_packed(batch), mesh=mesh))
    store = ReadsStore.from_sequences(reads)
    single = Dense13Index.build_from_blob(store.blob)
    assert (table == single.tf_host).all()

    index = Sparse23Index.build_from_blob(store.blob)
    sharded = ShardedSparse23(index, mesh)
    golden = oracle.count_canonical(reads, 23)
    kmers = sorted(golden)[:100]
    assert [int(v) for v in sharded.get_tf_values(kmers)] == \
        [golden[km] for km in kmers]


class TestMeshPositional:
    """Slot-range-sharded positional build (parallel.positional) must be
    byte-identical to the single-device sort-based build."""

    def test_sparse23_positional_parity(self, reads, eight_devices):
        from aindex_tpu.index.positional import PositionalIndex
        store = ReadsStore.from_sequences(reads)
        index = Sparse23Index.build_from_blob(store.blob)
        single = PositionalIndex.build_sparse23(store.blob, index, chunk=512)
        for n in (1, 2, 4, 8):
            mesh = make_mesh(n_data=n, devices=eight_devices[:n])
            sharded = PositionalIndex.build_sparse23(store.blob, index,
                                                     chunk=512, mesh=mesh)
            np.testing.assert_array_equal(sharded.offsets, single.offsets)
            np.testing.assert_array_equal(sharded.positions, single.positions)

    def test_dense_positional_parity_small_k(self, reads, eight_devices):
        """k=5 keeps the dense slot space tiny (4^5); the code path is the
        k=13 one exactly (slot = forward code)."""
        from aindex_tpu.core import codec
        from aindex_tpu.index.positional import PositionalIndex
        store = ReadsStore.from_sequences(reads)
        golden = oracle.count_forward(reads, 5)
        tf = np.zeros(4 ** 5, dtype=np.uint32)
        codes, _ = codec.encode_kmers(sorted(golden), 5)
        tf[codes.astype(np.int64)] = [golden[km] for km in sorted(golden)]
        single = PositionalIndex.build_dense13(store.blob, k=5, chunk=512,
                                               tf=tf)
        for n in (2, 8):
            mesh = make_mesh(n_data=n, devices=eight_devices[:n])
            sharded = PositionalIndex.build_dense13(store.blob, k=5,
                                                    chunk=512, tf=tf,
                                                    mesh=mesh)
            np.testing.assert_array_equal(sharded.offsets, single.offsets)
            np.testing.assert_array_equal(sharded.positions,
                                          single.positions)

    def test_dense13_positional_parity(self, reads, eight_devices):
        """One full-size k=13 run at n=2 (4^13 slot space)."""
        from aindex_tpu.index.positional import PositionalIndex
        store = ReadsStore.from_sequences(reads)
        single = PositionalIndex.build_dense13(store.blob, chunk=1024)
        mesh = make_mesh(n_data=2, devices=eight_devices[:2])
        sharded = PositionalIndex.build_dense13(store.blob, chunk=1024,
                                                mesh=mesh)
        np.testing.assert_array_equal(sharded.offsets, single.offsets)
        np.testing.assert_array_equal(sharded.positions, single.positions)

    def test_positional_mesh_empty_blob(self, eight_devices):
        from aindex_tpu.index.positional import PositionalIndex
        mesh = make_mesh(n_data=2, devices=eight_devices[:2])
        tf = np.zeros(4 ** 5, dtype=np.uint32)
        out = PositionalIndex.build_dense13(np.zeros(0, np.uint8), k=5,
                                            tf=tf, mesh=mesh)
        assert out.total == 0 and out.n_slots == 4 ** 5


class TestPositionalExchange:
    """Round 5: the bucketed all_to_all pair exchange must be
    byte-identical to the full all_gather exchange, and skew that
    overflows a bucket must transparently fall back."""

    def test_alltoall_vs_allgather_identical(self, reads, eight_devices,
                                             monkeypatch):
        from aindex_tpu.index.positional import PositionalIndex
        from aindex_tpu.parallel import positional as PP
        store = ReadsStore.from_sequences(reads)
        index = Sparse23Index.build_from_blob(store.blob)
        for n in (2, 8):
            mesh = make_mesh(n_data=n, devices=eight_devices[:n])
            outs = {}
            for mode in ("allgather", "alltoall"):
                monkeypatch.setenv(PP.EXCHANGE_ENV, mode)
                outs[mode] = PositionalIndex.build_sparse23(
                    store.blob, index, chunk=512, mesh=mesh)
            np.testing.assert_array_equal(outs["alltoall"].positions,
                                          outs["allgather"].positions)
            np.testing.assert_array_equal(outs["alltoall"].offsets,
                                          outs["allgather"].offsets)

    def test_overflow_falls_back(self, eight_devices, monkeypatch, caplog):
        """A blob that is one hub k-mer repeated routes every pair to one
        destination shard — guaranteed bucket overflow at slack 2 — and
        must still produce the exact CSR via the auto-fallback."""
        import logging
        from aindex_tpu.index.positional import PositionalIndex
        from aindex_tpu.parallel import positional as PP
        # every window of a poly-A blob is the SAME k-mer: one destination
        # shard receives every pair of every device
        blob = np.frombuffer(b"A" * 2800 + b"\n", dtype=np.uint8)
        index = Sparse23Index.build_from_blob(blob)
        single = PositionalIndex.build_sparse23(blob, index, chunk=256)
        mesh = make_mesh(n_data=8, devices=eight_devices)
        monkeypatch.setenv(PP.EXCHANGE_ENV, "alltoall")
        with caplog.at_level(logging.INFO,
                             logger="aindex_tpu.parallel.positional"):
            sharded = PositionalIndex.build_sparse23(blob, index, chunk=256,
                                                     mesh=mesh)
        np.testing.assert_array_equal(sharded.positions, single.positions)
        # the skewed corpus must actually have exercised the fallback
        assert any("fell back to allgather" in r.message
                   for r in caplog.records)


class TestDistributedHelpers:
    def test_initialize_noop_single_process(self, monkeypatch):
        from aindex_tpu.parallel import distributed
        for var in ("JAX_COORDINATOR_ADDRESS", "JAX_NUM_PROCESSES",
                    "JAX_PROCESS_ID"):
            monkeypatch.delenv(var, raising=False)
        distributed.initialize()  # must not raise or hang

    def test_global_mesh(self, eight_devices):
        from aindex_tpu.parallel import distributed
        mesh = distributed.global_mesh(n_index=2)
        assert mesh.shape["data"] * mesh.shape["index"] == len(jax.devices())
        with pytest.raises(ValueError):
            distributed.global_mesh(n_index=3)

    def test_host_read_slice_covers_all(self):
        from aindex_tpu.parallel import distributed
        sl = distributed.host_read_slice(10)
        assert sl == slice(0, 10)  # single process owns everything


class TestMeshWiredProduct:
    """The multi-device paths reachable from PUBLIC entry points
    (VERDICT round 2 item 1): build_from_blob(mesh=), count_canonical_kmers
    (mesh=), AIndex.build_from_sequences(mesh=) + shard_to."""

    def test_dense13_build_from_blob_mesh_parity(self, reads, eight_devices):
        store = ReadsStore.from_sequences(reads)
        single = Dense13Index.build_from_blob(store.blob)
        for n in (2, 8):
            mesh = make_mesh(n_data=n, devices=eight_devices[:n])
            sharded = Dense13Index.build_from_blob(store.blob, chunk=256,
                                                   mesh=mesh)
            assert (sharded.tf_host == single.tf_host).all()

    def test_sharded_spectrum_parity(self, reads, eight_devices):
        from aindex_tpu.index.sparse23 import count_canonical_kmers
        store = ReadsStore.from_sequences(reads)
        k1, c1 = count_canonical_kmers(store.blob, 23)
        for n in (2, 8):
            mesh = make_mesh(n_data=n, devices=eight_devices[:n])
            k2, c2 = count_canonical_kmers(store.blob, 23, chunk=256,
                                           mesh=mesh)
            assert (k1 == k2).all()
            assert (c1.astype(np.uint64) == c2.astype(np.uint64)).all()

    def test_aindex_facade_mesh_build_and_query(self, reads, eight_devices):
        from aindex_tpu.api import AIndex
        mesh = make_mesh(n_data=4, n_index=2, devices=eight_devices)
        idx = AIndex.build_from_sequences(reads, kmer_size=23,
                                          build_aindex=False, mesh=mesh)
        assert idx._sharded23 is not None
        golden = oracle.count_canonical(reads, 23)
        kmers = sorted(golden)[:200]
        assert idx.get_tf_values(kmers) == [golden[km] for km in kmers]

    def test_pipeline_build_all_with_mesh(self, reads, eight_devices,
                                          tmp_path):
        from aindex_tpu.api import AIndex
        from aindex_tpu.pipeline.build import BuildConfig, build_all
        fa = tmp_path / "in.fa"
        fa.write_text("".join(f">r{i}\n{r}\n" for i, r in enumerate(reads)
                              if "~" not in r))
        mesh = make_mesh(n_data=8, devices=eight_devices)
        prefix = str(tmp_path / "m.23")
        cfg = BuildConfig(prefix=prefix, k=23, chunk=512, mesh=mesh)
        build_all([str(fa)], cfg)
        idx = AIndex.load_from_prefix(prefix)
        single = AIndex.build_from_sequences(
            [r for r in reads if "~" not in r], kmer_size=23)
        golden_kmers = sorted(oracle.count_canonical(
            [r for r in reads if "~" not in r], 23))[:100]
        assert idx.get_tf_values(golden_kmers) == \
            single.get_tf_values(golden_kmers)


class TestShardedFullSurface:
    """Round 5: the sharded engine serves the WHOLE query surface (De
    Bruijn, both-directions, coverage, pfid/hash/strand resolution) with
    single-device parity, and sharding actually frees per-device memory."""

    @pytest.fixture(scope="class")
    def pair(self, reads, eight_devices):
        store = ReadsStore.from_sequences(reads)
        index = Sparse23Index.build_from_blob(store.blob)
        mesh = make_mesh(n_data=1, n_index=8, devices=eight_devices)
        return index, ShardedSparse23(index, mesh)

    def test_debruijn_parity(self, pair, reads):
        index, sharded = pair
        golden = oracle.count_canonical(reads, 23)
        kmers = sorted(golden)[:64] + ["A" * 23]
        for cutoff in (0, 1):
            np.testing.assert_array_equal(
                sharded.debruijn_next(kmers, cutoff),
                index.debruijn_next(kmers, cutoff))
            np.testing.assert_array_equal(
                sharded.debruijn_prev(kmers, cutoff),
                index.debruijn_prev(kmers, cutoff))
        si = sharded.debruijn_next_info(kmers, 0)
        di = index.debruijn_next_info(kmers, 0)
        for key in ("tf", "n", "sum", "best_hit", "best_hit_tf",
                    "best_ukmer"):
            np.testing.assert_array_equal(si[key], di[key])

    def test_both_directions_and_resolution_parity(self, pair, reads):
        index, sharded = pair
        golden = oracle.count_canonical(reads, 23)
        kmers = sorted(golden)[:100] + [oracle.rc(km)
                                        for km in sorted(golden)[:40]]
        sf, sr = sharded.get_tf_both_directions(kmers)
        df, dr = index.get_tf_both_directions(kmers)
        np.testing.assert_array_equal(sf, df)
        np.testing.assert_array_equal(sr, dr)
        np.testing.assert_array_equal(sharded.get_pfids(kmers),
                                      index.get_pfids(kmers))
        np.testing.assert_array_equal(sharded.get_hash_values(kmers),
                                      index.get_hash_values(kmers))
        np.testing.assert_array_equal(sharded.get_strands(kmers),
                                      index.get_strands(kmers))

    def test_coverage_parity(self, pair, reads):
        index, sharded = pair
        for seq in (reads[0], reads[-1], "ACG"):
            np.testing.assert_array_equal(
                sharded.sequence_coverage(seq, 0),
                index.sequence_coverage(seq, 0))
        got = sharded.sequence_coverage_batch(reads[:5], 1)
        want = index.sequence_coverage_batch(reads[:5], 1)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)

    def test_per_device_bytes_fall_with_mesh(self, reads, eight_devices):
        store = ReadsStore.from_sequences(reads)
        index = Sparse23Index.build_from_blob(store.blob)
        sizes = {}
        for n_index in (1, 2, 4, 8):
            mesh = make_mesh(n_data=1, n_index=n_index,
                             devices=eight_devices[:n_index])
            sizes[n_index] = ShardedSparse23(index, mesh).per_device_bytes
        assert sizes[8] < sizes[4] < sizes[2] < sizes[1]
        # the sharded fraction dominates: 8-way is at least 4x smaller
        assert sizes[1] > 4 * sizes[8]

    def test_release_device_frees_and_guards(self, reads, eight_devices):
        from aindex_tpu.api import AIndex
        store = ReadsStore.from_sequences(reads)
        ai = AIndex()
        ai.sparse23 = Sparse23Index.build_from_blob(store.blob)
        ai._loaded = True
        golden = oracle.count_canonical(reads, 23)
        kmers = sorted(golden)[:50]
        want = [golden[km] for km in kmers]
        mesh = make_mesh(n_data=1, n_index=8, devices=eight_devices)
        ai.shard_to(mesh)
        sp = ai.sparse23
        assert sp.checker is None and sp.tf is None and sp.g_packed is None
        with pytest.raises(RuntimeError, match="released"):
            sp._resolve_device(np.zeros(4, np.uint64), None)
        # facade queries keep working, served by the sharded engine
        assert [int(v) for v in ai.get_tf_values(kmers)] == want
        assert ai.get_sequence_coverage(reads[0]) == \
            [int(v) for v in ai._sharded23.sequence_coverage(reads[0])]
        d = ai.debruijn_next(kmers[0])
        assert set(d) == set("ACGT")
