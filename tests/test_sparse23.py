"""Golden-value parity tests for the sparse canonical 23-mer index."""

import numpy as np
import pytest

from aindex_tpu.core.reads import ReadsStore
from aindex_tpu.index.mphf import MPHF
from aindex_tpu.index.sparse23 import Sparse23Index, count_canonical_kmers

import oracle


@pytest.fixture(scope="module")
def reads():
    rng = np.random.default_rng(777)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    reads = [bytes(bases[rng.integers(0, 4, size=70)]).decode() for _ in range(30)]
    reads += ["ACGT" * 20, "TTT" + "N" * 3 + "ACGTACGTACGTACGTACGTACG"]
    return reads


@pytest.fixture(scope="module")
def built(reads):
    store = ReadsStore.from_sequences(reads)
    index = Sparse23Index.build_from_blob(store.blob)
    return index, oracle.count_canonical(reads, 23)


class TestMPHF:
    def test_bijection(self, rng):
        keys = np.unique(rng.integers(0, 2**46, size=5000).astype(np.uint64))
        mphf = MPHF.build(keys)
        slots = mphf.lookup(keys)
        assert sorted(slots) == list(range(len(keys)))

    def test_save_load(self, rng, tmp_path):
        keys = np.unique(rng.integers(0, 2**46, size=1000).astype(np.uint64))
        mphf = MPHF.build(keys)
        path = str(tmp_path / "x.pf")
        mphf.save(path)
        again = MPHF.load(path)
        assert (again.lookup(keys) == mphf.lookup(keys)).all()

    def test_duplicate_keys_rejected(self):
        with pytest.raises(ValueError):
            MPHF.build(np.array([1, 1, 2], dtype=np.uint64))

    def test_empty(self):
        mphf = MPHF.build(np.zeros(0, dtype=np.uint64))
        assert mphf.n == 0


class TestSpectrum:
    def test_spectrum_matches_oracle(self, reads, built):
        _, golden = built
        store = ReadsStore.from_sequences(reads)
        keys, counts = count_canonical_kmers(store.blob)
        from aindex_tpu.core import codec
        got = dict(zip(codec.decode_kmers(keys, 23), counts.tolist()))
        assert got == golden

    def test_chunk_boundary_invariance(self, reads):
        store = ReadsStore.from_sequences(reads)
        k1, c1 = count_canonical_kmers(store.blob, chunk=128)
        k2, c2 = count_canonical_kmers(store.blob, chunk=1 << 22)
        assert (k1 == k2).all() and (c1 == c2).all()

    def test_device_reduce_matches_host_reduce(self, reads):
        store = ReadsStore.from_sequences(reads)
        for chunk in (128, 4096, 1 << 22):
            kd, cd = count_canonical_kmers(store.blob, chunk=chunk,
                                           reduce="device")
            kh, ch = count_canonical_kmers(store.blob, chunk=chunk,
                                           reduce="host")
            assert (kd == kh).all() and (cd == ch).all()

    def test_device_reduce_all_invalid(self):
        blob = np.frombuffer(b"N" * 64 + b"\n", dtype=np.uint8)
        keys, counts = count_canonical_kmers(blob, reduce="device")
        assert keys.size == 0 and counts.size == 0
        kh, ch = count_canonical_kmers(blob, reduce="host")
        assert kh.size == 0 and ch.size == 0

    def test_auto_reduce_env_override(self, reads, monkeypatch):
        from aindex_tpu.core import hostdev
        store = ReadsStore.from_sequences(reads)
        want = count_canonical_kmers(store.blob, reduce="device")
        for mode in ("host", "device"):
            monkeypatch.setenv(hostdev.SPECTRUM_REDUCE_ENV, mode)
            k, c = count_canonical_kmers(store.blob, reduce="auto")
            assert (k == want[0]).all() and (c == want[1]).all()
        with pytest.raises(ValueError):
            count_canonical_kmers(store.blob, reduce="banana")

    def test_host_window_codes_matches_device(self, reads):
        from aindex_tpu.kernels.spectrum import host_window_codes
        import jax.numpy as jnp
        from aindex_tpu.index.sparse23 import _extract_windows
        store = ReadsStore.from_sequences(reads)
        ch, vh = host_window_codes(store.blob, 23)
        cd, vd = _extract_windows(jnp.asarray(store.blob[None, :]), 23)
        np.testing.assert_array_equal(vh, np.asarray(vd)[0])
        np.testing.assert_array_equal(ch[vh], np.asarray(cd)[0][vh])

    @pytest.mark.parametrize("weighted", [False, True])
    @pytest.mark.parametrize("case", ["sentinels", "all_equal",
                                      "all_sentinel"])
    def test_sorted_spectrum_matches_unique(self, rng, weighted, case):
        """Both segment reducers against np.unique: duplicates, SENTINEL
        keys (ignored), one key repeated everywhere, nothing live."""
        import jax.numpy as jnp
        from aindex_tpu.kernels import spectrum as S
        n = 1 << 12
        keys = rng.integers(0, 1 << 46, size=n).astype(np.uint64)
        keys[rng.integers(0, n, size=n // 2)] = \
            keys[rng.integers(0, n, size=n // 2)]
        if case == "sentinels":
            keys[rng.integers(0, n, size=50)] = S.SENTINEL
        elif case == "all_equal":
            keys[:] = keys[0]
        else:
            keys[:] = S.SENTINEL
        w = rng.integers(1, 100, size=n).astype(np.uint64)
        live = keys != S.SENTINEL
        want_k, inv = np.unique(keys[live], return_inverse=True)
        want_c = np.zeros(want_k.size, np.uint64)
        np.add.at(want_c, inv, w[live] if weighted else np.uint64(1))
        if weighted:
            out = S.sorted_spectrum_weighted(jnp.asarray(keys),
                                             jnp.asarray(w))
        else:
            out = S.sorted_spectrum(jnp.asarray(keys))
        got_k, got_c, nu = (np.asarray(x) for x in out)
        assert int(nu) == want_k.size
        np.testing.assert_array_equal(got_k[:want_k.size], want_k)
        np.testing.assert_array_equal(got_c[:want_k.size], want_c)
        assert (got_k[want_k.size:] == S.SENTINEL).all()

    def test_sorted_spectrum_counts(self):
        from aindex_tpu.kernels.spectrum import SENTINEL, sorted_spectrum
        import jax.numpy as jnp
        keyed = jnp.asarray(np.array(
            [5, 2, 2, 0xFFFFFFFFFFFFFFFF, 5, 5, 9], dtype=np.uint64))
        keys, counts, n = sorted_spectrum(keyed)
        n = int(n)
        assert n == 3
        assert np.asarray(keys[:n]).tolist() == [2, 5, 9]
        assert np.asarray(counts[:n]).tolist() == [2, 3, 1]


class TestQueries:
    def test_every_kmer_tf_matches_oracle(self, built):
        index, golden = built
        kmers = sorted(golden)
        tfs = index.get_tf_values(kmers)
        assert [int(t) for t in tfs] == [golden[km] for km in kmers]

    def test_revcomp_query_equals_canonical(self, built):
        index, golden = built
        kmers = sorted(golden)[:100]
        rcs = [oracle.rc(km) for km in kmers]
        tfs = index.get_tf_values(rcs)
        assert [int(t) for t in tfs] == [golden[km] for km in kmers]

    def test_absent_and_invalid_zero(self, built):
        index, golden = built
        absent = "A" * 23
        assert absent not in golden and oracle.rc(absent) not in golden
        assert list(index.get_tf_values([absent, "ACGTN" + "A" * 18])) == [0, 0]

    def test_strand(self, built):
        index, golden = built
        km = sorted(golden)[0]
        assert index.get_strands([km])[0] in (1, 2)
        fwd_stored = km == min(km, oracle.rc(km))
        assert index.get_strands([km])[0] == (1 if fwd_stored else 2)
        assert index.get_strands([oracle.rc(km)])[0] == (2 if fwd_stored else 1)
        assert index.get_strands(["A" * 23])[0] == 0

    def test_pfid_checker_rejects_alien(self, built):
        index, golden = built
        assert int(index.get_pfids(["A" * 23])[0]) == index.n  # invalid marker

    def test_kid_roundtrip(self, built):
        index, _ = built
        for kid in [0, index.n // 2, index.n - 1]:
            km = index.get_kmer_by_kid(kid)
            assert int(index.get_pfids([km])[0]) == kid

    def test_kmer_info(self, built):
        index, golden = built
        tf, km, rkm = index.get_kmer_info(3)
        assert oracle.rc(km) == rkm
        assert tf == golden[min(km, rkm)]

    def test_coverage_matches_oracle(self, built, reads):
        index, golden = built
        for seq in [reads[0], "ACGTN" + reads[1]]:
            cov = index.sequence_coverage(seq)
            assert list(cov) == oracle.coverage_canonical(golden, seq, 23)

    def test_codes_api_matches_ascii_api(self, built):
        """Public codes-in entry point (device array in -> device uint32
        out) agrees with the ASCII path, both strands, plus the mask."""
        from aindex_tpu.core import codec
        index, golden = built
        kmers = sorted(golden)[:150]
        kmers += [oracle.rc(km) for km in kmers[:50]] + ["A" * 23]
        codes, valid = codec.encode_kmers(kmers, 23)
        assert valid.all()
        got = np.asarray(index.get_tf_values_codes(codes))
        assert got.dtype == np.uint32
        np.testing.assert_array_equal(got, np.asarray(index.get_tf_values(kmers)))
        mask = np.zeros(len(kmers), dtype=bool)
        mask[1::2] = True
        got_m = np.asarray(index.get_tf_values_codes(codes, mask))
        np.testing.assert_array_equal(got_m, np.where(mask, got, 0))

    def test_both_directions_is_tf_tf(self, built):
        """(tf, tf) semantics — each reference direction probe applies
        fwd-else-rc (/root/reference/src/python_wrapper.cpp:610-627,
        :1258-1273); pinned vs the golden artifacts in test_emphf.py."""
        index, golden = built
        kmers = sorted(golden)[:50] + ["A" * 23]
        want = np.array([golden.get(min(km, oracle.rc(km)), 0)
                         for km in kmers], dtype=np.uint32)
        fwd, rev = index.get_tf_both_directions(kmers)
        np.testing.assert_array_equal(np.asarray(fwd, np.uint32), want)
        np.testing.assert_array_equal(np.asarray(rev, np.uint32), want)

    def test_stats(self, built):
        index, golden = built
        s = index.stats()
        assert s["total_kmers"] == len(golden)
        assert s["total_count"] == sum(golden.values())
        assert s["max_frequency"] == max(golden.values())


class TestDeBruijn:
    def test_next_prev_match_oracle(self, built):
        index, golden = built
        km = max(golden, key=golden.get)
        nxt = index.debruijn_next([km])[0]
        prv = index.debruijn_prev([km])[0]
        for i, b in enumerate("ACGT"):
            ext = km[1:] + b
            assert nxt[i] == golden.get(min(ext, oracle.rc(ext)), 0)
            ext_l = b + km[:-1]
            assert prv[i] == golden.get(min(ext_l, oracle.rc(ext_l)), 0)

    def test_cutoff_zeroes(self, built):
        index, golden = built
        km = max(golden, key=golden.get)
        big = int(index.debruijn_next([km]).max())
        row = index.debruijn_next([km], cutoff=big)[0]
        assert (np.asarray(row) == 0).all()

    @staticmethod
    def _cont_oracle(tfs, exts, cutoff):
        """Literal transcription of the reference CONT semantics
        (/root/reference/src/debrujin.cpp:44-75): zero tf <= cutoff, then
        the if-chain of >= comparisons — the LAST base among the maxima
        wins (ties resolve toward T; all-zero gives best_hit 'T')."""
        tfs = [0 if cutoff > 0 and t <= cutoff else t for t in tfs]
        best = None
        for i, b in enumerate("ACGT"):
            if all(tfs[i] >= tfs[j] for j in range(4)):
                best = (b, exts[i], tfs[i])
        return {"tf": tfs, "n": sum(t > 0 for t in tfs), "sum": sum(tfs),
                "best_hit": best[0], "best_ukmer": best[1],
                "best_hit_tf": best[2]}

    @pytest.mark.parametrize("direction", ["next", "prev"])
    @pytest.mark.parametrize("cutoff", [0, 1])
    def test_cont_info_matches_reference_semantics(self, built, direction,
                                                   cutoff):
        from aindex_tpu.core import codec
        index, golden = built
        kmers = sorted(golden)[:60] + ["A" * 23]
        info = getattr(index, f"debruijn_{direction}_info")(kmers, cutoff)
        for i, km in enumerate(kmers):
            code = codec.encode_kmers([km], 23)[0][0]
            if direction == "next":
                exts = [((int(code) << 2) | b) & ((1 << 46) - 1)
                        for b in range(4)]
            else:
                exts = [(int(code) >> 2) | (b << 44) for b in range(4)]
            tfs = [golden.get(min(codec.decode_kmer(np.uint64(e), 23),
                                  oracle.rc(codec.decode_kmer(np.uint64(e),
                                                              23))), 0)
                   for e in exts]
            want = self._cont_oracle(tfs, exts, cutoff)
            assert list(info["tf"][i]) == want["tf"], km
            assert info["n"][i] == want["n"] and info["sum"][i] == want["sum"]
            assert info["best_hit"][i] == want["best_hit"], km
            assert info["best_hit_tf"][i] == want["best_hit_tf"]
            assert info["best_ukmer"][i] == want["best_ukmer"]


class TestPersistence:
    def test_save_load_roundtrip(self, built, tmp_path, reads):
        index, golden = built
        prefix = str(tmp_path / "t.23")
        index.save(prefix)
        again = Sparse23Index.load(prefix)
        kmers = sorted(golden)[:50]
        assert list(again.get_tf_values(kmers)) == list(index.get_tf_values(kmers))
        assert (again.checker_host == index.checker_host).all()


class TestCuckoo:
    def test_cuckoo_lookup_matches(self, built, rng):
        """Cuckoo accelerator host lookup: exact (found, tf, slot) for all
        present keys; absent keys not found."""
        index, golden = built
        ck = index.cuckoo
        assert ck is not None
        found, tf, slot = ck.lookup_host(index.checker_host)
        assert found.all()
        assert (tf == index.tf_host).all()
        assert (slot == np.arange(index.n)).all()
        absent = np.setdiff1d(
            rng.integers(0, 1 << 46, size=1000).astype(np.uint64),
            index.checker_host)
        f2, t2, _ = ck.lookup_host(absent)
        assert not f2.any() and not t2.any()

    def test_device_query_with_default_seeds(self, built):
        """Regression: the default _SEED2 exceeds int64 range; the jitted
        cuckoo_query must receive seeds as uint64, not Python ints (which
        overflow JAX's argument parsing). Build with attempt-0 seeds
        explicitly so the test does not depend on the fixture's retry path."""
        import jax.numpy as jnp

        from aindex_tpu.index import cuckoo as ck_mod

        index, _ = built
        table = None
        m = 1
        while m < max(1, int(np.ceil(index.n * 1.05 / 2))):
            m <<= 1
        while table is None:
            table = ck_mod.CuckooTable._try_build(
                index.checker_host, index.tf_host,
                np.arange(index.n, dtype=np.int32), m,
                ck_mod._SEED1, ck_mod._SEED2)
            m <<= 1
        ck = ck_mod.CuckooTable(table, m >> 1, ck_mod._SEED1, ck_mod._SEED2)
        assert isinstance(ck.seed2, np.uint64)
        tf, slot = ck_mod.cuckoo_query(
            ck.device, jnp.asarray(index.checker_host),
            jnp.ones(index.n, bool), ck.seed1, ck.seed2, m=ck.m)
        assert (np.asarray(tf) == index.tf_host).all()
        assert (np.asarray(slot) == np.arange(index.n)).all()

    def test_python_fallback_build_matches_native(self, built):
        from aindex_tpu.index.cuckoo import CuckooTable
        from aindex_tpu import native as native_mod
        index, _ = built
        if not native_mod.available():
            pytest.skip("native unavailable")
        keys = index.checker_host[:500]
        tf = index.tf_host[:500]
        slot = np.arange(500, dtype=np.int32)
        nat = CuckooTable.build(keys, tf, slot)
        import unittest.mock as mock
        with mock.patch.object(native_mod, "available", return_value=False):
            py = CuckooTable.build(keys, tf, slot)
        for t in (nat, py):
            found, tfv, sl = t.lookup_host(keys)
            assert found.all() and (tfv == tf).all() and (sl == slot).all()


class TestQuotCuckoo:
    """Round-5 quotiented 8-byte-row engine (index/quotcuckoo.py)."""

    def test_engine_selected_and_exact(self, built, rng):
        """For k=23 the quotient engine is always eligible; every stored
        key resolves exactly, absent keys never match (the fingerprint is
        a full quotient — exactness is structural, not probabilistic)."""
        index, golden = built
        qc = index.quot
        assert qc is not None
        found, tf, slot = qc.lookup_host(index.checker_host)
        assert found.all()
        assert (tf == index.tf_host).all()
        assert (np.sort(slot) == np.arange(index.n)).all()
        assert (slot == np.arange(index.n)).all()
        absent = np.setdiff1d(
            rng.integers(0, 1 << 46, size=2000).astype(np.uint64),
            index.checker_host)
        f2, t2, s2 = qc.lookup_host(absent)
        assert not f2.any() and not t2.any() and (s2 == -1).all()

    def test_memory_vs_wide(self, built, rng):
        """Two quotiented slots per 16-byte bucket at load <= 0.8 must
        cost materially less per key than the wide layout's one 16-byte
        row per slot at load < 0.5 — table bytes are what a random gather
        moves. Compared at a realistic n;
        below ~64K keys the fp-width floor (lb >= 2k-31) dominates and
        the comparison is meaningless."""
        from aindex_tpu.core import codec
        from aindex_tpu.index.cuckoo import CuckooTable
        from aindex_tpu.index.quotcuckoo import QuotCuckoo
        index, _ = built
        assert index.quot.fp_tf_host.shape == (2 * index.quot.m, 2)
        assert index.quot.slot_host.shape == (2 * index.quot.m,)
        h0, h1 = index.quot.device
        assert h0.shape == h1.shape == (index.quot.m, 2)
        keys = np.unique(codec.canonical_code(
            rng.integers(0, 1 << 46, size=300_000).astype(np.uint64), 23))
        tf = np.ones(keys.size, np.uint32)
        slot = np.arange(keys.size, dtype=np.int32)
        qc = QuotCuckoo.build(keys, tf, slot, 23)
        wide = CuckooTable.build(keys, tf, slot)
        assert qc.fp_tf_host.nbytes <= wide.table_host.nbytes // 2
        found, tfv, sl = qc.lookup_host(keys)
        assert found.all() and (sl == slot).all()

    def test_device_kernels_match_host(self, built, rng):
        import jax.numpy as jnp
        from aindex_tpu.index.quotcuckoo import quot_query, quot_query_tf
        index, _ = built
        qc = index.quot
        mixed = np.concatenate([
            index.checker_host,
            rng.integers(0, 1 << 46, size=512).astype(np.uint64)])
        found, tf, slot = qc.lookup_host(mixed)
        dtf, dslot = quot_query(*qc.device, *qc.slot_device,
                                jnp.asarray(mixed), None, *qc.mults,
                                m=qc.m, lb=qc.lb, w=qc.w)
        assert (np.asarray(dtf) == tf).all()
        assert (np.asarray(dslot) == slot).all()
        dtf2 = quot_query_tf(*qc.device, jnp.asarray(mixed), None,
                             *qc.mults, m=qc.m, lb=qc.lb, w=qc.w)
        assert (np.asarray(dtf2) == tf).all()

    def test_fused_canonical_kernel(self, built, rng):
        """quot_tf_canonical (the one-dispatch codes-in path) must equal
        the canonicalise-then-probe composition for literal codes of both
        strands."""
        import jax.numpy as jnp
        from aindex_tpu.core import codec
        from aindex_tpu.index.quotcuckoo import quot_tf_canonical
        index, golden = built
        qc = index.quot
        lit = np.array([codec.encode_kmer(km) for km in golden][:200],
                       dtype=np.uint64)
        rc = codec.revcomp_code(lit, 23)
        for codes in (lit, rc):
            out = quot_tf_canonical(*qc.device, jnp.asarray(codes), None,
                                    *qc.mults, k=23, m=qc.m, lb=qc.lb, w=qc.w)
            canon = codec.canonical_code(codes, 23)
            _, tf_h, _ = qc.lookup_host(canon)
            assert (np.asarray(out) == tf_h).all()

    def test_python_fallback_build_matches_native(self, built):
        from aindex_tpu.index.quotcuckoo import QuotCuckoo
        from aindex_tpu import native as native_mod
        index, _ = built
        if not native_mod.available():
            pytest.skip("native unavailable")
        keys = index.checker_host[:400]
        tf = index.tf_host[:400]
        slot = np.arange(400, dtype=np.int32)
        nat = QuotCuckoo.build(keys, tf, slot, 23)
        import unittest.mock as mock
        with mock.patch.object(native_mod, "available", return_value=False):
            py = QuotCuckoo.build(keys, tf, slot, 23)
        assert (nat.fp_tf_host == py.fp_tf_host).all()
        assert (nat.slot_host == py.slot_host).all()
        for t in (nat, py):
            found, tfv, sl = t.lookup_host(keys)
            assert found.all() and (tfv == tf.astype(np.uint32)).all() \
                and (sl == slot).all()

    def test_native_ascii_quot_parity(self, built):
        """The fused C pass (encode + canonical + quotient probes) must
        match the numpy host mirror on present + absent + invalid kmers."""
        from aindex_tpu import native as native_mod
        from aindex_tpu.core import codec
        index, golden = built
        if not native_mod.available():
            pytest.skip("native unavailable")
        qc = index.quot
        kms = list(golden)[:300]
        kms += [codec.revcomp(km) for km in kms[:50]]
        kms += ["A" * 23, "ACGTN" + "A" * 18, "G" * 23]
        raw = "".join(kms).encode()
        out = native_mod.sparse_query_ascii_quot(
            raw, len(kms), 23, True, qc.fp_tf_host, qc.slot_host,
            qc.m, qc.lb, qc.w, qc.mults)
        assert out is not None
        tf_c, slot_c, strand_c = out
        codes, valid = codec.encode_kmers(kms, 23)
        tf_h, slot_h, strand_h = index._resolve_host(codes, valid)
        assert (tf_c == tf_h).all()
        assert (slot_c == slot_h).all()
        assert (strand_c == strand_h).all()


class TestReferenceKeyedBothDirections:
    def test_distinct_strand_counts_resolve_independently(self, rng):
        """canonical_keys=False indexes may store BOTH strands with
        different counts; get_tf_both_directions must then return
        (tf[kmer], tf[revcomp]), not (tf, tf) (ADVICE r4)."""
        from aindex_tpu.core import codec
        fwd = "ACGTACGTACGTACGTACGTACG"
        rc = codec.revcomp(fwd)
        other = "CCCCCCCCCCCCCCCCCCCCCCA"
        keys = np.array([codec.encode_kmer(fwd), codec.encode_kmer(rc),
                         codec.encode_kmer(other)], dtype=np.uint64)
        order = np.argsort(keys)
        keys = keys[order]
        tf = np.array([7, 3, 5], dtype=np.uint64)[order]
        index = Sparse23Index.from_spectrum(keys, tf, 23)
        index.canonical_keys = False  # simulate a reference-keyed load
        f, r = index.get_tf_both_directions([fwd, rc, other])
        assert list(f) == [7, 3, 5]
        # the second probe also applies the reference's fwd-else-rc rule,
        # so `other`'s unstored revcomp falls back to `other` itself
        assert list(r) == [3, 7, 5]


class TestStatsParity:
    def test_coverage_profile_semantics(self, built):
        """set_stats mirrors the reference record exactly: profile[i] = #
        slots with tf == i, clamped into the last of coverage+coverage//2
        buckets (/root/reference/src/hash.hpp:297-323)."""
        index, golden = built
        cov = 3
        s = index.set_stats(cov)
        tf = index.tf_host
        max_cov = cov + cov // 2
        assert s["zero"] == int((tf == 0).sum())
        assert s["unique"] == int((tf == 1).sum())
        assert s["distinct"] == int((tf > 0).sum())
        assert s["total"] == int(tf.sum())
        assert s["max_count"] == int(tf.max())
        assert len(s["profile"]) == max_cov
        for i in range(max_cov - 1):
            assert s["profile"][i] == int((tf == i).sum())
        assert s["profile"][max_cov - 1] == int((tf >= max_cov - 1).sum())
        assert s["profile"].sum() == index.n

    def test_save_values_roundtrip(self, built, tmp_path):
        """The slot-ordered kmer\\ttf dump is exactly the .dat text format:
        loading it back through load_dat reproduces the spectrum."""
        from aindex_tpu.pipeline.build import load_dat
        from aindex_tpu.core import codec
        index, golden = built
        p = tmp_path / "dump.dat"
        zeros, ones, other = index.save_values(str(p))
        assert zeros == 0  # built from a spectrum: every slot has tf >= 1
        assert ones + other == index.n
        keys, counts = load_dat(str(p), 23)
        order = np.argsort(index.checker_host)
        np.testing.assert_array_equal(keys, index.checker_host[order])
        np.testing.assert_array_equal(counts,
                                      index.tf_host[order].astype(np.uint64))
        # line order is slot order
        first_km = open(p).readline().split("\t")[0]
        assert codec.encode_kmer(first_km) == int(index.checker_host[0])


class TestAlternateK:
    """Engine dispatch across k: small k always takes the quotient layout
    (fp-width floor is trivial), large k near the eligibility boundary
    falls back to the wide CuckooTable — both exact."""

    @pytest.mark.parametrize("k", [11, 15, 25, 29])
    def test_build_query_roundtrip(self, k, rng):
        from aindex_tpu.core import codec
        from aindex_tpu.index import quotcuckoo
        bases = np.frombuffer(b"ACGT", dtype=np.uint8)
        reads = [bytes(bases[rng.integers(0, 4, size=60)]).decode()
                 for _ in range(20)]
        store = ReadsStore.from_sequences(reads)
        index = Sparse23Index.build_from_blob(store.blob, k=k)
        golden = oracle.count_canonical(reads, k)
        kms = sorted(golden)
        assert [int(v) for v in index.get_tf_values(kms)] == \
            [golden[km] for km in kms]
        # absent + revcomp forms
        rcs = [oracle.rc(km) for km in kms[:50]]
        assert [int(v) for v in index.get_tf_values(rcs)] == \
            [golden[km] for km in kms[:50]]
        # engine selection matches the documented eligibility rule
        expect_quot = quotcuckoo.eligible(index.n, k)
        assert (index.quot is not None) == expect_quot
        if not expect_quot:
            assert index.cuckoo is not None  # wide fallback serves
        # coverage path (fused-or-fallback) against a read
        cov = index.sequence_coverage(reads[0])
        want = [golden[min(reads[0][i:i+k], oracle.rc(reads[0][i:i+k]))]
                for i in range(len(reads[0]) - k + 1)]
        assert [int(v) for v in cov] == want

    def test_eligibility_boundaries(self):
        from aindex_tpu.index import quotcuckoo
        # k <= 15 (W <= 31): always eligible regardless of n
        assert quotcuckoo.eligible(10, 13)
        # k = 23: the floor is 2^15 rows (512 KB) — always worth it
        assert quotcuckoo.eligible(10, 23)
        assert quotcuckoo.eligible(10_000_000, 23)
        # k = 29 (W = 58, floor 2^27 rows = 1 GB): only at large n
        assert not quotcuckoo.eligible(10_000, 29)
        assert quotcuckoo.eligible(200_000_000, 29)
