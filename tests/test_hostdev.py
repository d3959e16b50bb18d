"""Parity between the host and device query engines for ASCII batches.

The host engine (core.hostdev policy) serves string-batch lookups without
any H2D transfer; these tests pin it bit-exact against the device kernels
on the same index, and check the policy override env var.
"""

import numpy as np
import pytest

from aindex_tpu.core import hostdev
from aindex_tpu.core.reads import ReadsStore
from aindex_tpu.index.dense13 import Dense13Index
from aindex_tpu.index.sparse23 import Sparse23Index


@pytest.fixture(scope="module")
def reads():
    rng = np.random.default_rng(4242)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    reads = [bytes(bases[rng.integers(0, 4, size=64)]).decode() for _ in range(25)]
    reads += ["ACGT" * 16, "AAN" + "ACGTACGTACGTACGTACGTACG"]
    return reads


@pytest.fixture(scope="module")
def queries(reads):
    rng = np.random.default_rng(7)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    qs = [r[s:s + 23] for r in reads[:20] for s in (0, 11, 37)]
    qs += [bytes(bases[rng.integers(0, 4, size=23)]).decode() for _ in range(50)]
    qs += ["ACGTN" + "A" * 18]  # invalid
    return qs


def _with_mode(monkeypatch, mode):
    monkeypatch.setenv(hostdev.ASCII_QUERY_ENV, mode)


class TestSparseHostEngine:
    @pytest.fixture(scope="class")
    def index(self, reads):
        store = ReadsStore.from_sequences(reads)
        return Sparse23Index.build_from_blob(store.blob)

    def test_resolve_parity(self, index, queries, monkeypatch):
        codes, valid = index._encode(queries)
        _with_mode(monkeypatch, "device")
        tf_d, slot_d, strand_d = (np.asarray(a)
                                  for a in index._resolve(codes, valid))
        _with_mode(monkeypatch, "host")
        tf_h, slot_h, strand_h = index._resolve(codes, valid)
        np.testing.assert_array_equal(tf_h, tf_d)
        np.testing.assert_array_equal(slot_h, slot_d)
        np.testing.assert_array_equal(strand_h, strand_d)

    def test_get_tf_values_parity(self, index, queries, monkeypatch):
        _with_mode(monkeypatch, "device")
        dev = index.get_tf_values(queries)
        _with_mode(monkeypatch, "host")
        host = index.get_tf_values(queries)
        np.testing.assert_array_equal(np.asarray(host), np.asarray(dev))


class TestDenseHostEngine:
    @pytest.fixture(scope="class")
    def index(self, reads, tmp_path_factory):
        store = ReadsStore.from_sequences(reads)
        built = Dense13Index.build_from_blob(store.blob)
        # round-trip through save/load: load() retains the host table, which
        # is what arms the host engine
        path = str(tmp_path_factory.mktemp("d13") / "t.tf.bin")
        built.save(path)
        return Dense13Index.load(path)

    def test_host_tables_armed_after_load(self, index):
        assert index._tf_host is not None

    def test_query_parity_all_kinds(self, index, reads, monkeypatch):
        kmers = [r[s:s + 13] for r in reads[:20] for s in (0, 9, 30)]
        kmers += ["ACGTNACGTACGT"]
        _with_mode(monkeypatch, "device")
        fwd_d = index.get_tf_values(kmers)
        tot_d = index.get_total_tf_values(kmers)
        both_d = index.get_tf_both_directions(kmers)
        _with_mode(monkeypatch, "host")
        fwd_h = index.get_tf_values(kmers)
        tot_h = index.get_total_tf_values(kmers)
        both_h = index.get_tf_both_directions(kmers)
        np.testing.assert_array_equal(fwd_h, np.asarray(fwd_d))
        np.testing.assert_array_equal(tot_h, np.asarray(tot_d))
        np.testing.assert_array_equal(both_h[0], np.asarray(both_d[0]))
        np.testing.assert_array_equal(both_h[1], np.asarray(both_d[1]))

    def test_device_built_index_stays_on_device(self, reads, monkeypatch):
        # no host table => host engine must not activate (and must not pull
        # 256 MB D2H); the query still answers via the device path
        store = ReadsStore.from_sequences(reads)
        built = Dense13Index.build_from_blob(store.blob)
        _with_mode(monkeypatch, "host")
        assert built._host_tables() is None
        out = built.get_tf_values([reads[0][:13]])
        assert out.shape == (1,)


def test_policy_env_override(monkeypatch):
    _with_mode(monkeypatch, "host")
    assert hostdev.prefer_host_ascii_queries() is True
    _with_mode(monkeypatch, "device")
    assert hostdev.prefer_host_ascii_queries() is False


def test_bandwidth_probe_caches():
    a = hostdev.h2d_bandwidth_mbps()
    b = hostdev.h2d_bandwidth_mbps()
    assert a == b and a > 0


class TestEncodeRoutePolicy:
    """DEVICE_ENCODE_MIN resolves from the measured link instead of a
    hard-coded None — device encode engages on PCIe-class links without
    code edits, stays host on slow links."""

    def test_policy_by_link_class(self, monkeypatch):
        monkeypatch.delenv(hostdev.ENCODE_ROUTE_ENV, raising=False)
        monkeypatch.delenv(hostdev.ASCII_QUERY_ENV, raising=False)
        # slow link -> host encode (None)
        monkeypatch.setattr(hostdev, "_h2d_mbps", 40.0)
        assert hostdev.device_encode_min() is None
        # PCIe-class link -> device encode above the dispatch floor
        monkeypatch.setattr(hostdev, "_h2d_mbps", 10_000.0)
        assert hostdev.device_encode_min() == hostdev.DEVICE_ENCODE_MIN_BATCH

    def test_env_override(self, monkeypatch):
        monkeypatch.setattr(hostdev, "_h2d_mbps", 10_000.0)
        monkeypatch.setenv(hostdev.ENCODE_ROUTE_ENV, "never")
        assert hostdev.device_encode_min() is None
        monkeypatch.setenv(hostdev.ENCODE_ROUTE_ENV, "512")
        assert hostdev.device_encode_min() == 512

    def test_index_encode_routes_and_agrees(self, reads, queries, monkeypatch):
        """Both encode engines must produce identical (codes, valid) —
        forced here through a fake fast link so the device path runs
        whatever the measured link."""
        store = ReadsStore.from_sequences(reads)
        index = Sparse23Index.build_from_blob(store.blob)
        monkeypatch.delenv(hostdev.ENCODE_ROUTE_ENV, raising=False)
        monkeypatch.setattr(hostdev, "_h2d_mbps", 40.0)
        c_h, v_h = index._encode(queries)
        monkeypatch.setattr(hostdev, "_h2d_mbps", 10_000.0)
        monkeypatch.setenv(hostdev.ENCODE_ROUTE_ENV, str(len(queries)))
        c_d, v_d = index._encode(queries)
        np.testing.assert_array_equal(np.asarray(c_h)[np.asarray(v_h)],
                                      np.asarray(c_d)[np.asarray(v_d)])
        np.testing.assert_array_equal(np.asarray(v_h), np.asarray(v_d))
        d13 = Dense13Index.build_from_blob(store.blob)
        q13 = [q[:13] for q in queries]
        monkeypatch.setenv(hostdev.ENCODE_ROUTE_ENV, "never")
        c_h, v_h = d13._encode(q13)
        monkeypatch.setenv(hostdev.ENCODE_ROUTE_ENV, str(len(q13)))
        c_d, v_d = d13._encode(q13)
        np.testing.assert_array_equal(np.asarray(v_h), np.asarray(v_d))
        np.testing.assert_array_equal(np.asarray(c_h)[np.asarray(v_h)],
                                      np.asarray(c_d)[np.asarray(v_d)])
