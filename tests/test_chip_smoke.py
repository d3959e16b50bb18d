"""chip_smoke.py's reference and phases at tiny sizes.

On the CPU: the numpy reference against the oracle, the whole corpus ->
CLI build -> load -> query -> compare chain and the four-device mesh path,
the refusal to run without a GPU, and where the compile cache goes. The
``gpu``-marked tests need the card; ``chip_smoke.py`` runs them in its own
process, and ``JAX_PLATFORMS=cuda python -m pytest -m gpu tests/`` by hand.
"""

import importlib.util
import json
import os
import shutil

import numpy as np
import pytest

import oracle

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(coverage=3, seed=2, genome_bp=20_000, n_queries=4096, n_cov=64,
            n_pos=64)


def _load_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


smoke = _load_smoke()


@pytest.fixture
def out_dir(tmp_path):
    """Artifact directory, emptied after the test: a chain writes ~1 GB
    (the 4^13 dense table and its CSR offsets)."""
    path = tmp_path / "run"
    yield str(path)
    shutil.rmtree(path, ignore_errors=True)


def _blob(reads):
    return np.frombuffer(oracle.blob_of(reads).encode(), np.uint8)


def _decode(code, k):
    return "".join("ACGT"[(int(code) >> (2 * (k - 1 - i))) & 3]
                   for i in range(k))


@pytest.mark.parametrize("what", ["count13", "positions13", "count23",
                                  "positions23"])
def test_reference_matches_oracle(random_reads, what):
    blob = _blob(random_reads)
    if what.endswith("13"):
        ref = smoke.Ref13(blob)
        counts = oracle.count_forward(random_reads, 13)
        if what == "count13":
            nz = np.flatnonzero(ref.table)
            assert {_decode(c, 13): int(ref.table[c]) for c in nz} == counts
        else:
            want = oracle.positions_forward(random_reads, 13)
            starts = np.concatenate([[0], np.cumsum(ref.table)]).astype(np.int64)
            got = {_decode(c, 13): ref.positions[starts[c]:starts[c + 1]]
                   .tolist() for c in np.flatnonzero(ref.table)}
            assert got == want
        return
    ref = smoke.Ref23(blob)
    if what == "count23":
        got = {_decode(c, 23): int(n) for c, n in zip(ref.keys, ref.counts)}
        assert got == oracle.count_canonical(random_reads, 23)
    else:
        got = {_decode(c, 23): ref.positions_of(int(c)) for c in ref.keys}
        assert got == oracle.positions_canonical(random_reads, 23)


def test_reference_parses_the_reads_layout(tmp_path):
    """parse_fasta gives the blob layout of the index's .reads file."""
    from aindex_tpu.io.fastq import compute_reads
    fasta = tmp_path / "r.fasta"
    fasta.write_text(">a\nACGT\nAC\n>b\nGGNNT\n>c\nTTTTACG\n")
    compute_reads([str(fasta)], None, "fasta", str(tmp_path / "r"))
    blob, starts, ends = smoke.parse_fasta(str(fasta))
    assert blob.tobytes() == (tmp_path / "r.reads").read_bytes()
    assert [blob[s:e].tobytes() for s, e in zip(starts, ends)] == \
        [b"ACGTAC", b"GGNNT", b"TTTTACG"]


def test_one_card_chain_on_cpu(out_dir, capsys):
    seconds = smoke.run_one(out_dir, **TINY, n_single=16, gpu_tests=False)
    assert {"native", "corpus", "build_sparse23", "build_dense13", "load",
            "reference", "query_sparse23", "query_dense13",
            "routing"} <= set(seconds)
    out = capsys.readouterr().out
    assert "check 23-mer CSR positions" in out
    assert "check 13-mer dense table (device copy)" in out


def test_four_device_chain_on_cpu(out_dir, eight_devices):
    seconds = smoke.run_four(out_dir, eight_devices[:4], **TINY)
    assert {"one_card_build", "dense13_data4", "sparse23_data2_index2",
            "positional_data4", "shard_to_index4"} <= set(seconds)


def test_reference_catches_a_wrong_answer():
    with pytest.raises(smoke.SmokeError, match="1 of 3 differ"):
        smoke.equal("tf", [1, 2, 4], [1, 2, 3])


@pytest.mark.parametrize("argv", [[], ["--four"]])
def test_main_refuses_non_gpu(argv, capsys, tmp_path):
    assert smoke.main(argv + ["--out", str(tmp_path)]) != 0
    out = capsys.readouterr().out
    assert not any(line.startswith("{") for line in out.splitlines())
    assert not os.listdir(tmp_path)


@pytest.mark.parametrize("env", ["set", "unset"])
def test_compile_cache_placement(env, monkeypatch, tmp_path):
    import aindex_tpu
    if env == "set":
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
        assert aindex_tpu._compile_cache_dir() is None
    else:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        assert aindex_tpu._compile_cache_dir() == os.path.join(ROOT,
                                                               ".jax_cache")


def test_compile_cache_in_this_process():
    import jax
    import aindex_tpu  # noqa: F401  (sets the cache dir on import)
    want = os.environ.get("JAX_COMPILATION_CACHE_DIR") or \
        os.path.join(ROOT, ".jax_cache")
    assert jax.config.jax_compilation_cache_dir == want


# -- on the card --------------------------------------------------------------

@pytest.mark.gpu
def test_one_card_chain_on_gpu(gpu, out_dir):
    smoke.run_one(out_dir, **TINY, n_single=16, gpu_tests=False)


@pytest.mark.gpu
def test_routing_picks_the_device_on_gpu(gpu, monkeypatch):
    from aindex_tpu.core import hostdev
    for var in (hostdev.ASCII_QUERY_ENV, hostdev.SPECTRUM_REDUCE_ENV,
                hostdev.ENCODE_ROUTE_ENV):
        monkeypatch.delenv(var, raising=False)
    assert not hostdev.prefer_host_ascii_queries()
    assert hostdev.spectrum_reduce_mode() == "device"
    assert hostdev.device_encode_min() == hostdev.DEVICE_ENCODE_MIN_BATCH


@pytest.mark.gpu
def test_card_line_names_the_card(gpu):
    out = smoke.card_line()
    assert "H100" in out or "NVIDIA" in out, json.dumps(out)
