"""Run the k-mer index's main path on an NVIDIA GPU and check every answer.

One process drives the card. The one-card run generates the E. coli-scale
read set (``scripts/make_scale_corpus.py``: 4.64 Mbp genome, 150 bp reads
at 25x, 0.3% substitutions), builds the sparse 23-mer and the dense 13-mer
index through the CLI (``aindex_tpu.cli.main``, in-process), loads both
with ``AIndex.load_from_prefix`` and compares every query family, the
dense table and both positional CSRs with the plain numpy reference below,
which shares no code with the package. Counts and positions are integers:
every comparison is exact.

    python chip_smoke.py                 # one GPU, 25x coverage
    python chip_smoke.py --coverage 5    # the same path on fewer reads
    python chip_smoke.py --four          # the mesh path on four GPUs

``--four`` runs only the multi-card path: the data-parallel dense count,
the (data=2, index=2) sparse build, ``shard_to`` a (1, 4) index mesh and
the (data=4) positional fill, each compared bit for bit with a one-card
build made in the same process.

Each phase prints its wall time on its own line, beside the card's name
and power limit. The last line is one JSON object naming the device. With
no GPU, or when any check fails, the script exits non-zero and prints no
JSON line.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import time
import traceback

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
K13, K23 = 13, 23
ONE = "the one-card build"


class SmokeError(RuntimeError):
    """A phase's result differs from the reference, or a precondition
    (device, native runtime, routing) does not hold."""


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeError(what)


# ---------------------------------------------------------------------------
# plain numpy reference (imports nothing from aindex_tpu)
# ---------------------------------------------------------------------------

_LUT = np.full(256, 4, np.uint8)
for _i, _c in enumerate(b"ACGT"):
    _LUT[_c] = _i
    _LUT[_c + 32] = _i          # lowercase counts as the same base
_COMP = np.frombuffer(b"TGCA", np.uint8)
SENTINEL = np.uint64(0xFFFFFFFFFFFFFFFF)


def parse_fasta(path: str) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(blob, starts, ends): one sequence per record, each followed by a
    newline, in file order — the layout of the index's ``.reads`` blob."""
    with open(path, "rb") as f:
        lines = f.read().split(b"\n")
    seqs, cur = [], []
    for line in lines:
        if line.startswith(b">"):
            if cur:
                seqs.append(b"".join(cur))
            cur = []
        elif line:
            cur.append(line.strip())
    if cur:
        seqs.append(b"".join(cur))
    lens = np.fromiter((len(s) for s in seqs), np.int64, len(seqs))
    starts = np.concatenate([[0], np.cumsum(lens + 1)[:-1]]).astype(np.int64)
    blob = np.frombuffer(b"".join(s + b"\n" for s in seqs), np.uint8)
    return blob, starts, starts + lens


def ref_windows(blob: np.ndarray, k: int
                ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(forward code, reverse-complement code, valid) of every k-window of
    the blob, by shift-or over 2-bit base codes."""
    n = blob.size - k + 1
    if n <= 0:
        empty = np.zeros(0, np.uint64)
        return empty, empty, np.zeros(0, bool)
    base = _LUT[blob]
    bad = np.concatenate([[0], np.cumsum(base > 3, dtype=np.int64)])
    valid = (bad[k:] - bad[:-k]) == 0
    b = (base & 3).astype(np.uint64)
    fwd = np.zeros(n, np.uint64)
    for j in range(k):
        fwd <<= np.uint64(2)
        fwd |= b[j:j + n]
    comp = np.uint64(3) - b
    rc = np.zeros(n, np.uint64)
    for j in reversed(range(k)):
        rc <<= np.uint64(2)
        rc |= comp[j:j + n]
    return fwd, rc, valid


def ref_row_codes(mat: np.ndarray) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(forward, reverse-complement, valid) code of each row of a [n, k]
    ASCII matrix."""
    base = _LUT[mat]
    valid = (base < 4).all(axis=1)
    b = (base & 3).astype(np.uint64)
    k = mat.shape[1]
    fwd = np.zeros(len(mat), np.uint64)
    rc = np.zeros(len(mat), np.uint64)
    for j in range(k):
        fwd = (fwd << np.uint64(2)) | b[:, j]
        rc = (rc << np.uint64(2)) | (np.uint64(3) - b[:, k - 1 - j])
    return fwd, rc, valid


class Ref13:
    """Forward 13-mer counts (``np.bincount``) and the code-ordered CSR."""

    def __init__(self, blob: np.ndarray):
        fwd, _, valid = ref_windows(blob, K13)
        self.win = np.where(valid, fwd, SENTINEL)
        codes = fwd[valid].astype(np.int64)
        self.table = np.bincount(codes, minlength=4 ** K13).astype(np.uint64)
        self.positions = np.flatnonzero(valid)[np.argsort(codes,
                                                          kind="stable")]

    def tf(self, codes: np.ndarray, valid: np.ndarray) -> np.ndarray:
        safe = np.where(valid, codes, 0).astype(np.int64)
        return np.where(valid, self.table[safe], 0)


class Ref23:
    """Canonical k-mer spectrum (``np.unique``) and, per key, its blob
    positions in ascending order (stable argsort of the window codes)."""

    def __init__(self, blob: np.ndarray, k: int = K23):
        fwd, rc, valid = ref_windows(blob, k)
        canon = np.minimum(fwd, rc)
        del fwd, rc
        self.win = np.where(valid, canon, SENTINEL)
        live = canon[valid]
        order = np.argsort(live, kind="stable")
        self.positions = np.flatnonzero(valid)[order]
        self.keys, self.counts = np.unique(live[order], return_counts=True)
        self.offsets = np.concatenate([[0], np.cumsum(self.counts)])

    def slot(self, canon: np.ndarray) -> np.ndarray:
        """Index into ``keys`` per key; -1 when absent."""
        i = np.searchsorted(self.keys, canon)
        ic = np.minimum(i, max(len(self.keys) - 1, 0))
        hit = (i < len(self.keys)) & (self.keys[ic] == canon) \
            if len(self.keys) else np.zeros(canon.shape, bool)
        return np.where(hit, ic, -1)

    def tf(self, canon: np.ndarray, valid: np.ndarray) -> np.ndarray:
        s = self.slot(np.where(valid, canon, SENTINEL))
        return np.where(s >= 0, self.counts[np.maximum(s, 0)], 0)

    def positions_of(self, canon: int) -> list[int]:
        s = int(self.slot(np.array([canon], np.uint64))[0])
        if s < 0:
            return []
        return self.positions[self.offsets[s]:self.offsets[s + 1]].tolist()


def ref_revcomp_rows(mat: np.ndarray) -> np.ndarray:
    return _COMP[_LUT[mat] & 3][:, ::-1].copy()


# ---------------------------------------------------------------------------
# harness helpers
# ---------------------------------------------------------------------------

def card_line() -> str:
    """``nvidia-smi`` name and power limit, or why they are unknown."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True).stdout
        cards = [line.strip() for line in out.splitlines() if line.strip()]
        if len(set(cards)) == 1 and len(cards) > 1:
            return f"{len(cards)} x {cards[0]}"
        return "; ".join(cards)
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({e.__class__.__name__})"


def require_devices(platform: str, count: int) -> list:
    import jax
    devs = jax.devices()
    check(devs[0].platform == platform,
          f"JAX found no {platform}: default device platform is "
          f"{devs[0].platform!r}")
    check(len(devs) >= count,
          f"needs {count} {platform} devices, JAX found {len(devs)}")
    return devs


class Phases:
    """Wall time per phase, printed as each phase ends."""

    def __init__(self):
        self.seconds: dict[str, float] = {}

    @contextlib.contextmanager
    def __call__(self, name: str):
        t0 = time.perf_counter()
        yield
        dt = time.perf_counter() - t0
        self.seconds[name] = dt
        print(f"phase {name}: {dt:.3f} s", flush=True)


def memory_report(name: str, fn, *args, **kwargs) -> None:
    """Print ``compiled.memory_analysis()`` of one jitted program."""
    stats = fn.lower(*args, **kwargs).compile().memory_analysis()
    if stats is None:
        print(f"memory {name}: unavailable", flush=True)
        return
    fields = ("argument_size_in_bytes", "output_size_in_bytes",
              "alias_size_in_bytes", "temp_size_in_bytes",
              "generated_code_size_in_bytes")
    print(f"memory {name}: " + " ".join(
        f"{f.replace('_size_in_bytes', '')}={getattr(stats, f, 'na')}"
        for f in fields), flush=True)


def _packed_rows(rows: int, stride: int, k: int):
    """Shape-true packed batch for ``rows`` coverage rows of ``stride``
    bytes (the coverage paths' ingest layout)."""
    from aindex_tpu.core import codec
    flat = np.full(rows * stride + k, ord("\n"), np.uint8)
    return codec.pack_ascii_chunk(flat)


def load_corpus_module():
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "make_scale_corpus",
        os.path.join(ROOT, "scripts", "make_scale_corpus.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def sample_windows(rng, blob, starts, ends, k, n) -> np.ndarray:
    """[n, k] ASCII matrix of read windows drawn uniformly."""
    r = rng.integers(0, len(starts), n)
    span = np.maximum(ends[r] - starts[r] - k + 1, 1)
    pos = starts[r] + (rng.random(n) * span).astype(np.int64)
    return blob[pos[:, None] + np.arange(k)[None, :]]


def query_matrix(rng, blob, starts, ends, k, n) -> np.ndarray:
    """Half read windows, a quarter their reverse complements, a quarter
    random k-mers (mostly absent); a few rows carry an N."""
    half, quarter = n // 2, n // 4
    mat = np.empty((n, k), np.uint8)
    mat[:half] = sample_windows(rng, blob, starts, ends, k, half)
    mat[half:half + quarter] = ref_revcomp_rows(
        sample_windows(rng, blob, starts, ends, k, quarter))
    rest = n - half - quarter
    mat[half + quarter:] = np.frombuffer(b"ACGT", np.uint8)[
        rng.integers(0, 4, (rest, k))]
    bad = half + quarter + np.arange(min(8, rest))
    mat[bad, rng.integers(0, k, bad.size)] = ord("N")
    return mat


def as_strings(mat: np.ndarray) -> list[str]:
    return np.char.decode(
        np.ascontiguousarray(mat).view(f"S{mat.shape[1]}").ravel(),
        "ascii").tolist()


def equal(name: str, got, want, against: str = "the reference") -> None:
    got, want = np.asarray(got), np.asarray(want)
    check(got.shape == want.shape,
          f"{name}: shape {got.shape} != {against} {want.shape}")
    bad = np.flatnonzero(got.astype(np.int64).ravel()
                         != want.astype(np.int64).ravel())
    check(bad.size == 0, f"{name}: {bad.size} of {want.size} differ "
          f"(first at {bad[:1].tolist()}: got "
          f"{got.ravel()[bad[:1]].tolist()}, want "
          f"{want.ravel()[bad[:1]].tolist()})")
    print(f"check {name}: {want.size} values equal {against}", flush=True)


def csr_by_key(offsets: np.ndarray, positions: np.ndarray,
               keys: np.ndarray) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(keys ascending, lengths, 0-based positions) of a slot-keyed CSR,
    rows reordered by key."""
    perm = np.argsort(keys, kind="stable")
    off = offsets.astype(np.int64)
    lens = (off[1:] - off[:-1])[perm]
    new_off = np.concatenate([[0], np.cumsum(lens)])
    src = (np.arange(int(new_off[-1]), dtype=np.int64)
           - np.repeat(new_off[:-1], lens) + np.repeat(off[:-1][perm], lens))
    return keys[perm], lens, positions[src].astype(np.int64) - 1


# ---------------------------------------------------------------------------
# one card: corpus -> CLI builds -> load -> queries -> reference
# ---------------------------------------------------------------------------

def run_one(out_dir: str, *, coverage: float = 25.0, seed: int = 1,
            genome_bp: int | None = None, n_queries: int = 1 << 20,
            n_cov: int = 16384, n_pos: int = 4096, n_single: int = 256,
            gpu_tests: bool = True, phases: Phases | None = None
            ) -> dict[str, float]:
    """The one-card main path at a given size; raises SmokeError on the
    first answer that differs from the reference."""
    phase = phases or Phases()
    os.makedirs(out_dir, exist_ok=True)
    fasta = os.path.join(out_dir, "ec.fasta")
    p23, p13 = os.path.join(out_dir, "ec.23"), os.path.join(out_dir, "ec.13")
    rng = np.random.default_rng(seed)

    with phase("native"):
        from aindex_tpu import native
        check(native.ensure_built(), "native host runtime did not build")
        check(native.available(), "native host runtime did not load")

    with phase("corpus"):
        corpus = load_corpus_module()
        n_reads = corpus.write_corpus(
            fasta, coverage, seed,
            genome_bp if genome_bp is not None else corpus.GENOME_BP)
        print(f"corpus: {n_reads} reads at {coverage}x, seed {seed}",
              flush=True)

    from aindex_tpu import cli
    with phase("build_sparse23"):
        check(cli.main(["compute-aindex", "-i", fasta, "-t", "fasta",
                        "-o", p23, "-k", "23"]) == 0, "compute-aindex failed")
    with phase("build_dense13"):
        check(cli.main(["compute-aindex-direct", "-i", fasta, "-t", "fasta",
                        "-o", p13]) == 0, "compute-aindex-direct failed")

    from aindex_tpu import AIndex
    with phase("load"):
        ai23 = AIndex.load_from_prefix(p23, load_reads=True)
        ai13 = AIndex.load_from_prefix(p13)

    with phase("reference"):
        blob, starts, ends = parse_fasta(fasta)
        check(np.array_equal(np.fromfile(p23 + ".reads", np.uint8), blob),
              "the .reads blob differs from the parsed FASTA")
        r23 = Ref23(blob)
        r13 = Ref13(blob)
        print(f"reference: {blob.size} blob bytes, {len(r23.keys)} distinct "
              f"canonical 23-mers, {len(r23.positions)} positions",
              flush=True)

    import jax
    import jax.numpy as jnp

    with phase("query_sparse23"):
        mat = query_matrix(rng, blob, starts, ends, K23, n_queries)
        kmers = as_strings(mat)
        fwd, rc, valid = ref_row_codes(mat)
        canon = np.minimum(fwd, rc)
        want = r23.tf(canon, valid)
        equal("23-mer get_tf_values", ai23.get_tf_values(kmers), want)
        codes_dev = jax.device_put(fwd)
        valid_dev = jax.device_put(valid)
        equal("23-mer get_tf_values_codes_23mer",
              np.asarray(ai23.get_tf_values_codes_23mer(codes_dev,
                                                        valid_dev)), want)
        both = np.asarray(ai23.get_tf_both_directions_23mer_batch(kmers))
        equal("23-mer get_tf_both_directions_23mer_batch", both,
              np.stack([want, want], axis=1))
        single = [ai23.get_tf_both_directions_23mer(km)
                  for km in kmers[:n_single]]
        equal("23-mer get_tf_both_directions_23mer", single,
              np.stack([want[:n_single]] * 2, axis=1))

        # coverage of whole reads
        rows = rng.choice(len(starts), min(n_cov, len(starts)), replace=False)
        seqs = [blob[starts[r]:ends[r]].tobytes().decode() for r in rows]
        cov_want = [r23.tf(r23.win[starts[r]:ends[r] - K23 + 1],
                           r23.win[starts[r]:ends[r] - K23 + 1] != SENTINEL)
                    for r in rows]
        got = ai23.get_sequence_coverage_batch(seqs)
        equal("23-mer get_sequence_coverage_batch",
              np.concatenate(got), np.concatenate(cov_want))
        equal("23-mer get_sequence_coverage",
              np.concatenate([ai23.get_sequence_coverage(s)
                              for s in seqs[:n_single]]),
              np.concatenate(cov_want[:n_single]))

        # positions: present k-mers of either strand
        present = np.flatnonzero(want > 0)[:n_pos]
        pk = [kmers[i] for i in present]
        pos_want = [r23.positions_of(int(canon[i])) for i in present]
        got_pos = [ai23.get_positions(km) for km in pk]
        check(got_pos == pos_want, "23-mer get_positions differs from the "
              "reference")
        check(ai23.get_positions_batch(pk) == pos_want,
              "23-mer get_positions_batch differs from the reference")
        rid_want = []
        for plist in pos_want:
            d: dict[int, list[int]] = {}
            for p in plist:
                r = int(np.searchsorted(starts, p, side="right")) - 1
                d.setdefault(r, []).append(p - int(starts[r]))
            rid_want.append(d)
        check([ai23.get_rid2poses(km) for km in pk] == rid_want,
              "23-mer get_rid2poses differs from the reference")
        print(f"check 23-mer positions: {len(pk)} k-mers, "
              f"{sum(map(len, pos_want))} positions and their read ids "
              f"equal the reference", flush=True)

        # De Bruijn right extensions kmer[1:] + b, b in ACGT
        sel = present[:n_single]
        b = np.arange(4, dtype=np.uint64)
        ext = ((fwd[sel, None] << np.uint64(2)) | b) \
            & np.uint64((1 << (2 * K23)) - 1)
        ext_rc = (rc[sel, None] >> np.uint64(2)) \
            | ((np.uint64(3) - b) << np.uint64(2 * (K23 - 1)))
        db_want = r23.tf(np.minimum(ext, ext_rc), np.ones(ext.shape, bool))
        db_got = [[d[c] for c in "ACGT"]
                  for d in (ai23.debruijn_next(kmers[i]) for i in sel)]
        equal("23-mer debruijn_next", db_got, db_want)

        # the whole table and CSR, reordered by key
        keys, lens, positions = csr_by_key(
            ai23.pos23.offsets, ai23.pos23.positions,
            ai23.sparse23.checker_host)
        equal("23-mer index keys (np.unique)", keys, r23.keys)
        equal("23-mer index tf", ai23.sparse23.tf_host[
            np.argsort(ai23.sparse23.checker_host, kind="stable")],
            r23.counts)
        equal("23-mer CSR lengths", lens, r23.counts)
        equal("23-mer CSR positions", positions, r23.positions)

    with phase("query_dense13"):
        mat = query_matrix(rng, blob, starts, ends, K13, n_queries)
        kmers = as_strings(mat)
        fwd, rc, valid = ref_row_codes(mat)
        equal("13-mer get_tf_values", ai13.get_tf_values(kmers),
              r13.tf(fwd, valid))
        total_want = r13.tf(fwd, valid) + r13.tf(rc, valid)
        codes_dev = jax.device_put(fwd.astype(np.uint32))
        valid_dev = jax.device_put(valid)
        equal("13-mer get_total_tf_values_codes_13mer",
              np.asarray(ai13.get_total_tf_values_codes_13mer(codes_dev,
                                                               valid_dev)),
              total_want)
        got = ai13.get_sequence_coverage_batch(seqs)
        cov_want = [r13.tf(r13.win[starts[r]:ends[r] - K13 + 1],
                           r13.win[starts[r]:ends[r] - K13 + 1] != SENTINEL)
                    for r in rows]
        equal("13-mer get_sequence_coverage_batch", np.concatenate(got),
              np.concatenate(cov_want))
        equal("13-mer dense table (host copy)", ai13.dense13.tf_host,
              r13.table)
        equal("13-mer dense table (device copy)",
              np.asarray(ai13.dense13.tf), r13.table)
        equal("13-mer CSR offsets", ai13.pos13.offsets,
              np.concatenate([[0], np.cumsum(r13.table, dtype=np.int64)]))
        equal("13-mer CSR positions",
              ai13.pos13.positions.astype(np.int64) - 1, r13.positions)

    with phase("routing"):
        from aindex_tpu.core import hostdev
        print(f"routing: H2D {hostdev.h2d_bandwidth_mbps():.1f} MB/s, "
              f"D2H {hostdev.d2h_bandwidth_mbps():.1f} MB/s", flush=True)
        host_ascii = hostdev.prefer_host_ascii_queries()
        reduce_mode = hostdev.spectrum_reduce_mode()
        encode_min = hostdev.device_encode_min()
        print(f"routing: ascii queries -> "
              f"{'host' if host_ascii else 'device'}, spectrum reduce -> "
              f"{reduce_mode}, device encode from "
              f"{'never' if encode_min is None else encode_min}", flush=True)
        env = os.environ
        check(not host_ascii or hostdev.ASCII_QUERY_ENV in env,
              "ASCII queries routed to the host engine with no override")
        check(reduce_mode == "device" or hostdev.SPECTRUM_REDUCE_ENV in env,
              "spectrum reduction routed to the host with no override")
        check(encode_min is not None or hostdev.ENCODE_ROUTE_ENV in env
              or hostdev.ASCII_QUERY_ENV in env,
              "k-mer encode routed to the host with no override")

        from aindex_tpu.index import dense13, quotcuckoo
        from aindex_tpu.kernels import coverage as cov_kernels
        qc = ai23.sparse23.quot
        memory_report("sparse23 codes-in (quot_tf_canonical)",
                      quotcuckoo.quot_tf_canonical, *qc.device, codes_dev
                      .astype(jnp.uint64), valid_dev, *qc.mults, k=K23,
                      m=qc.m, lb=qc.lb, w=qc.w)
        cov_rows = 1 << max(3, (len(seqs) - 1).bit_length())
        stride = cov_kernels._length_bucket(150, K23) + 1
        memory_report("sparse23 coverage (quot_tf_windows_packed)",
                      quotcuckoo.quot_tf_windows_packed, *qc.device,
                      *_packed_rows(cov_rows, stride, K23), *qc.mults,
                      k=K23, m=qc.m, lb=qc.lb, w=qc.w, rows=cov_rows,
                      stride=stride)
        d13 = ai13.dense13
        memory_report("dense13 codes-in (_gather_codes_valid_u32)",
                      dense13._gather_codes_valid_u32, d13.tf_total,
                      codes_dev, valid_dev)
        memory_report("dense13 coverage (_coverage_dense_packed)",
                      cov_kernels._coverage_dense_packed, d13.tf_query,
                      *_packed_rows(cov_rows, stride, K13), jnp.uint32(0),
                      k=K13, rows=cov_rows, stride=stride)
        print(f"narrowed dense tables: tf_query {d13.tf_query.dtype}, "
              f"tf_total {d13.tf_total.dtype}", flush=True)
        chunk = 1 << 22
        memory_report("dense13 count step (_count_step_packed)",
                      dense13._count_step_packed,
                      jax.ShapeDtypeStruct((4 ** K13,), jnp.uint32),
                      jax.ShapeDtypeStruct((chunk // 16,), jnp.uint32),
                      jax.ShapeDtypeStruct((chunk // 8,), jnp.uint8))

    if gpu_tests:
        with phase("gpu_tests"):
            import pytest
            # the backend is already up; this only tells conftest.py not
            # to pin the test session to the CPU
            os.environ.setdefault("JAX_PLATFORMS", "cuda")
            rc = pytest.main([os.path.join(ROOT, "tests"), "-q", "-m", "gpu",
                              "-p", "no:cacheprovider"])
            check(rc == 0, f"gpu-marked tests failed (pytest exit {rc})")
    return phase.seconds


# ---------------------------------------------------------------------------
# four cards: the mesh path against a one-card build in the same process
# ---------------------------------------------------------------------------

def run_four(out_dir: str, devices: list, *, coverage: float = 25.0,
             seed: int = 1, genome_bp: int | None = None,
             n_queries: int = 1 << 20, n_cov: int = 16384, n_pos: int = 4096,
             phases: Phases | None = None) -> dict[str, float]:
    """Sharded dense count, (2, 2) sparse build, (1, 4) ``shard_to`` and
    (4,) positional fill, each bit-identical to the one-card build."""
    import jax

    from aindex_tpu import AIndex
    from aindex_tpu.core.reads import ReadsStore
    from aindex_tpu.index.dense13 import Dense13Index
    from aindex_tpu.index.positional import PositionalIndex
    from aindex_tpu.index.sparse23 import Sparse23Index
    from aindex_tpu.parallel.mesh import make_mesh

    phase = phases or Phases()
    os.makedirs(out_dir, exist_ok=True)
    fasta = os.path.join(out_dir, "ec.fasta")
    rng = np.random.default_rng(seed)
    check(len(devices) == 4, f"--four needs exactly 4 devices, got "
          f"{len(devices)}")
    with phase("corpus"):
        corpus = load_corpus_module()
        corpus.write_corpus(fasta, coverage, seed,
                            genome_bp if genome_bp is not None
                            else corpus.GENOME_BP)
        blob, starts, ends = parse_fasta(fasta)
        store = ReadsStore(blob, starts, ends)

    with phase("one_card_build"):          # on the default device
        dense1 = Dense13Index.build_from_blob(blob)
        sparse1 = Sparse23Index.build_from_blob(blob)
        pos1 = PositionalIndex.build_sparse23(blob, sparse1)
        tf13 = dense1.tf_host

    with phase("dense13_data4"):
        dense4 = Dense13Index.build_from_blob(
            blob, mesh=make_mesh(n_data=4, devices=devices))
        equal("dense13 (data=4) table", dense4.tf_host, tf13, ONE)

    with phase("sparse23_data2_index2"):
        sparse4 = Sparse23Index.build_from_blob(
            blob, mesh=make_mesh(n_data=2, n_index=2, devices=devices))
        equal("sparse23 (2x2) keys", sparse4.checker_host,
              sparse1.checker_host, ONE)
        equal("sparse23 (2x2) tf", sparse4.tf_host, sparse1.tf_host, ONE)

    with phase("positional_data4"):
        pos4 = PositionalIndex.build_sparse23(
            blob, sparse1, mesh=make_mesh(n_data=4, devices=devices))
        equal("positional (data=4) offsets", pos4.offsets, pos1.offsets,
              ONE)
        equal("positional (data=4) positions", pos4.positions,
              pos1.positions, ONE)

    with phase("shard_to_index4"):
        prefix = os.path.join(out_dir, "ec4.23")
        sparse4.save(prefix)
        pos4.save(prefix)
        store.save(prefix)
        sharded = AIndex.load_from_prefix(prefix, load_reads=True)
        sharded.shard_to(make_mesh(n_data=1, n_index=4, devices=devices))
        single = AIndex.load_from_prefix(prefix, load_reads=True)
        mphf = sparse1.mphf
        one = (sparse1.checker_host.nbytes + sparse1.tf_host.nbytes
               + mphf.slots.nbytes + mphf.g_packed.nbytes)
        print(f"index bytes per device on the (1, 4) mesh: "
              f"{sharded._sharded23.per_device_bytes}; the same arrays on "
              f"one card: {one}", flush=True)

        mat = query_matrix(rng, blob, starts, ends, K23, n_queries)
        kmers = as_strings(mat)
        fwd, _, valid = ref_row_codes(mat)
        want = np.asarray(single.get_tf_values(kmers))
        equal("sharded get_tf_values", sharded.get_tf_values(kmers), want,
              ONE)
        codes_dev, valid_dev = jax.device_put(fwd), jax.device_put(valid)
        equal("sharded get_tf_values_codes_23mer",
              np.asarray(sharded.get_tf_values_codes_23mer(codes_dev,
                                                           valid_dev)),
              np.asarray(single.get_tf_values_codes_23mer(codes_dev,
                                                          valid_dev)), ONE)
        equal("sharded get_tf_both_directions_23mer_batch",
              sharded.get_tf_both_directions_23mer_batch(kmers),
              single.get_tf_both_directions_23mer_batch(kmers), ONE)
        rows = rng.choice(len(starts), min(n_cov, len(starts)), replace=False)
        seqs = [blob[starts[r]:ends[r]].tobytes().decode() for r in rows]
        equal("sharded get_sequence_coverage_batch",
              np.concatenate(sharded.get_sequence_coverage_batch(seqs)),
              np.concatenate(single.get_sequence_coverage_batch(seqs)), ONE)
        present = [kmers[i] for i in np.flatnonzero(want > 0)[:n_pos]]
        check(sharded.get_positions_batch(present)
              == single.get_positions_batch(present),
              "sharded get_positions_batch differs from one card")
        check([sharded.debruijn_next(km) for km in present[:256]]
              == [single.debruijn_next(km) for km in present[:256]],
              "sharded debruijn_next differs from one card")
        print(f"check sharded positions and De Bruijn: {len(present)} "
              f"k-mers equal one card", flush=True)

    with phase("memory"):
        import jax.numpy as jnp
        from jax.sharding import NamedSharding, PartitionSpec as P
        from aindex_tpu.parallel import count13
        mesh4 = make_mesh(n_data=4, devices=devices)
        rows = NamedSharding(mesh4, P("data"))
        chunk = 1 << 22
        memory_report("count13_sharded_accumulate (psum over data=4)",
                      count13.count13_sharded_accumulate,
                      jax.ShapeDtypeStruct((4 ** K13,), jnp.uint32,
                                           sharding=NamedSharding(mesh4, P())),
                      jax.ShapeDtypeStruct((4, chunk // 16), jnp.uint32,
                                           sharding=rows),
                      jax.ShapeDtypeStruct((4, chunk // 8), jnp.uint8,
                                           sharding=rows),
                      mesh=mesh4)
    return phase.seconds


# ---------------------------------------------------------------------------

def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--seed", type=int, default=1)
    parser.add_argument("--coverage", type=float, default=25.0,
                        help="read coverage of the 4.64 Mbp genome")
    parser.add_argument("--out", default=os.path.join(ROOT, ".scale",
                                                      "chip_smoke"),
                        help="directory for the corpus and index artifacts")
    parser.add_argument("--four", action="store_true",
                        help="run only the four-card mesh path")
    args = parser.parse_args(argv)
    try:
        import jax
        devs = require_devices("gpu", 4 if args.four else 1)
        print(f"device: {devs[0].device_kind} x {len(devs)} "
              f"({devs[0].platform}), jax {jax.__version__}", flush=True)
        print(f"card: {card_line()}", flush=True)
        if args.coverage != 25.0:
            print(f"coverage cut: {args.coverage}x instead of 25x",
                  flush=True)
        phases = Phases()
        if args.four:
            run_four(args.out, devs[:4], coverage=args.coverage,
                     seed=args.seed, phases=phases)
        else:
            run_one(args.out, coverage=args.coverage, seed=args.seed,
                    phases=phases)
    except Exception:  # any failed phase: report it and exit non-zero
        traceback.print_exc()
        print("chip_smoke: FAILED", file=sys.stderr, flush=True)
        return 1
    card = card_line()
    for name, sec in phases.seconds.items():
        print(f"time {name}: {sec:.3f} s on {card}", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
