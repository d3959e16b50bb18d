"""Multi-process ("multi-host") build scaling measurement.

Launches the FULL pipeline (build_all over the global mesh) at 1 and N
jax.distributed processes on localhost and reports wall-clock build
throughput per process count, asserting the artifact sets are
byte-identical across runs. On real hosts each process owns distinct
cards/cores and the table measures true cross-host scaling; on a shared-core
CPU box (CI) the processes contend for the same cores, so the numbers
validate *functional* scaling and measure the coordination overhead
floor — the same caveat as scripts/bench_scaling.py.

Usage (CPU, 2 processes x 4 virtual devices):
  PYTHONPATH=. python scripts/bench_multihost.py --mb 2 --procs 2 [--out multihost.json]
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import tempfile
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
ARTIFACTS = (".reads", ".ridx", ".pf", ".tf.bin", ".kmers.bin",
             ".index.bin", ".indices.bin")


def worker(port: str, pid: str, nproc: str, fasta: str, prefix: str,
           times_out: str) -> None:
    import jax
    jax.config.update("jax_platforms", "cpu")
    n = int(nproc)
    from aindex_tpu.parallel import distributed
    if n > 1:
        distributed.initialize(f"localhost:{port}", n, int(pid))
        mesh = distributed.global_mesh()
    else:
        from aindex_tpu.parallel.mesh import make_mesh
        mesh = make_mesh()
    from aindex_tpu.pipeline.build import BuildConfig, build_all
    t0 = time.time()
    build_all([fasta], BuildConfig(prefix=prefix, k=23, chunk=1 << 19,
                                   mesh=mesh))
    dt = time.time() - t0
    if int(pid) == 0:
        with open(times_out, "w") as f:
            json.dump({"build_s": dt, "n_proc": n,
                       "global_devices": jax.device_count()}, f)


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--mb", type=float, default=2.0)
    ap.add_argument("--procs", type=int, default=2)
    ap.add_argument("--devices-per-proc", type=int, default=4)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    rng = np.random.default_rng(7)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    n_reads = int(args.mb * (1 << 20)) // 151
    rows = []
    with tempfile.TemporaryDirectory() as td:
        fasta = os.path.join(td, "in.fa")
        with open(fasta, "w") as f:
            for i in range(n_reads):
                f.write(f">r{i}\n"
                        f"{bases[rng.integers(0, 4, 150)].tobytes().decode()}\n")
        blob_mb = os.path.getsize(fasta) / 1e6 * (150 / 155.0)

        ref_prefix = None
        for n_proc in sorted({1, args.procs}):
            prefix = os.path.join(td, f"p{n_proc}.23")
            times = os.path.join(td, f"t{n_proc}.json")
            env = dict(os.environ,
                       XLA_FLAGS="--xla_force_host_platform_device_count="
                                 f"{args.devices_per_proc}",
                       PYTHONPATH=os.pathsep.join(
                           [REPO] + os.environ.get("PYTHONPATH", "")
                           .split(os.pathsep)))
            port = str(free_port())
            procs = [subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--worker",
                 port, str(pid), str(n_proc), fasta, prefix, times],
                env=env) for pid in range(n_proc)]
            for p in procs:
                p.wait(timeout=1200)
                assert p.returncode == 0, f"worker failed at n={n_proc}"
            with open(times) as f:
                rec = json.load(f)
            if ref_prefix is None:
                ref_prefix = prefix
                parity = "baseline"
            else:
                same = all(open(prefix + s, "rb").read()
                           == open(ref_prefix + s, "rb").read()
                           for s in ARTIFACTS)
                parity = "exact" if same else "MISMATCH"
            rows.append({"processes": n_proc,
                         "global_devices": rec["global_devices"],
                         "build_s": round(rec["build_s"], 2),
                         "build_mbps": round(blob_mb / rec["build_s"], 3),
                         "artifact_parity": parity})
            print(json.dumps(rows[-1]), flush=True)
    if args.out:
        try:
            existing = json.load(open(args.out))
        except (OSError, ValueError):
            existing = {}
        existing["multihost"] = rows
        with open(args.out, "w") as f:
            json.dump(existing, f, indent=1)
    assert all(r["artifact_parity"] in ("baseline", "exact") for r in rows)


if __name__ == "__main__":
    if len(sys.argv) > 1 and sys.argv[1] == "--worker":
        worker(*sys.argv[2:8])
    else:
        main()
