"""Synthesize an E. coli-scale read set (BASELINE.json config 3).

A 4.64 Mbp random genome (E. coli K-12 size), 150 bp reads at the
requested coverage with a 0.3% substitution error rate — errors matter
for scale realism: each one mints up to k novel k-mers, pushing the
distinct-key count toward the 10^7 regime the reference meets on real
FASTQ. Deterministic by seed.

Usage: python scripts/make_scale_corpus.py OUT.fasta [coverage=25] [seed=1]
"""

import sys

import numpy as np

GENOME_BP = 4_641_652       # E. coli K-12 MG1655 genome length
READ_LEN = 150
ERR = 0.003


def write_corpus(out: str, coverage: float = 25.0, seed: int = 1,
                 genome_bp: int = GENOME_BP) -> int:
    """Write the FASTA read set to ``out``; returns the number of reads.
    ``genome_bp`` shrinks the genome for tests; everything else is fixed."""
    rng = np.random.default_rng(seed)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    genome = bases[rng.integers(0, 4, size=genome_bp)]
    n_reads = int(genome_bp * coverage / READ_LEN)
    starts = rng.integers(0, genome_bp - READ_LEN, size=n_reads)
    with open(out, "w", buffering=1 << 22) as f:
        for i in range(0, n_reads, 4096):
            chunk = starts[i:i + 4096]
            mat = genome[chunk[:, None] + np.arange(READ_LEN)[None, :]].copy()
            errs = rng.random(mat.shape) < ERR
            mat[errs] = bases[rng.integers(0, 4, size=int(errs.sum()))]
            for j, row in enumerate(mat):
                f.write(f">r{i + j}\n")
                f.write(row.tobytes().decode())
                f.write("\n")
    return n_reads


def main():
    out = sys.argv[1]
    coverage = float(sys.argv[2]) if len(sys.argv) > 2 else 25.0
    seed = int(sys.argv[3]) if len(sys.argv) > 3 else 1
    n_reads = write_corpus(out, coverage, seed)
    print(f"{out}: {n_reads} reads, {n_reads * READ_LEN / 1e6:.1f} MB bases, "
          f"{coverage}x of {GENOME_BP / 1e6:.2f} Mbp")


if __name__ == "__main__":
    main()
