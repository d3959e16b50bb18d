"""Test configuration: the CPU backend with a virtual 8-device mesh.

Unless ``JAX_PLATFORMS`` names another platform, tests run on the CPU for
fast compiles and exercise multi-device sharding on a virtual mesh
(SURVEY.md §4: XLA_FLAGS=--xla_force_host_platform_device_count=N). On a
machine with an NVIDIA GPU, ``JAX_PLATFORMS=cuda python -m pytest -m gpu
tests/`` runs the tests that need the card (``gpu`` marker, ``gpu``
fixture); elsewhere they skip.
"""

import os

os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")

import jax  # noqa: E402

if os.environ.get("JAX_PLATFORMS", "cpu") in ("", "cpu"):
    jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(20260817)


@pytest.fixture(scope="session")
def random_reads(rng) -> list[str]:
    """A small but adversarial read set: random reads, a repetitive read,
    N-containing reads, paired-style reads with '~', and a short read."""
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    reads = [
        bytes(bases[rng.integers(0, 4, size=60)]).decode() for _ in range(40)
    ]
    reads.append("ACGT" * 20)                       # repetitive
    reads.append("AC" + "N" * 5 + "GTGT" * 15)      # internal Ns
    reads.append(reads[0][:30] + "~" + reads[1][:30])  # paired separator
    reads.append("ACGTACGTACGTA")                   # exactly k=13
    return reads


@pytest.fixture(scope="session")
def eight_devices():
    devs = jax.devices()
    if len(devs) < 8:
        pytest.skip("needs 8 virtual CPU devices")
    return devs[:8]


@pytest.fixture(scope="session")
def gpu():
    """The GPU devices; skips the test when JAX runs on anything else."""
    devs = jax.devices()
    if devs[0].platform != "gpu":
        pytest.skip(f"needs an NVIDIA GPU (JAX runs on {devs[0].platform}); "
                    "run JAX_PLATFORMS=cuda python -m pytest -m gpu tests/")
    return devs
