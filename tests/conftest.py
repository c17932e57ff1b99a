"""Test configuration.

Device-kernel tests run on a virtual 8-device CPU mesh so sharding paths
are exercised without an accelerator: the flag must be in XLA_FLAGS
before JAX initializes its backends.  Set SICKLE_TPU_TEST_REAL_DEVICE=1
to run on whatever JAX would pick by default instead.

Inputs come from the seeded generator (sickle_tpu.tools.synth_fastq);
only the golden tests against the reference fork's own fixture files
need ``reference_fixtures``, and skip where those files are absent.
"""

import os

if not os.environ.get("SICKLE_TPU_TEST_REAL_DEVICE"):
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8"
        ).strip()
    os.environ["JAX_PLATFORMS"] = "cpu"

import pathlib

import pytest

from sickle_tpu.tools.synth_fastq import write_fastq

# the reference fork's test directory (test.fastq, test.f.fastq, ...),
# where a checkout of it is at hand
REFERENCE_TEST_DIR = os.environ.get("SICKLE_REFERENCE_TEST_DIR", "")

# generated corpora: (file name, reads, seed, mate)
SYNTH_FILES = (
    ("se.fastq", 2500, 1, 1),
    ("r1.fastq", 1250, 2, 1),
    ("r2.fastq", 1250, 2, 2),
)


@pytest.fixture(scope="session")
def reference_fixtures():
    """Path to the reference fork's FASTQ fixtures; skip if unavailable."""
    if not REFERENCE_TEST_DIR or not os.path.isdir(REFERENCE_TEST_DIR):
        pytest.skip("reference fixtures not available")
    return pathlib.Path(REFERENCE_TEST_DIR)


@pytest.fixture(scope="session")
def synth_dir(tmp_path_factory):
    """A directory of seeded FASTQ files: ``se.fastq`` (2,500 reads) and
    the mate files ``r1.fastq``/``r2.fastq`` (1,250 pairs)."""
    d = tmp_path_factory.mktemp("synth")
    for name, n, seed, mate in SYNTH_FILES:
        with open(d / name, "wb") as f:
            write_fastq(f, n, seed=seed, mate=mate)
    return d
