"""Native C++ I/O fast path: equivalence with the numpy path.

The native path (io/_fastqio.cpp via ctypes) must produce bit-identical
packs and assemblies.  Skipped if g++ is unavailable.
"""

import numpy as np
import pytest

from sickle_tpu import oracle
from sickle_tpu.constants import Compat, QualityType
from sickle_tpu.io import native
from sickle_tpu.io.fastq import (
    OutputBuffer,
    PackWorkspace,
    assemble_records,
    pack_fastq,
)

pytestmark = pytest.mark.skipif(not native.available(), reason="native lib unavailable")


@pytest.fixture(scope="module")
def data(reference_fixtures):
    return (reference_fixtures / "test.fastq").read_bytes()


def test_native_pack_equivalence(data):
    ws = PackWorkspace()
    a = pack_fastq(data, workspace=ws)
    b = pack_fastq(data)  # numpy path
    assert a.n_records == b.n_records == 2500
    n = a.n_records
    np.testing.assert_array_equal(a.lengths[:n], b.lengths[:n])
    np.testing.assert_array_equal(a.seq[:n, : b.max_len], b.seq[:n])
    np.testing.assert_array_equal(a.qual[:n, : b.max_len], b.qual[:n])
    for f in ("name_start", "name_len", "seq_start", "comment_start",
              "comment_len", "qual_start"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f)


def test_native_pack_workspace_reuse(data):
    ws = PackWorkspace()
    a = pack_fastq(data, workspace=ws)
    first = a.seq[:a.n_records].copy()
    # pack a different, smaller buffer into the same workspace
    small = data[: data.find(b"\n@", 1000) + 1]
    b = pack_fastq(small, workspace=ws)
    assert b.workspace is ws
    # repack the original; must match the first pack exactly
    c = pack_fastq(data, workspace=ws)
    np.testing.assert_array_equal(c.seq[:c.n_records], first)


def test_native_pack_validation_error():
    ws = PackWorkspace()
    bad = b"@ok\nACGT\n+\nIIII\n@r2\nACGT\n+\nIII\n"
    with pytest.raises(oracle.FastqValidationError) as e:
        pack_fastq(bad, workspace=ws)
    assert "different lengths" in e.value.message


def test_native_pack_long_read_retry():
    ws = PackWorkspace()
    small = b"@r1\n" + b"A" * 100 + b"\n+\n" + b"I" * 100 + b"\n"
    pack_fastq(small, workspace=ws)
    assert ws.L == 104  # rounded to len_multiple=8, not a lane multiple:
    # wire bytes and device lanes follow the padded row stride
    big = b"@r2\n" + b"A" * 300 + b"\n+\n" + b"I" * 300 + b"\n"
    p = pack_fastq(big, workspace=ws)
    assert ws.L >= 300
    assert p.lengths[0] == 300
    assert p.seq[0, :300].tobytes() == b"A" * 300


@pytest.mark.parametrize("compat", [Compat.V133, Compat.FORK])
def test_native_assemble_equivalence(data, compat):
    p = pack_fastq(data)
    n = p.n_records
    rng = np.random.default_rng(1)
    five = rng.integers(0, 10, n).astype(np.int64)
    three = rng.integers(50, 150, n).astype(np.int64)
    nmask = rng.random(n) < 0.1
    kwargs = dict(
        name_start=p.name_start, name_len=p.name_len, seq_start=p.seq_start,
        comment_start=p.comment_start, comment_len=p.comment_len,
        qual_start=p.qual_start, five=five, three=three, compat=compat,
        n_record_mask=nmask, qualtype=QualityType.SANGER,
    )
    want = assemble_records(p.data, **kwargs)  # numpy path
    got = assemble_records(p.data, **kwargs, out=OutputBuffer())
    assert bytes(got) == want
