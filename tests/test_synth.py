"""The seeded FASTQ generator every test, smoke run and benchmark reads."""

import io

import numpy as np
import pytest

from sickle_tpu import oracle
from sickle_tpu.constants import QualityType
from sickle_tpu.engine import EngineConfig, run_pe, run_se
from sickle_tpu.engine.hybrid import HybridCutsFn
from sickle_tpu.ops import TrimParams
from sickle_tpu.tools.synth_fastq import (
    BINNED_LEVELS,
    QUAL_OFFSETS,
    main,
    synth_fastq_bytes,
    synth_reads,
)


def test_deterministic_per_seed():
    a = synth_fastq_bytes(3000, seed=7)
    assert a == synth_fastq_bytes(3000, seed=7)
    assert a != synth_fastq_bytes(3000, seed=8)
    assert a != synth_fastq_bytes(3000, seed=7, mate=2)
    # the same reads as row matrices and as FASTQ text
    seq, qual, lens = synth_reads(3000, seed=7)
    recs = oracle.parse_fastq_bytes(a)
    assert len(recs) == 3000
    for r in (0, 1, 1234, 2999):
        assert recs[r].seq == seq[r, :lens[r]].tobytes()
        assert recs[r].qual == qual[r, :lens[r]].tobytes()


def test_read_model_shape():
    """150 bp, ~10% adapter-trimmed to 30-149, quality decaying 5'->3',
    ~0.1% N plus N-rich reads, N bases at quality 2."""
    seq, qual, lens = synth_reads(40_000, seed=3)
    assert lens.max() == 150 and lens.min() >= 30
    assert 0.08 < np.mean(lens < 150) < 0.12
    assert (qual[lens == 150] > 0).all()  # full-length rows are filled
    full = qual[lens == 150].astype(np.int32) - 33
    head, tail = full[:, :10].mean(), full[:, 140:].mean()
    assert 32 < head < 38 and tail < head - 5
    in_read = np.arange(150)[None, :] < lens[:, None]
    n_frac = (seq[in_read] == ord("N")).mean()
    assert 0.0005 < n_frac < 0.002
    assert ((seq == ord("N")).sum(axis=1) > 15).sum() > 20  # N-rich reads
    assert set(np.unique(qual[seq == ord("N")])) == {33 + 2}
    assert not qual[~in_read].any() and not seq[~in_read].any()


@pytest.mark.parametrize("qual_type", sorted(QUAL_OFFSETS))
def test_offsets_and_binned_levels(qual_type):
    _, qual, lens = synth_reads(5000, seed=5, binned=True,
                                qual_type=qual_type)
    chars = np.unique(qual[qual > 0])
    off = QUAL_OFFSETS[qual_type]
    assert set(chars) <= {off + q for q in BINNED_LEVELS}
    assert len(chars) == 4


@pytest.mark.parametrize("qual_type,binned", [
    ("sanger", False), ("illumina", False), ("solexa", False),
    ("sanger", True),
])
def test_engine_agrees_with_oracle(qual_type, binned):
    """Generated reads trim byte-identically through the engine's device
    step, the C++ host kernel and the scalar oracle."""
    qt = {"sanger": QualityType.SANGER, "illumina": QualityType.ILLUMINA,
          "solexa": QualityType.SOLEXA}[qual_type]
    data = synth_fastq_bytes(3000, seed=9, qual_type=qual_type,
                             binned=binned)
    params = TrimParams(qualtype=qt, qual_threshold=30, length_threshold=50)
    want, wc = oracle.trim_se(data, qualtype=qt, qual_threshold=30,
                              length_threshold=50)
    assert 0 < wc.discarded and wc.kept > 2000
    for cuts_fn in (None, HybridCutsFn(params, None)):
        out = io.BytesIO()
        c = run_se(io.BytesIO(data), out, params,
                   cfg=EngineConfig(records_per_chunk=1024), cuts_fn=cuts_fn)
        assert out.getvalue() == want
        assert (c.kept, c.discarded) == (wc.kept, wc.discarded)


def test_cli_writes_paired_mates(tmp_path):
    r1, r2 = tmp_path / "r1.fastq", tmp_path / "r2.fastq"
    rc = tmp_path / "pairs.fastq"
    assert main(["-n", "1500", "--seed", "4", "-o", str(r1),
                 "-p", str(r2), "-c", str(rc)]) == 0
    d1, d2 = r1.read_bytes(), r2.read_bytes()
    l1, l2 = d1.split(b"\n"), d2.split(b"\n")
    assert rc.read_bytes() == b"".join(
        b"\n".join(l1[i:i + 4] + l2[i:i + 4]) + b"\n"
        for i in range(0, 4 * 1500, 4))
    a, b = oracle.parse_fastq_bytes(d1), oracle.parse_fastq_bytes(d2)
    assert len(a) == len(b) == 1500
    assert all(x.name.split()[0] == y.name.split()[0] for x, y in zip(a, b))
    assert a[0].name.endswith(b" 1:N:0:1") and b[0].name.endswith(b" 2:N:0:1")
    params = TrimParams(qualtype=QualityType.SANGER, qual_threshold=30)
    o1, o2, so = io.BytesIO(), io.BytesIO(), io.BytesIO()
    run_pe(io.BytesIO(d1), io.BytesIO(d2), out1=o1, out2=o2, singles_out=so,
           params=params, cfg=EngineConfig(records_per_chunk=512))
    w1, w2, ws, _ = oracle.trim_pe(d1, d2, qualtype=QualityType.SANGER,
                                   qual_threshold=30)
    assert (o1.getvalue(), o2.getvalue(), so.getvalue()) == (w1, w2, ws)
