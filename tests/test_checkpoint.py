"""Checkpoint/resume (SURVEY.md §5.3): restartable streaming runs.

The reference's only resume story is trim_all.py's skip-if-exists; here a
sidecar checkpoint makes an interrupted run restartable mid-file, with
byte-identical final output (valid because the engine is deterministic
and order-preserving at any parallelism)."""

import dataclasses
import io
import os

import pytest

from sickle_tpu import cli, oracle
from sickle_tpu.constants import Compat, QualityType
from sickle_tpu.engine import EngineConfig, iter_record_chunks, run_pe, run_se
from sickle_tpu.engine.checkpoint import (
    TrimCheckpoint,
    progress_saver,
    resume_outputs,
)
from sickle_tpu.oracle import PECounters, SECounters
from sickle_tpu.ops import TrimParams


def params60():
    return TrimParams(qualtype=QualityType.SANGER, qual_threshold=60)


@pytest.fixture(scope="module")
def fixture_bytes(reference_fixtures):
    return (reference_fixtures / "test.fastq").read_bytes()


def _skip_offset(data: bytes, skip: int) -> int:
    offset = 0
    for _ in range(skip * 4):
        offset = data.index(b"\n", offset) + 1
    return offset


def test_chunker_skip_records(fixture_bytes):
    for skip in (0, 1, 128, 300, 2499):
        skipped = b"".join(
            iter_record_chunks(io.BytesIO(fixture_bytes), 128, skip_records=skip)
        )
        assert skipped == fixture_bytes[_skip_offset(fixture_bytes, skip):]
    # skipping everything yields nothing
    assert list(iter_record_chunks(io.BytesIO(fixture_bytes), 128,
                                   skip_records=2500)) == []
    # tiny block size exercises a skip spanning many blocks, and the
    # remainder flowing through exact-size chunking afterwards
    chunks = list(iter_record_chunks(io.BytesIO(fixture_bytes), 64,
                                     block_bytes=97, skip_records=1000))
    assert b"".join(chunks) == fixture_bytes[_skip_offset(fixture_bytes, 1000):]
    assert all(c.count(b"\n") == 64 * 4 for c in chunks[:-1])


def test_engine_resume_midway(fixture_bytes, tmp_path):
    p = params60()
    cfg = EngineConfig(records_per_chunk=256, compat=Compat.FORK)

    golden = io.BytesIO()
    want = run_se(io.BytesIO(fixture_bytes), golden, p, cfg=cfg)

    out_path = str(tmp_path / "out.fastq")
    ck = TrimCheckpoint(str(tmp_path / "ck.json"))

    # first run "crashes" after 3 chunks
    out = open(out_path, "w+b")
    saver = progress_saver(ck, dataclasses.asdict, {out_path: out})
    chunks = {"n": 0}

    def crashing_cb(counters):
        saver(counters)
        chunks["n"] += 1
        if chunks["n"] == 3:
            raise RuntimeError("simulated crash")

    cfg1 = EngineConfig(records_per_chunk=256, compat=Compat.FORK,
                        progress_cb=crashing_cb)
    with pytest.raises(RuntimeError):
        run_se(io.BytesIO(fixture_bytes), out, p, cfg=cfg1)
    # simulate a partially-written post-checkpoint chunk
    out.write(b"GARBAGE-PARTIAL-CHUNK")
    out.close()

    st = ck.load()
    assert st is not None and 0 < st.records_done < 2500

    out = open(out_path, "r+b")
    resume_outputs(st, {out_path: out})
    cfg2 = EngineConfig(
        records_per_chunk=256, compat=Compat.FORK,
        skip_records=st.records_done,
        progress_cb=progress_saver(ck, dataclasses.asdict, {out_path: out}),
    )
    got = run_se(io.BytesIO(fixture_bytes), out, p, cfg=cfg2,
                 counters=SECounters(**st.counters))
    out.close()

    assert open(out_path, "rb").read() == golden.getvalue()
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    # final checkpoint records completion
    assert ck.load().records_done == 2500


def test_engine_resume_pe_two_file(reference_fixtures, tmp_path):
    f1 = (reference_fixtures / "test.f.fastq").read_bytes()
    f2 = (reference_fixtures / "test.r.fastq").read_bytes()
    p = params60()
    cfg = EngineConfig(records_per_chunk=128, compat=Compat.FORK)

    def full():
        o1, o2, so = io.BytesIO(), io.BytesIO(), io.BytesIO()
        c = run_pe(io.BytesIO(f1), io.BytesIO(f2), out1=o1, out2=o2,
                   singles_out=so, params=p, cfg=cfg)
        return (o1.getvalue(), o2.getvalue(), so.getvalue()), c

    (w1, w2, ws), want = full()

    # resume from the halfway point with checkpointed counters
    half_pairs = 600
    cfg_head = EngineConfig(records_per_chunk=128, compat=Compat.FORK)
    o1h, o2h, soh = io.BytesIO(), io.BytesIO(), io.BytesIO()
    # head run: only the first 600 pairs (truncate inputs at the boundary)
    off1 = _skip_offset(f1, half_pairs)
    off2 = _skip_offset(f2, half_pairs)
    c_head = run_pe(io.BytesIO(f1[:off1]), io.BytesIO(f2[:off2]),
                    out1=o1h, out2=o2h, singles_out=soh, params=p,
                    cfg=cfg_head)

    cfg_tail = EngineConfig(records_per_chunk=128, compat=Compat.FORK,
                            skip_records=2 * half_pairs)
    c = run_pe(io.BytesIO(f1), io.BytesIO(f2), out1=o1h, out2=o2h,
               singles_out=soh, params=p, cfg=cfg_tail,
               counters=PECounters(**dataclasses.asdict(c_head)))
    assert (o1h.getvalue(), o2h.getvalue(), soh.getvalue()) == (w1, w2, ws)
    assert dataclasses.asdict(c) == dataclasses.asdict(want)


def test_cli_checkpoint_end_to_end(reference_fixtures, tmp_path, capsys):
    src = str(reference_fixtures / "test.fastq")
    out = str(tmp_path / "o.fastq")
    ckf = str(tmp_path / "ck.json")
    args = ["se", "-f", src, "-t", "sanger", "-q", "60", "-o", out,
            "--checkpoint", ckf, "--compat", "fork"]
    assert cli.main(args) == 0
    first = open(out, "rb").read()
    s1 = capsys.readouterr().out
    assert "FastQ records kept: 2403" in s1
    assert os.path.exists(ckf)

    # re-running a completed run is an idempotent fast no-op with the
    # full-run summary (the resume analog of trim_all's skip-if-exists)
    assert cli.main(args) == 0
    s2 = capsys.readouterr().out
    assert open(out, "rb").read() == first
    assert "FastQ records kept: 2403" in s2


def test_gzip_checkpoint_resume_byte_identical(fixture_bytes, tmp_path):
    """-g + --checkpoint: BgzfWriter flushes whole gzip members at every
    progress callback, so a recorded size is a valid truncation point;
    kill/resume reproduces the straight checkpointed run's .gz bytes
    exactly and the plain run's decompressed bytes."""
    import gzip as _gz

    from sickle_tpu.io import native
    from sickle_tpu.io.compression import BgzfWriter

    if not native.available():
        pytest.skip("needs native BGZF codec")
    p = params60()

    def cfg_with(cb=None):
        return EngineConfig(records_per_chunk=256, compat=Compat.FORK,
                            progress_cb=cb)

    # plain reference output (decompressed golden)
    golden = io.BytesIO()
    want = run_se(io.BytesIO(fixture_bytes), golden, p, cfg=cfg_with())

    # straight checkpointed run (flush-per-chunk block segmentation)
    straight = str(tmp_path / "straight.fastq.gz")
    ck0 = TrimCheckpoint(str(tmp_path / "ck0.json"))
    out = BgzfWriter(straight, resumable=True)
    run_se(io.BytesIO(fixture_bytes), out, p,
           cfg=cfg_with(progress_saver(ck0, dataclasses.asdict,
                                       {straight: out})))
    out.close()

    # crash after 3 chunks, then resume
    out_path = str(tmp_path / "out.fastq.gz")
    ck = TrimCheckpoint(str(tmp_path / "ck.json"))
    out = BgzfWriter(out_path, resumable=True)
    saver = progress_saver(ck, dataclasses.asdict, {out_path: out})
    chunks = {"n": 0}

    def crashing_cb(counters):
        saver(counters)
        chunks["n"] += 1
        if chunks["n"] == 3:
            raise RuntimeError("simulated crash")

    with pytest.raises(RuntimeError):
        run_se(io.BytesIO(fixture_bytes), out, p, cfg=cfg_with(crashing_cb))
    out._f.write(b"GARBAGE-PARTIAL-MEMBER")  # post-checkpoint debris
    out._f.close()

    st = ck.load()
    assert st is not None and 0 < st.records_done < 2500
    out = BgzfWriter(out_path, resumable=True)
    resume_outputs(st, {out_path: out})
    cfg2 = EngineConfig(
        records_per_chunk=256, compat=Compat.FORK,
        skip_records=st.records_done,
        progress_cb=progress_saver(ck, dataclasses.asdict, {out_path: out}),
    )
    got = run_se(io.BytesIO(fixture_bytes), out, p, cfg=cfg2,
                 counters=SECounters(**st.counters))
    out.close()

    resumed = open(out_path, "rb").read()
    assert resumed == open(straight, "rb").read()  # exact .gz bytes
    assert _gz.decompress(resumed) == golden.getvalue()
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


def test_cli_checkpoint_gzip_end_to_end(reference_fixtures, tmp_path, capsys):
    import gzip as _gz

    from sickle_tpu.io import native

    if not native.available():
        pytest.skip("needs native BGZF codec")
    src = str(reference_fixtures / "test.fastq")
    out = str(tmp_path / "o.fastq.gz")
    plain = str(tmp_path / "o.fastq")
    ckf = str(tmp_path / "ck.json")
    assert cli.main(["se", "-f", src, "-t", "sanger", "-q", "60", "-o",
                     plain, "--compat", "fork"]) == 0
    assert cli.main(["se", "-f", src, "-t", "sanger", "-q", "60", "-o", out,
                     "-g", "--checkpoint", ckf, "--compat", "fork"]) == 0
    s1 = capsys.readouterr().out
    assert "FastQ records kept: 2403" in s1
    assert _gz.decompress(open(out, "rb").read()) == open(plain, "rb").read()
    # idempotent completed-run re-run
    assert cli.main(["se", "-f", src, "-t", "sanger", "-q", "60", "-o", out,
                     "-g", "--checkpoint", ckf, "--compat", "fork"]) == 0
    assert _gz.decompress(open(out, "rb").read()) == open(plain, "rb").read()
