"""Engine pipeline tests: multi-chunk streaming, determinism, sharding.

The reference's output depends on thread count and races (SURVEY.md
§2.4.3/§2.4.5); ours must be byte-identical at ANY chunk size and ANY
device count (8 virtual CPU devices here).
"""

import io

import numpy as np
import pytest

from sickle_tpu import oracle
from sickle_tpu.constants import Compat, QualityType
from sickle_tpu.engine import EngineConfig, iter_record_chunks, run_pe, run_se
from sickle_tpu.ops import TrimParams
from sickle_tpu.tools.synth_fastq import synth_fastq_bytes


def params60():
    return TrimParams(qualtype=QualityType.SANGER, qual_threshold=60, compat=Compat.FORK)


@pytest.fixture(scope="module")
def fixture_bytes():
    # 2,500 seeded reads written at the +64 offset: read as sanger they
    # span Q33-Q72, so the q=60 threshold trims most reads somewhere
    return synth_fastq_bytes(2500, seed=1, qual_type="illumina")


def se_run(data, rpc, cuts_fn=None, compat=Compat.FORK):
    out = io.BytesIO()
    c = run_se(
        io.BytesIO(data), out, params60(),
        cfg=EngineConfig(records_per_chunk=rpc, compat=compat),
        cuts_fn=cuts_fn,
    )
    return out.getvalue(), c


def test_chunker_exact_alignment(fixture_bytes):
    chunks = list(iter_record_chunks(io.BytesIO(fixture_bytes), 256))
    assert b"".join(chunks) == fixture_bytes
    for c in chunks[:-1]:
        assert c.count(b"\n") == 256 * 4
    # block boundary sweep: tiny blocks must not change chunking
    chunks2 = list(
        iter_record_chunks(io.BytesIO(fixture_bytes), 256, block_bytes=1000)
    )
    assert chunks2 == chunks


@pytest.mark.parametrize("rpc", [64, 256, 1024, 4096])
def test_se_chunk_size_invariance(fixture_bytes, rpc):
    want, cw = oracle.trim_se(
        fixture_bytes, qualtype=QualityType.SANGER, qual_threshold=60,
        compat=Compat.FORK,
    )
    got, c = se_run(fixture_bytes, rpc)
    assert got == want
    assert (c.total, c.kept, c.discarded) == (cw.total, cw.kept, cw.discarded)


def test_se_sharded_8_devices(fixture_bytes):
    import jax

    if len(jax.devices()) < 8:
        pytest.skip("needs 8 (virtual) devices")
    from sickle_tpu.parallel import data_mesh, sharded_cuts_fn

    mesh = data_mesh(8)
    fn = sharded_cuts_fn(params60(), mesh)
    want, _ = se_run(fixture_bytes, 1024)
    got, _ = se_run(fixture_bytes, 1024, cuts_fn=fn)
    assert got == want


def test_se_sharded_3_devices_pads(fixture_bytes):
    """A mesh size that does not divide the padded batch (3 devices,
    power-of-two batches) must still work: the sharded fn pads rows to a
    mesh multiple and slices results back."""
    import jax

    if len(jax.devices()) < 3:
        pytest.skip("needs 3 (virtual) devices")
    from sickle_tpu.parallel import data_mesh, sharded_cuts_fn

    fn = sharded_cuts_fn(params60(), data_mesh(3))
    want, _ = se_run(fixture_bytes, 1024)
    got, _ = se_run(fixture_bytes, 1024, cuts_fn=fn)
    assert got == want


def test_pe_two_file_multichunk(reference_fixtures):
    d1 = (reference_fixtures / "test.f.fastq").read_bytes()
    d2 = (reference_fixtures / "test.r.fastq").read_bytes()
    w1, w2, ws, wc = oracle.trim_pe(
        d1, d2, qualtype=QualityType.SANGER, qual_threshold=60, compat=Compat.FORK
    )
    o1, o2, s = io.BytesIO(), io.BytesIO(), io.BytesIO()
    c = run_pe(
        io.BytesIO(d1), io.BytesIO(d2),
        out1=o1, out2=o2, singles_out=s,
        params=params60(),
        cfg=EngineConfig(records_per_chunk=128, compat=Compat.FORK),
    )
    assert o1.getvalue() == w1
    assert o2.getvalue() == w2
    assert s.getvalue() == ws
    assert (c.kept_p, c.kept_s1, c.kept_s2, c.discard_p) == (
        wc.kept_p, wc.kept_s1, wc.kept_s2, wc.discard_p,
    )
    assert c.total == 2500


def test_pe_interleaved_M_multichunk(fixture_bytes):
    want, _, _, wc = oracle.trim_pe(
        fixture_bytes, interleaved=True, qualtype=QualityType.SANGER,
        qual_threshold=60, n_record_mode=True, compat=Compat.FORK,
    )
    o1 = io.BytesIO()
    c = run_pe(
        io.BytesIO(fixture_bytes), None, interleaved=True,
        out1=o1, n_record_mode=True,
        params=params60(),
        cfg=EngineConfig(records_per_chunk=128, compat=Compat.FORK),
    )
    assert o1.getvalue() == want
    assert c.discard_p == wc.discard_p


def test_tpu_step_matches_reference_path(fixture_bytes):
    """The engine's device step (device-derived lengths + encoded
    results) must agree with the plain kernel; runs on CPU (the step is
    the same on every backend)."""
    from sickle_tpu.engine.pipeline import _materialize, _device_cuts_fn
    from sickle_tpu.io import pack_fastq
    from sickle_tpu.ops import compute_cuts_jit

    p = pack_fastq(fixture_bytes, batch_multiple=256)
    for trunc_n in (False, True):
        params = TrimParams(
            qualtype=QualityType.SANGER, qual_threshold=60,
            trunc_n=trunc_n, compat=Compat.FORK,
        )
        fn = _device_cuts_fn(params)
        got = _materialize(fn(p.seq, p.qual, p.lengths), p.n_records)
        want = _materialize(
            compute_cuts_jit(p.seq, p.qual, p.lengths, params), p.n_records
        )
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])

    # NUL byte inside a read -> explicit-lengths fallback (not truncation):
    # the kernel must flag the row as a quality violation
    qual2 = p.qual.copy()
    qual2[5, 10] = 0
    params = TrimParams(qualtype=QualityType.SANGER, qual_threshold=60)
    fn = _device_cuts_fn(params)
    f, t, bad = _materialize(fn(p.seq, qual2, p.lengths), p.n_records)
    assert bad[5] < p.lengths[5]


def test_materialize_encoded_roundtrip():
    """The device step's packed int32 encoding ((five+1)<<16 | badbit<<15 |
    (three+1)) and the long-read [3, B] stack both decode to the tuple
    contract."""
    from sickle_tpu.engine.pipeline import _materialize
    from sickle_tpu.ops.trim import BIG

    rng = np.random.default_rng(3)
    B = 64
    five = rng.integers(-1, 200, B).astype(np.int32)
    three = rng.integers(-1, 32765, B).astype(np.int32)
    discard = rng.random(B) < 0.3
    five[discard] = -1
    three[discard] = -1
    five[~discard] = np.abs(five[~discard])
    flag = (rng.random(B) < 0.2).astype(np.int32)
    codes = ((three + 1) | (flag << 15) | ((five + 1) << 16)).astype(np.int32)
    f, t, bad = _materialize(codes, B)
    np.testing.assert_array_equal(f, five)
    np.testing.assert_array_equal(t, three)
    np.testing.assert_array_equal(bad == 0, flag == 1)
    assert ((bad == 0) | (bad == BIG)).all()

    wide = np.stack([five, three, flag])  # long-read unpacked result
    f, t, bad = _materialize(wide, B)
    np.testing.assert_array_equal(f, five)
    np.testing.assert_array_equal(t, three)
    np.testing.assert_array_equal(bad == 0, flag == 1)


def test_quality_error_mid_stream():
    rec = b"@r%d\n" + b"A" * 40 + b"\n+\n" + b"I" * 40 + b"\n"
    good = b"".join(rec % i for i in range(300))
    bad = b"@rbad\n" + b"A" * 40 + b"\n+\n" + b"I" * 20 + b"\x1f" + b"I" * 19 + b"\n"
    data = good + bad + b"".join(rec % (1000 + i) for i in range(300))
    with pytest.raises(oracle.QualityRangeError) as e:
        se_run(data, 64)
    assert "@rbad" in e.value.message
    assert "Quality position: 21" in e.value.message


def test_validation_error_mid_stream():
    rec = b"@r%d\n" + b"A" * 40 + b"\n+\n" + b"I" * 40 + b"\n"
    good = b"".join(rec % i for i in range(200))
    bad = b"@rx\n" + b"A" * 40 + b"\n+\n" + b"I" * 39 + b"\n"
    with pytest.raises(oracle.FastqValidationError) as e:
        se_run(good + bad, 64)
    assert "different lengths" in e.value.message


def test_sliced_device_cuts_fn_matches_oracle(fixture_bytes):
    """The sliced device step (built by _device_cuts_fn) must produce
    byte-identical output to the default path at any slice size,
    including ragged last chunks, -n (stacked seq+qual transfer), and the
    explicit-lengths fallback.  Runs on CPU: the step is the same on
    every backend."""
    from sickle_tpu.engine.pipeline import _device_cuts_fn

    data = fixture_bytes[: fixture_bytes.find(b"\n@", 4 * 80 * 600)]
    p = params60()
    want, cw = se_run(data, 256)
    for slice_rows, inflight in ((8, 2), (64, 1), (256, 4)):
        fn = _device_cuts_fn(p, slice_rows=slice_rows, inflight=inflight)
        cfg = EngineConfig(records_per_chunk=256, compat=Compat.FORK,
                           slice_rows=slice_rows, inflight=inflight)
        out = io.BytesIO()
        c = run_se(io.BytesIO(data), out, p, cfg=cfg, cuts_fn=fn)
        assert out.getvalue() == want
        assert (c.total, c.kept, c.discarded) == (cw.total, cw.kept, cw.discarded)


def test_sliced_device_cuts_fn_trunc_n_and_badqual():
    from sickle_tpu.engine.pipeline import _device_cuts_fn

    p = TrimParams(qualtype=QualityType.SANGER, qual_threshold=30,
                   trunc_n=True, compat=Compat.FORK)
    rec = b"@r%d\nACGTNACGTACGTACGTACGTACGTACGTACGT\n+\n" + b"I" * 33 + b"\n"
    data = b"".join(rec % i for i in range(100))
    fn = _device_cuts_fn(p, slice_rows=16, inflight=2)
    cfg = EngineConfig(records_per_chunk=64, slice_rows=16, compat=Compat.FORK)
    out = io.BytesIO()
    run_se(io.BytesIO(data), out, p, cfg=cfg, cuts_fn=fn)
    ref = io.BytesIO()
    run_se(io.BytesIO(data), ref, p, cfg=EngineConfig(records_per_chunk=64))
    assert out.getvalue() == ref.getvalue()

    # quality error flagged through the sliced encoding, exact message
    # (bad char inside the touched region: the scan reaches position 20
    # because quality never rises to the threshold before it)
    urec = b"@q\nACGTNACGTACGTACGTACGTACGTACGTACGT\n+\n" + b"I" * 33 + b"\n"
    badrec = (b"@rbad\n" + b"A" * 33 + b"\n+\n"
              + b"I" * 20 + b"\x1f" + b"I" * 12 + b"\n")
    bad = urec * 20 + badrec + urec * 20
    with pytest.raises(oracle.QualityRangeError) as e:
        out = io.BytesIO()
        run_se(io.BytesIO(bad), out, p, cfg=cfg, cuts_fn=fn)
    assert "@rbad" in e.value.message


def test_touched_only_quality_vs_strict():
    """Reference parity on dirty data (src/trim.cpp:66-73): a junk quality
    char past the 3' break — or in a read discarded by the upfront length
    filter — trims fine by default, but errors under --strict."""
    from sickle_tpu.engine.pipeline import _device_cuts_fn

    good = b"@g%d\n" + b"A" * 40 + b"\n+\n" + b"I" * 40 + b"\n"
    # 3' break early: high head, low middle => scan stops; tail junk unread
    dirty_tail = (b"@dirty\n" + b"A" * 40 + b"\n+\n"
                  + b"I" * 10 + b"#" * 20 + b"\x7f" * 10 + b"\n")
    # shorter than the length threshold: discarded before any decode
    dirty_short = b"@short\nACGT\n+\n\x1f\x1f\x1f\x1f\n"
    data = (b"".join(good % i for i in range(20)) + dirty_tail + dirty_short
            + b"".join(good % (99 + i) for i in range(20)))

    def drive(params):
        out = io.BytesIO()
        cfg = EngineConfig(records_per_chunk=16, slice_rows=8,
                           compat=Compat.FORK)
        fn = _device_cuts_fn(params, slice_rows=8, inflight=2)
        c = run_se(io.BytesIO(data), out, params, cfg=cfg, cuts_fn=fn)
        return out.getvalue(), c

    lax = TrimParams(qualtype=QualityType.SANGER, qual_threshold=30,
                     length_threshold=5, compat=Compat.FORK)
    got, c = drive(lax)
    assert c.total == 42
    # the dirty-tail read is kept, trimmed at the 3' break like sickle 1.33
    assert b"@dirty\nAAAAAAAAAA\n" in got

    import dataclasses

    with pytest.raises(oracle.QualityRangeError) as e:
        drive(dataclasses.replace(lax, strict=True))
    assert "@dirty" in e.value.message


def test_long_reads_end_to_end_tpu_path(tmp_path):
    """A 40 kbp-read FASTQ (ONT/PacBio scale) must trim byte-identically
    to the oracle through the device step: the packed int32 encoding
    does not fit (three+1) at L >= 32766, so the engine switches to the
    unpacked device result, and EngineConfig.bytes_per_batch shrinks the
    chunk so padded batches stay bounded (the reference is
    length-agnostic, src/trim.cpp:8-34)."""
    from sickle_tpu.engine.pipeline import _mmap_input, _device_cuts_fn

    rng = np.random.default_rng(7)
    recs = []
    for i in range(24):
        L = 40_000 + (i * 131) % 997
        if i % 4 == 0:  # high head, junk tail: 3' cut mid-read
            q = np.full(L, 33 + 70, np.uint8)
            q[L // 2 :] = 33 + 2
        elif i % 4 == 1:  # short low reads mixed in
            L = 50
            q = np.full(L, 33 + 2, np.uint8)
        else:
            q = rng.integers(33 + 55, 33 + 70, L).astype(np.uint8)
        seq = rng.choice(list(b"ACGT"), L).astype(np.uint8)
        recs.append(b"@r%d\n%s\n+\n%s\n" % (i, seq.tobytes(), q.tobytes()))
    data = b"".join(recs)

    p = TrimParams(qualtype=QualityType.SANGER, qual_threshold=60,
                   compat=Compat.FORK)
    want, cw = oracle.trim_se(data, qualtype=QualityType.SANGER,
                              qual_threshold=60, compat=Compat.FORK)

    fn = _device_cuts_fn(p, slice_rows=32768, inflight=2)
    cfg = EngineConfig(records_per_chunk=1 << 16, compat=Compat.FORK,
                       bytes_per_batch=1 << 20)  # forces tiny row chunks
    fpath = tmp_path / "long.fastq"
    fpath.write_bytes(data)
    out = io.BytesIO()
    with open(fpath, "rb") as fin:
        assert _mmap_input(fin) is not None
        c = run_se(fin, out, p, cfg=cfg, cuts_fn=fn)
    assert out.getvalue() == want
    assert (c.total, c.kept, c.discarded) == (cw.total, cw.kept, cw.discarded)

    # the in-memory (chunked-stream) path takes the same byte cap
    out2 = io.BytesIO()
    c2 = run_se(io.BytesIO(data), out2, p, cfg=cfg, cuts_fn=fn)
    assert out2.getvalue() == want and c2.total == cw.total


def _file_stream(tmp_path, data, name="in.fastq"):
    p = tmp_path / name
    p.write_bytes(data)
    return open(p, "rb")


@pytest.mark.parametrize("tail", [b"", b"@tail\nACGT\n", None])
def test_se_mmap_path_matches_stream_path(fixture_bytes, tmp_path, tail):
    """Plain-file inputs take the zero-copy mmap producer; bytes and
    counters must equal the chunked in-memory path, including a trailing
    partial record (tail lines) and an unterminated final line (None)."""
    from sickle_tpu.engine.pipeline import _mmap_input

    data = fixture_bytes[:-1] if tail is None else fixture_bytes + tail
    want, cw = se_run(data, 512)
    out = io.BytesIO()
    with _file_stream(tmp_path, data) as fin:
        assert _mmap_input(fin) is not None  # fast path engages
        c = run_se(fin, out, params60(),
                   cfg=EngineConfig(records_per_chunk=512, compat=Compat.FORK))
    assert out.getvalue() == want
    assert (c.total, c.kept, c.discarded) == (cw.total, cw.kept, cw.discarded)


@pytest.mark.parametrize("skip", [4, 2496, 2500])
def test_se_mmap_resume_matches(fixture_bytes, tmp_path, skip):
    cfg = lambda: EngineConfig(records_per_chunk=512, compat=Compat.FORK,
                               skip_records=skip)
    want = io.BytesIO()
    cw = run_se(io.BytesIO(fixture_bytes), want, params60(), cfg=cfg())
    out = io.BytesIO()
    with _file_stream(tmp_path, fixture_bytes) as fin:
        c = run_se(fin, out, params60(), cfg=cfg())
    assert out.getvalue() == want.getvalue()
    assert (c.total, c.kept) == (cw.total, cw.kept)


def test_pe_interleaved_mmap_matches(fixture_bytes, tmp_path):
    def go(fin):
        out1, outs = io.BytesIO(), io.BytesIO()
        c = run_pe(fin, None, interleaved=True, out1=out1, singles_out=outs,
                   params=params60(),
                   cfg=EngineConfig(records_per_chunk=512, compat=Compat.FORK))
        return out1.getvalue(), outs.getvalue(), (c.total, c.kept_p, c.kept_s1,
                                                  c.kept_s2, c.discard_p)

    with _file_stream(tmp_path, fixture_bytes) as fin:
        got = go(fin)
    assert got == go(io.BytesIO(fixture_bytes))


def test_pe_two_file_mmap_matches(reference_fixtures, tmp_path):
    """Two-file pe via the zero-copy mmap producer (split mate batches,
    two-source singles assembly) must match the in-memory chunked path
    byte-for-byte, including resume and whole-record length mismatch."""
    f1 = (reference_fixtures / "test.f.fastq").read_bytes()
    f2 = (reference_fixtures / "test.r.fastq").read_bytes()

    def go(as_file, skip=0, d2=f2):
        o1, o2, so = io.BytesIO(), io.BytesIO(), io.BytesIO()
        cfg = EngineConfig(records_per_chunk=256, compat=Compat.FORK,
                           skip_records=skip)
        if as_file:
            (tmp_path / "a").write_bytes(f1)
            (tmp_path / "b").write_bytes(d2)
            with open(tmp_path / "a", "rb") as a, open(tmp_path / "b", "rb") as b:
                c = run_pe(a, b, out1=o1, out2=o2, singles_out=so,
                           params=params60(), cfg=cfg)
        else:
            c = run_pe(io.BytesIO(f1), io.BytesIO(d2), out1=o1, out2=o2,
                       singles_out=so, params=params60(), cfg=cfg)
        return (o1.getvalue(), o2.getvalue(), so.getvalue(),
                (c.total, c.kept_p, c.kept_s1, c.kept_s2, c.discard_p))

    assert go(True) == go(False)
    assert go(True, skip=100) == go(False, skip=100)

    short = b"\n".join(f2.split(b"\n")[: 600 * 4]) + b"\n"
    with pytest.raises(oracle.FastqValidationError) as e:
        go(True, d2=short)
    assert e.value.message == "Batch2 and Batch1 have different lengths, exiting"


def test_metrics_per_chunk_rows(fixture_bytes):
    """--metrics instrumentation: one aligned row per chunk per stage,
    correct record/byte totals, lazy-window path included (SURVEY §5.1)."""
    from sickle_tpu.engine.pipeline import _device_cuts_fn
    from sickle_tpu.utils.metrics import Metrics

    p = params60()
    m = Metrics()
    fn = _device_cuts_fn(p, slice_rows=256, inflight=2)  # lazy dispatch path
    cfg = EngineConfig(records_per_chunk=512, compat=Compat.FORK,
                       slice_rows=256, metrics=m)
    out = io.BytesIO()
    c = run_se(io.BytesIO(fixture_bytes), out, p, cfg=cfg, cuts_fn=fn)
    n_chunks = -(-c.total // 512)
    assert m.n_chunks == n_chunks
    assert len(m.dispatch_ms) == n_chunks
    assert len(m.fetch_ms) == n_chunks
    assert len(m.consume_ms) == n_chunks
    assert sum(m.records) == c.total == 2500
    assert sum(m.in_bytes) == len(fixture_bytes)
    assert sum(m.out_bytes) == len(out.getvalue())
    assert sum(m.h2d_bytes) > 0
    s = m.summary()
    assert s["chunks"] == n_chunks and s["stalled"] is False
    import io as _sio
    buf = _sio.StringIO()
    m.report(buf)
    assert "metrics:" in buf.getvalue()


def test_metrics_stall_detection():
    """A single outlier chunk flags the pass; uniform slowness does not."""
    from sickle_tpu.utils.metrics import Metrics

    m = Metrics()
    for _ in range(9):
        m.dispatch_ms.append(10.0)
        m.fetch_ms.append(5.0)
    m.dispatch_ms.append(9000.0)
    m.fetch_ms.append(5.0)
    assert m.stalled()
    m2 = Metrics()
    for _ in range(10):  # uniformly slow = honest throughput, not a stall
        m2.dispatch_ms.append(3000.0)
        m2.fetch_ms.append(1000.0)
    assert not m2.stalled()


def test_sharded_fn_qual_only_and_packed_result(fixture_bytes):
    """--devices N runs the same device step: without -n the sharded fn
    never touches `seq` (qual-only H2D proves it: seq=None works) and D2H
    is the packed one-int32-per-read code."""
    import jax

    if len(jax.devices()) < 8:
        pytest.skip("needs 8 (virtual) devices")
    from sickle_tpu.engine.pipeline import _PendingCuts, _materialize
    from sickle_tpu.io.fastq import pack_fastq
    from sickle_tpu.ops import compute_cuts_jit
    from sickle_tpu.parallel import data_mesh, sharded_cuts_fn

    p = params60()
    fn = sharded_cuts_fn(p, data_mesh(8), slice_rows=512)
    packed = pack_fastq(fixture_bytes, batch_multiple=512, need_seq=False)
    assert packed.qual_clean
    res = fn(None, packed.qual, packed.lengths, qual_clean=True)
    assert isinstance(res, _PendingCuts)
    for f in res.futs:
        assert f.ndim == 1 and f.dtype == np.int32  # 4 B/read, sharded
    five, three, bad = _materialize(res, packed.n_records)
    fw, tw, bw = (np.asarray(x) for x in compute_cuts_jit(
        packed.qual, packed.qual, packed.lengths, p))
    n = packed.n_records
    np.testing.assert_array_equal(five, fw[:n])
    np.testing.assert_array_equal(three, tw[:n])
