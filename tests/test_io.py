"""Host I/O layer tests: pack/assemble roundtrips, validation parity, gzip."""

import gzip
import numpy as np
import pytest

from sickle_tpu import oracle
from sickle_tpu.constants import Compat, QualityType
from sickle_tpu.io import assemble_records, pack_fastq, read_fastq_bytes
from sickle_tpu.io.compression import GzipChunkWriter, open_input


def full_passthrough(data: bytes) -> bytes:
    """Assemble with no trimming; FORK compat keeps comments verbatim."""
    p = pack_fastq(data)
    n = p.n_records
    lens = p.lengths[:n].astype(np.int64)
    return assemble_records(
        p.data,
        name_start=p.name_start,
        name_len=p.name_len,
        seq_start=p.seq_start,
        comment_start=p.comment_start,
        comment_len=p.comment_len,
        qual_start=p.qual_start,
        five=np.zeros(n, np.int64),
        three=lens,
        compat=Compat.FORK,
    )


def test_roundtrip_fixture(reference_fixtures):
    data = (reference_fixtures / "test.fastq").read_bytes()
    assert full_passthrough(data) == data


def test_roundtrip_unterminated_final_line():
    data = b"@r1\nACGT\n+\nIIII"  # no trailing newline
    assert full_passthrough(data) == data + b"\n"


def test_trailing_partial_record_ignored():
    data = b"@r1\nACGT\n+\nIIII\n@r2\nACGT\n"
    p = pack_fastq(data)
    assert p.n_records == 1


def test_pack_matches_scalar_parse(reference_fixtures):
    data = (reference_fixtures / "test.fastq").read_bytes()
    p = pack_fastq(data)
    recs = oracle.parse_fastq_bytes(data)
    assert p.n_records == len(recs)
    for i in [0, 1, 1249, 2499]:
        r = recs[i]
        L = p.lengths[i]
        assert p.seq[i, :L].tobytes() == r.seq
        assert p.qual[i, :L].tobytes() == r.qual
        arr = p.data
        assert arr[p.name_start[i] : p.name_start[i] + p.name_len[i]].tobytes() == r.name
        assert p.positions[i] == r.position


@pytest.mark.parametrize(
    "bad,msg",
    [
        (b"@\nACGT\n+\nIIII\n", "Sequence ID is to short"),
        (b"r1x\nACGT\n+\nIIII\n", "Invalid char at the beggining of ID"),
        (b"@r1\n\n+\nIIII\n", "Sequence line is empty"),
        (b"@r1\nACGT\n+\n\n", "Quality line is empty"),
        (b"@r1\nACGT\n+\nIII\n", "different lengths"),
    ],
)
def test_validation_messages(bad, msg):
    with pytest.raises(oracle.FastqValidationError) as e:
        pack_fastq(b"@ok\nACGT\n+\nIIII\n" + bad)
    assert msg in e.value.message


def test_validation_first_offender_position():
    data = b"@ok\nACGT\n+\nIIII\n@\nAC\n+\nII\n@\nA\n+\nI\n"
    with pytest.raises(oracle.FastqValidationError) as e:
        pack_fastq(data)
    assert "line 4" in e.value.message  # record 2 -> (2*4)-4 = 4


def test_comment_rewrite_v133():
    data = b"@r1\nACGTACGTACGT\n+r1 some comment\nIIIIIIIIIIII\n"
    p = pack_fastq(data)
    out = assemble_records(
        p.data,
        name_start=p.name_start,
        name_len=p.name_len,
        seq_start=p.seq_start,
        comment_start=p.comment_start,
        comment_len=p.comment_len,
        qual_start=p.qual_start,
        five=np.array([2]),
        three=np.array([10]),
        compat=Compat.V133,
    )
    assert out == b"@r1\nGTACGTAC\n+\nIIIIIIII\n"


def test_n_record_assembly():
    data = b"@r1\nACGT\n+\nIIII\n@r2\nACGT\n+\nIIII\n"
    p = pack_fastq(data)
    out = assemble_records(
        p.data,
        name_start=p.name_start,
        name_len=p.name_len,
        seq_start=p.seq_start,
        comment_start=p.comment_start,
        comment_len=p.comment_len,
        qual_start=p.qual_start,
        five=np.array([0, 0]),
        three=np.array([4, 0]),
        compat=Compat.V133,
        n_record_mask=np.array([False, True]),
        qualtype=QualityType.SANGER,
    )
    assert out == b"@r1\nACGT\n+\nIIII\n@r2\nN\n+\n!\n"  # '!' = sanger min 33


def test_gzip_roundtrip(tmp_path, reference_fixtures):
    data = (reference_fixtures / "test.fastq").read_bytes()
    gz = tmp_path / "in.fastq.gz"
    gz.write_bytes(gzip.compress(data))
    assert read_fastq_bytes(gz) == data
    assert read_fastq_bytes(reference_fixtures / "test.fastq") == data

    # output writer: standard gzip readers must decode our stream exactly
    out = tmp_path / "out.fastq.gz"
    w = GzipChunkWriter(out)
    for i in range(0, len(data), 1 << 16):
        w.write(data[i : i + (1 << 16)])
    w.close()
    assert gzip.decompress(out.read_bytes()) == data
    with open_input(out) as f:
        assert f.read() == data


def test_empty_input():
    p = pack_fastq(b"")
    assert p.n_records == 0
    assert p.seq.shape[0] >= 1  # padded minimum batch


def test_bgzf_writer_reader_roundtrip(tmp_path, reference_fixtures):
    """-g output is BGZF: any gzip reader decodes it byte-exactly, our
    parallel block reader round-trips it, and block boundaries never
    split reads incorrectly (block size 48 KiB is not record-aligned)."""
    from sickle_tpu.io import native
    from sickle_tpu.io.compression import BgzfReader, BgzfWriter

    if not native.available():
        pytest.skip("native lib unavailable")
    data = (reference_fixtures / "test.fastq").read_bytes() * 5
    out = tmp_path / "out.fastq.gz"
    w = BgzfWriter(out)
    for i in range(0, len(data), 100_001):  # odd write sizes
        w.write(data[i : i + 100_001])
    w.close()
    assert gzip.decompress(out.read_bytes()) == data
    r = BgzfReader.try_open(out)
    assert r is not None
    chunks = []
    while True:
        c = r.read(777_777)
        if not c:
            break
        chunks.append(c)
    assert b"".join(chunks) == data
    # open_input picks the parallel reader for BGZF files
    with open_input(out) as f:
        assert isinstance(f, BgzfReader)
        assert f.read() == data


def test_bgzf_reader_rejects_plain_gzip(tmp_path, reference_fixtures):
    from sickle_tpu.io import native
    from sickle_tpu.io.compression import BgzfReader

    if not native.available():
        pytest.skip("native lib unavailable")
    data = (reference_fixtures / "test.fastq").read_bytes()
    gz = tmp_path / "plain.fastq.gz"
    gz.write_bytes(gzip.compress(data))
    assert BgzfReader.try_open(gz) is None  # falls back to serial stream
    with open_input(gz) as f:
        assert f.read() == data


def test_bgzf_empty_and_tiny(tmp_path):
    from sickle_tpu.io import native
    from sickle_tpu.io.compression import BgzfReader, BgzfWriter

    if not native.available():
        pytest.skip("native lib unavailable")
    out = tmp_path / "empty.gz"
    w = BgzfWriter(out)
    w.close()
    assert gzip.decompress(out.read_bytes()) == b""
    r = BgzfReader.try_open(out)
    assert r is not None and r.read() == b""


def test_bgzf_streaming_record_spans_windows(tmp_path, monkeypatch):
    """Zero-copy gzip producer: a record larger than the inflate window
    must survive window boundaries byte-exactly (round-4 review: the
    n==0 path must extend the span WITHOUT advancing past the partial
    record's bytes)."""
    import io as _io

    import numpy as np

    from sickle_tpu.constants import QualityType
    from sickle_tpu.engine import EngineConfig, run_se
    from sickle_tpu.io import native
    from sickle_tpu.io.compression import BgzfReader, BgzfWriter, open_input
    from sickle_tpu.ops import TrimParams

    if not native.available():
        pytest.skip("native lib unavailable")
    rng = np.random.default_rng(11)
    recs = []
    for i in range(30):
        L = 50_000 + (i % 3) * 7
        seq = rng.choice(list(b"ACGT"), L).astype(np.uint8).tobytes()
        q = rng.integers(33 + 30, 33 + 41, L).astype(np.uint8).tobytes()
        recs.append(b"@r%d\n%s\n+\n%s\n" % (i, seq, q))
    data = b"".join(recs)
    gz = tmp_path / "long.fastq.gz"
    w = BgzfWriter(str(gz))
    w.write(data)
    w.close()

    params = TrimParams(qualtype=QualityType.SANGER, qual_threshold=20,
                        length_threshold=20)
    cfg = lambda: EngineConfig(records_per_chunk=8)  # noqa: E731

    ref = _io.BytesIO()
    run_se(_io.BytesIO(data), ref, params, cfg=cfg())

    # 1-block (48 KiB) windows: every record straddles boundaries
    monkeypatch.setattr(BgzfReader, "WINDOW_BLOCKS", 1)
    got = _io.BytesIO()
    with open_input(str(gz)) as fin:
        assert isinstance(fin, BgzfReader)
        c = run_se(fin, got, params, cfg=cfg())
    assert c.total == 30
    assert got.getvalue() == ref.getvalue()


def test_bgzf_interleaved_pe_pairs_span_windows(tmp_path, monkeypatch):
    """Interleaved pe over BGZF with 1-block windows: the odd-record
    carry must keep pairs whole across window boundaries, byte-exactly."""
    import io as _io

    from sickle_tpu import oracle
    from sickle_tpu.constants import QualityType
    from sickle_tpu.engine import EngineConfig, run_pe
    from sickle_tpu.io import native
    from sickle_tpu.io.compression import BgzfReader, BgzfWriter, open_input
    from sickle_tpu.ops import TrimParams

    if not native.available():
        pytest.skip("native lib unavailable")
    rng = np.random.default_rng(13)
    recs = []
    for i in range(40):  # ~27 KB records vs 48 KB windows: frequent odd cuts
        L = 9000 + (i % 5) * 11
        seq = rng.choice(list(b"ACGT"), L).astype(np.uint8).tobytes()
        q = rng.integers(33 + 25, 33 + 41, L).astype(np.uint8).tobytes()
        recs.append(b"@m%d/%d\n%s\n+\n%s\n" % (i // 2, i % 2 + 1, seq, q))
    data = b"".join(recs)
    gz = tmp_path / "inter.fastq.gz"
    w = BgzfWriter(str(gz))
    w.write(data)
    w.close()

    params = TrimParams(qualtype=QualityType.SANGER, qual_threshold=20,
                        length_threshold=20)
    want1, _, wants, wc = oracle.trim_pe(
        data, interleaved=True, qualtype=QualityType.SANGER,
        qual_threshold=20, length_threshold=20)

    monkeypatch.setattr(BgzfReader, "WINDOW_BLOCKS", 1)
    o1, so = _io.BytesIO(), _io.BytesIO()
    with open_input(str(gz)) as fin:
        assert isinstance(fin, BgzfReader)
        c = run_pe(fin, None, interleaved=True, out1=o1, singles_out=so,
                   params=params, cfg=EngineConfig(records_per_chunk=8))
    assert o1.getvalue() == want1
    assert so.getvalue() == wants
    assert c.total == wc.total == 40


def test_pe_two_file_bgzf_inputs(tmp_path):
    """pe with BOTH inputs BGZF-compressed (the chunked-reader fallback
    path): outputs byte-identical to plain-file inputs."""
    import io as _io

    from sickle_tpu.constants import QualityType
    from sickle_tpu.engine import EngineConfig, run_pe
    from sickle_tpu.io import native
    from sickle_tpu.io.compression import BgzfWriter, open_input
    from sickle_tpu.ops import TrimParams

    if not native.available():
        pytest.skip("native lib unavailable")
    from sickle_tpu import oracle
    from sickle_tpu.tools.synth_fastq import synth_fastq_bytes

    d1 = synth_fastq_bytes(1250, seed=2, mate=1)
    d2 = synth_fastq_bytes(1250, seed=2, mate=2)
    gz1, gz2 = tmp_path / "f.fastq.gz", tmp_path / "r.fastq.gz"
    for path, data in ((gz1, d1), (gz2, d2)):
        w = BgzfWriter(str(path))
        w.write(data)
        w.close()

    params = TrimParams(qualtype=QualityType.SANGER, qual_threshold=30,
                        length_threshold=20)
    outs = {}
    for tag, s1, s2 in (("plain", _io.BytesIO(d1), _io.BytesIO(d2)),
                        ("bgzf", open_input(str(gz1)), open_input(str(gz2)))):
        o1, o2, so = _io.BytesIO(), _io.BytesIO(), _io.BytesIO()
        c = run_pe(s1, s2, out1=o1, out2=o2, singles_out=so, params=params,
                   cfg=EngineConfig(records_per_chunk=512))
        outs[tag] = (o1.getvalue(), o2.getvalue(), so.getvalue(),
                     c.kept_p, c.total)
    assert outs["plain"] == outs["bgzf"]
    w1, w2, ws, wc = oracle.trim_pe(d1, d2, qualtype=QualityType.SANGER,
                                    qual_threshold=30, length_threshold=20)
    assert outs["plain"] == (w1, w2, ws, wc.kept_p, wc.total)
