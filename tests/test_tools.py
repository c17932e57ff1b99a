"""trim_all directory batch driver tests (se + pe, resume-skip)."""

import os

import pytest

from sickle_tpu.tools import trim_all


def head_records(data: bytes, nbytes: int) -> bytes:
    """First whole records within ~nbytes (drop mid-line truncated tail)."""
    lines = data[:nbytes].split(b"\n")[:-1]
    n = len(lines) // 4 * 4
    return b"\n".join(lines[:n]) + b"\n"


@pytest.fixture
def fastq_dir(tmp_path, reference_fixtures):
    d = tmp_path / "in"
    d.mkdir()
    (d / "sample.fastq").write_bytes(
        head_records((reference_fixtures / "test.fastq").read_bytes(), 4120)
    )
    (d / "pairA.1.fastq").write_bytes(
        head_records((reference_fixtures / "test.f.fastq").read_bytes(), 4120)
    )
    (d / "pairA.2.fastq").write_bytes(
        head_records((reference_fixtures / "test.r.fastq").read_bytes(), 4120)
    )
    return d


def test_trim_all_se(fastq_dir, tmp_path, capsys):
    out = tmp_path / "out"
    rc = trim_all.main(["se", "sanger", str(fastq_dir), str(out)])
    assert rc == 0
    assert (out / "sample.trim.fastq").exists()
    # resume: second run skips
    rc = trim_all.main(["se", "sanger", str(fastq_dir), str(out)])
    assert rc == 0
    assert "already exists" in capsys.readouterr().out


def test_trim_all_pe(fastq_dir, tmp_path):
    out = tmp_path / "out"
    rc = trim_all.main(["pe", "sanger", str(fastq_dir), str(out)])
    assert rc == 0
    assert (out / "pairA.1.trim.fastq").exists()
    assert (out / "pairA.2.trim.fastq").exists()
    assert (out / "pairA.s.trim.fastq").exists()


def test_galaxy_wrapper_param_parity():
    """The Galaxy wrapper exposes the reference wrapper's full parameter
    surface (/root/reference/sickle.xml:97-115: qual/length thresholds,
    threads, batch, -x, -n) plus -g, each mapped into the command."""
    import os
    import xml.etree.ElementTree as ET

    path = os.path.join(os.path.dirname(__file__), "..", "galaxy",
                        "sickle_tpu.xml")
    tree = ET.parse(path)
    names = {p.get("name") for p in tree.iter("param")}
    for want in ("qual_threshold", "length_threshold", "threads", "batch",
                 "no_five_prime", "trunc_n", "gzip_output", "output_n"):
        assert want in names, want
    cmd = tree.find("command").text
    for frag in ("-q $qual_threshold", "-l $length_threshold", "-a $threads",
                 "-b $batch", "$no_five_prime", "$trunc_n", "$gzip_output"):
        assert frag in cmd, frag
    # the <tests> block exercises the new params
    test_params = {p.get("name") for p in tree.find("tests").iter("param")}
    assert {"threads", "batch"} <= test_params
