"""MmapWriter (zero-copy output mapping) unit + engine identity tests."""

import os
import subprocess
import sys

import numpy as np
import pytest

from sickle_tpu.io.output import MmapWriter


def test_write_and_close_truncates(tmp_path):
    p = tmp_path / "o.bin"
    w = MmapWriter(p, initial_cap=1 << 16)
    w.write(b"hello ")
    w.write(b"world")
    assert w.tell() == 11
    w.close()
    assert p.read_bytes() == b"hello world"


def test_reserve_commit_protocol(tmp_path):
    p = tmp_path / "o.bin"
    w = MmapWriter(p, initial_cap=1 << 16)
    buf, start = w.reserve(4)
    assert start == 0
    buf[0:4] = np.frombuffer(b"abcd", np.uint8)
    w.commit(4)
    buf, start = w.reserve(2)
    buf[start:start + 2] = np.frombuffer(b"ef", np.uint8)
    w.commit(2)
    w.close()
    assert p.read_bytes() == b"abcdef"


def test_growth_preserves_earlier_bytes(tmp_path):
    p = tmp_path / "o.bin"
    w = MmapWriter(p, initial_cap=1 << 12)
    first = bytes(range(256)) * 16  # 4 KB = initial cap
    w.write(first)
    # force several growth generations past the initial mapping
    blob = os.urandom(1 << 16)
    for _ in range(8):
        w.write(blob)
    w.close()
    got = p.read_bytes()
    assert got[: len(first)] == first
    assert got[len(first):] == blob * 8
    assert len(got) == len(first) + 8 * (1 << 16)


def test_truncate_seek_resume_semantics(tmp_path):
    """The checkpoint resume protocol: truncate to a recorded size, seek
    there, continue appending (engine/checkpoint.resume_outputs)."""
    p = tmp_path / "o.bin"
    w = MmapWriter(p, initial_cap=1 << 12)
    w.write(b"A" * 100)
    w.close()
    w = MmapWriter(p, initial_cap=1 << 12)
    w.truncate(40)
    w.seek(40)
    w.write(b"B" * 10)
    assert w.tell() == 50
    w.close()
    assert p.read_bytes() == b"A" * 40 + b"B" * 10


def test_shrinking_truncate_zeroes_stale_tail(tmp_path):
    p = tmp_path / "o.bin"
    w = MmapWriter(p, initial_cap=1 << 12)
    w.write(b"X" * 64)
    w.truncate(16)
    w.seek(16)
    w.write(b"Y" * 8)
    w.close()
    assert p.read_bytes() == b"X" * 16 + b"Y" * 8


@pytest.mark.parametrize("mode", ["se", "pe"])
def test_cli_mmap_vs_buffered_identity(tmp_path, mode, synth_dir):
    """The mmap emit path and the classic write() path produce identical
    bytes through the real CLI."""
    fix = str(synth_dir / "se.fastq")
    ff, fr = str(synth_dir / "r1.fastq"), str(synth_dir / "r2.fastq")
    outs = {}
    for tag, env_extra in (("mm", {}), ("buf", {"SICKLE_TPU_NO_MMAP_OUT": "1"})):
        env = dict(os.environ, JAX_PLATFORMS="cpu", **env_extra)
        if mode == "se":
            o = tmp_path / f"{tag}.fastq"
            cmd = [sys.executable, "-m", "sickle_tpu", "se", "-f", fix,
                   "-t", "sanger", "-q", "30", "-o", str(o), "--quiet"]
            files = [o]
        else:
            o1 = tmp_path / f"{tag}1.fastq"
            o2 = tmp_path / f"{tag}2.fastq"
            so = tmp_path / f"{tag}s.fastq"
            cmd = [sys.executable, "-m", "sickle_tpu", "pe", "-f", ff, "-r", fr,
                   "-t", "sanger", "-q", "30", "-o", str(o1), "-p", str(o2),
                   "-s", str(so), "--quiet"]
            files = [o1, o2, so]
        subprocess.run(cmd, check=True, env=env, capture_output=True)
        outs[tag] = [f.read_bytes() for f in files]
    assert outs["mm"] == outs["buf"]
    assert all(outs["mm"])  # every output received records


def test_fused_emit_empty_comment_grows_output(tmp_path):
    """V133 compat rewrites the comment line to '+': with EMPTY source
    comments the output is LARGER than the input span — the fused
    plan+assemble capacity bound must include the +1/record slack."""
    recs = []
    for i in range(5000):
        recs.append(b"@r%d\nACGTACGTACGTACGTACGTACGT\n\n" % i
                    + b"I" * 24 + b"\n")  # empty comment line
    src = tmp_path / "empty_comment.fastq"
    src.write_bytes(b"".join(recs))
    out = tmp_path / "o.fastq"
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    subprocess.run([sys.executable, "-m", "sickle_tpu", "se", "-f", str(src),
                    "-t", "sanger", "-q", "20", "--compat", "1.33",
                    "-o", str(out), "--quiet"], check=True, env=env,
                   capture_output=True)
    got = out.read_bytes()
    assert got.count(b"\n+\n") == 5000
    assert len(got) == len(b"".join(recs)) + 5000  # +1 byte per record


def test_truncate_at_open_and_seek_end(tmp_path):
    p = tmp_path / "o.bin"
    p.write_bytes(b"STALE" * 100)
    from sickle_tpu.io.output import MmapWriter as MW

    w = MW(p, initial_cap=1 << 12, truncate=True)
    w.write(b"new")
    assert w.seek(0, os.SEEK_END) == 3  # logical size, not stale size
    w.seek(1)
    assert w.seek(0, os.SEEK_END) == 3  # survives a backward seek
    w.close()
    assert p.read_bytes() == b"new"


def test_open_regular_rejects_devices_without_fd_leak():
    import resource

    from sickle_tpu.io.output import MmapWriter as MW

    n_before = len(os.listdir("/proc/self/fd"))
    for _ in range(20):
        assert MW.open_regular("/dev/null", truncate=True) is None
    assert len(os.listdir("/proc/self/fd")) <= n_before + 1
