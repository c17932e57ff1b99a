"""Multi-host distribution helpers + sharded step (virtual CPU mesh),
and REAL 2-process ``jax.distributed`` end-to-end runs (subprocess-spawned
CPU cluster): concatenated shard outputs must equal the single-host bytes
and host 0 must print globally merged counters."""

import io
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

from sickle_tpu.constants import Compat, QualityType
from sickle_tpu.ops import TrimParams
from sickle_tpu.parallel.dist import (
    host_file_shard,
    realign_to_record,
    shard_paired_ranges,
    shard_record_ranges,
    sharded_trim_step,
    split_record_ranges,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _spawn_cluster(per_proc_args, n=2, timeout=240):
    """Run `sickle <args> --dist` in n coordinated CPU processes."""
    port = _free_port()
    env = os.environ.copy()
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = REPO
    procs = []
    for pid in range(n):
        cmd = [
            sys.executable, "-m", "sickle_tpu", *per_proc_args,
            "--dist", "--coordinator", f"127.0.0.1:{port}",
            "--num-processes", str(n), "--process-id", str(pid),
        ]
        procs.append(subprocess.Popen(
            cmd, env=env, cwd=REPO,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        ))
    outs = []
    for p in procs:
        out, err = p.communicate(timeout=timeout)
        assert p.returncode == 0, (p.returncode, out, err)
        # drop the Gloo transport's connection log lines (they write to
        # fd 1 unbuffered and can interleave mid-line, losing the prefix)
        # Gloo's unbuffered fd-1 writes interleave mid-line with the
        # CLI's stdout, leaving stray fragments ("1\n", bare newlines,
        # half-prefixed [Gloo] lines).  Exact stdout parity is covered by
        # the single-process CLI goldens; here keep only lines the CLI
        # can emit (blank, or a known summary/reader prefix).
        keep_prefixes = (
            "SE input file:", "PE forward file:", "PE reverse file:",
            "PE interleaved file:", "Total", "FastQ", "Building reader",
        )
        lines = [
            ln for ln in out.decode().splitlines(keepends=True)
            if ln.strip() == "" or ln.startswith(keep_prefixes)
        ]
        text = "".join(lines)
        stripped = text.lstrip("\n")
        if text != stripped:
            text = "\n" + stripped
        outs.append(text)
    return outs


def _single_host(args):
    env = os.environ.copy()
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = REPO
    r = subprocess.run(
        [sys.executable, "-m", "sickle_tpu", *args], env=env, cwd=REPO,
        capture_output=True, timeout=240,
    )
    assert r.returncode == 0, (r.returncode, r.stdout, r.stderr)
    return r.stdout.decode()


def test_two_process_se_end_to_end(tmp_path, reference_fixtures):
    src = str(reference_fixtures / "test.fastq")
    ref_out = tmp_path / "ref.fastq"
    summary = _single_host(
        ["se", "-f", src, "-t", "sanger", "-q", "60", "-o", str(ref_out)]
    )

    out = tmp_path / "dist.fastq"
    outs = _spawn_cluster(
        ["se", "-f", src, "-t", "sanger", "-q", "60", "-o", str(out)]
    )
    shards = [
        (tmp_path / f"dist.fastq.shard{i}").read_bytes() for i in range(2)
    ]
    assert all(shards), "both shards produced output"
    assert b"".join(shards) == ref_out.read_bytes()
    # host 0 prints the globally merged summary; host 1 stays quiet
    host0 = [o for o in outs if "Total FastQ records" in o]
    assert len(host0) == 1
    assert host0[0] == summary, (
        f"host0 stdout != single-host summary\n"
        f"host0: {host0[0]!r}\nsummary: {summary!r}"
    )
    assert "Total FastQ records: 2500" in host0[0]


def test_two_process_pe_two_file_end_to_end(tmp_path, reference_fixtures):
    f1 = str(reference_fixtures / "test.f.fastq")
    f2 = str(reference_fixtures / "test.r.fastq")
    base = ["pe", "-t", "sanger", "-q", "60", "-f", f1, "-r", f2]
    ref = [tmp_path / n for n in ("r1.fastq", "r2.fastq", "rs.fastq")]
    summary = _single_host(
        base + ["-o", str(ref[0]), "-p", str(ref[1]), "-s", str(ref[2])]
    )

    outp = [tmp_path / n for n in ("d1.fastq", "d2.fastq", "ds.fastq")]
    outs = _spawn_cluster(
        base + ["-o", str(outp[0]), "-p", str(outp[1]), "-s", str(outp[2])]
    )
    for want, got in zip(ref, outp):
        shards = [
            (tmp_path / f"{got.name}.shard{i}").read_bytes() for i in range(2)
        ]
        assert b"".join(shards) == want.read_bytes()
    host0 = [o for o in outs if "Total input FastQ records" in o]
    assert len(host0) == 1 and host0[0] == summary
    assert "Total input FastQ records: 2500 (1250 pairs)" in host0[0]


def test_dist_rejects_gzip_input(tmp_path, reference_fixtures):
    import gzip as _gz

    src = tmp_path / "in.fastq.gz"
    src.write_bytes(_gz.compress(
        (reference_fixtures / "test.fastq").read_bytes()
    ))
    port = _free_port()
    env = os.environ.copy()
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = REPO
    procs = [
        subprocess.Popen(
            [sys.executable, "-m", "sickle_tpu", "se", "-f", str(src),
             "-t", "sanger", "-o", str(tmp_path / "o.fastq"),
             "--dist", "--coordinator", f"127.0.0.1:{port}",
             "--num-processes", "2", "--process-id", str(pid)],
            env=env, cwd=REPO,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        )
        for pid in range(2)
    ]
    for p in procs:
        out, err = p.communicate(timeout=240)
        assert p.returncode == 1
        assert b"pre-sharded per host" in err


def test_shard_record_ranges_pair_aligned(tmp_path, reference_fixtures):
    src = reference_fixtures / "test.fastq"  # interleaved pairs
    data = src.read_bytes()
    for n in (2, 3, 5):
        ranges = shard_record_ranges(src, n, align=2)
        assert sum(l for _, l in ranges) == len(data)
        for off, length in ranges:
            shard = data[off : off + length]
            if shard:
                assert shard.startswith(b"@")
                assert (shard.count(b"\n") // 4) % 2 == 0  # whole pairs


def test_shard_paired_ranges_same_mate_counts(reference_fixtures):
    f1 = reference_fixtures / "test.f.fastq"
    f2 = reference_fixtures / "test.r.fastq"
    d1, d2 = f1.read_bytes(), f2.read_bytes()
    for n in (2, 4):
        pairs = shard_paired_ranges(f1, f2, n)
        assert sum(l for (_, l), _ in pairs) == len(d1)
        assert sum(l for _, (_, l) in pairs) == len(d2)
        for (o1, l1), (o2, l2) in pairs:
            s1 = d1[o1 : o1 + l1]
            s2 = d2[o2 : o2 + l2]
            assert s1.count(b"\n") // 4 == s2.count(b"\n") // 4
            if s1:
                assert s1.startswith(b"@") and s2.startswith(b"@")


def test_host_file_shard_round_robin():
    paths = [f"f{i}.fastq" for i in range(7)]
    s0 = host_file_shard(paths, process_id=0, num_processes=2)
    s1 = host_file_shard(paths, process_id=1, num_processes=2)
    assert s0 + s1 and set(s0) | set(s1) == set(paths)
    assert not set(s0) & set(s1)
    assert s0 == ["f0.fastq", "f2.fastq", "f4.fastq", "f6.fastq"]


def test_split_record_ranges(tmp_path, reference_fixtures):
    src = reference_fixtures / "test.fastq"
    data = src.read_bytes()
    for n in (2, 3, 8):
        ranges = split_record_ranges(src, n)
        assert sum(l for _, l in ranges) == len(data)
        # every shard starts at a record boundary and shards tile the file
        pos = 0
        rec_count = 0
        for off, length in ranges:
            assert off == pos
            shard = data[off : off + length]
            if shard:
                assert shard.startswith(b"@")
                lines = shard.split(b"\n")
                n_lines = len(lines) - (1 if lines[-1] == b"" else 0)
                assert n_lines % 4 == 0
                rec_count += n_lines // 4
            pos = off + length
        assert rec_count == 2500


def test_realign_quality_line_at_sign(tmp_path):
    # quality line starting with '@' must not be mistaken for a record start
    rec1 = b"@r1\nACGTACGT\n+\n@IIIIIII\n"  # qual starts with '@'
    rec2 = b"@r2\nACGTACGT\n+\nIIIIIIII\n"
    path = tmp_path / "x.fastq"
    path.write_bytes(rec1 + rec2)
    # offset inside rec1, just before the quality line
    off = realign_to_record(path, rec1.find(b"@I") - 0)
    assert off == len(rec1)  # lands on rec2, not the '@I...' quality line


def test_sharded_trim_step_counters(reference_fixtures):
    import jax

    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    from sickle_tpu.io import pack_fastq
    from sickle_tpu.parallel import data_mesh

    data = (reference_fixtures / "test.fastq").read_bytes()
    p = pack_fastq(data, batch_multiple=8)
    B = p.batch_size - p.batch_size % 8
    params = TrimParams(qualtype=QualityType.SANGER, qual_threshold=60,
                        compat=Compat.FORK)
    mesh = data_mesh(8)
    step = sharded_trim_step(params, mesh)
    five, three, bad, total, kept = step(
        p.seq[:B], p.qual[:B], p.lengths[:B]
    )
    n_valid = int((p.lengths[:B] > 0).sum())
    assert int(total) == n_valid
    assert int(kept) == int((np.asarray(three)[:B] >= 0).sum())


def _write_bgzf(path, data: bytes):
    from sickle_tpu.io.compression import BgzfWriter

    w = BgzfWriter(str(path))
    w.write(data)
    w.close()


def test_bgzf_seek_uncompressed_space(tmp_path, reference_fixtures):
    """BgzfReader.seek addresses UNCOMPRESSED offsets via the block
    index — the primitive that makes BGZF --dist shards work."""
    from sickle_tpu.io import native
    from sickle_tpu.io.compression import BgzfReader

    if not native.available():
        pytest.skip("needs native io lib")
    data = (reference_fixtures / "test.fastq").read_bytes() * 3
    path = tmp_path / "x.fastq.gz"
    _write_bgzf(path, data)
    r = BgzfReader.try_open(str(path))
    assert r is not None
    assert r.usize == len(data)
    for off in (0, 1, 4096, 48 * 1024, 48 * 1024 + 17, len(data) - 10):
        r.seek(off)
        got = r.read(100)
        assert got == data[off : off + 100], off


def test_shard_record_ranges_bgzf(tmp_path, reference_fixtures):
    """BGZF inputs shard in uncompressed space: ranges tile [0, usize),
    start on record boundaries, and align=2 keeps whole pairs."""
    from sickle_tpu.io import native

    if not native.available():
        pytest.skip("needs native io lib")
    data = (reference_fixtures / "test.fastq").read_bytes() * 2
    path = tmp_path / "x.fastq.gz"
    _write_bgzf(path, data)
    for n in (2, 3):
        for align in (1, 2):
            ranges = shard_record_ranges(path, n, align=align)
            assert sum(l for _, l in ranges) == len(data)
            pos = 0
            for off, length in ranges:
                assert off == pos
                shard = data[off : off + length]
                if shard:
                    assert shard.startswith(b"@")
                    recs = shard.count(b"\n") // 4
                    assert recs % align == 0
                pos = off + length


def test_shard_paired_ranges_bgzf_mixed(tmp_path, reference_fixtures):
    """Two-file pe sharding with one BGZF and one plain mate file."""
    from sickle_tpu.io import native

    if not native.available():
        pytest.skip("needs native io lib")
    d1 = (reference_fixtures / "test.f.fastq").read_bytes()
    d2 = (reference_fixtures / "test.r.fastq").read_bytes()
    p1 = tmp_path / "f1.fastq.gz"
    _write_bgzf(p1, d1)
    p2 = reference_fixtures / "test.r.fastq"
    pairs = shard_paired_ranges(p1, p2, 2)
    assert sum(l for (_, l), _ in pairs) == len(d1)
    assert sum(l for _, (_, l) in pairs) == len(d2)
    for (o1, l1), (o2, l2) in pairs:
        s1 = d1[o1 : o1 + l1]
        s2 = d2[o2 : o2 + l2]
        assert s1.count(b"\n") // 4 == s2.count(b"\n") // 4


def test_two_process_se_bgzf_end_to_end(tmp_path, reference_fixtures):
    """--dist on a BGZF input (this framework's own -g output format):
    shard-concat must equal the single-host bytes."""
    from sickle_tpu.io import native

    if not native.available():
        pytest.skip("needs native io lib")
    data = (reference_fixtures / "test.fastq").read_bytes()
    src = tmp_path / "in.fastq.gz"
    _write_bgzf(src, data)

    ref_out = tmp_path / "ref.fastq"
    summary = _single_host(
        ["se", "-f", str(src), "-t", "sanger", "-q", "60", "-o", str(ref_out)]
    )
    out = tmp_path / "dist.fastq"
    outs = _spawn_cluster(
        ["se", "-f", str(src), "-t", "sanger", "-q", "60", "-o", str(out)]
    )
    shards = [
        (tmp_path / f"dist.fastq.shard{i}").read_bytes() for i in range(2)
    ]
    assert all(shards)
    assert b"".join(shards) == ref_out.read_bytes()
    host0 = [o for o in outs if "Total FastQ records" in o]
    assert len(host0) == 1 and host0[0] == summary
    assert "Total FastQ records: 2500" in host0[0]
