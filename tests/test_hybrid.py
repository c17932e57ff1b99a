"""Hybrid device+host dispatcher: byte-identity, routing, and failover.

The device fn here is the CPU jnp kernel (tests never touch an
accelerator); the contract under test is the DISPATCHER's: any mix of
device/host routing, including stall rescue, must produce byte-identical output and
exact counters.
"""

import io
import time

import numpy as np
import pytest

from sickle_tpu.constants import Compat, QualityType
from sickle_tpu.engine import EngineConfig, run_se
from sickle_tpu.engine.hybrid import HybridCutsFn
from sickle_tpu.engine.pipeline import _adapt_cuts_fn
from sickle_tpu.ops import TrimParams, compute_cuts_jit
from sickle_tpu.tools.synth_fastq import synth_fastq_bytes


def params():
    return TrimParams(qualtype=QualityType.SANGER, qual_threshold=30,
                      length_threshold=20, compat=Compat.V133)


def run(data: bytes, cuts_fn, rpc=512) -> tuple:
    out = io.BytesIO()
    cfg = EngineConfig(records_per_chunk=rpc, prefetch=2)
    c = run_se(io.BytesIO(data), out, params(), cfg=cfg, cuts_fn=cuts_fn)
    return out.getvalue(), (c.total, c.kept, c.discarded)


@pytest.fixture(scope="module")
def fixture_bytes():
    return synth_fastq_bytes(10_000, seed=4)  # ~20 chunks at rpc=512


@pytest.fixture(scope="module")
def reference_run(fixture_bytes):
    def jnp_fn(seq, qual, lengths):
        return compute_cuts_jit(seq, qual, lengths, params())

    return run(fixture_bytes, jnp_fn)


def test_hybrid_host_only_matches(fixture_bytes, reference_run):
    fn = HybridCutsFn(params(), None)
    try:
        got = run(fixture_bytes, fn)
    finally:
        fn.close()
    assert got == reference_run
    assert fn.n_host > 0 and fn.n_device == 0


def test_hybrid_mixed_routing_matches(fixture_bytes, reference_run):
    p = params()

    def slow_dev(seq, qual, lengths):
        # 200 ms per device chunk vs ~2 ms packs: the depth-1 device queue
        # is reliably full when the next chunk routes, forcing host
        # overflow (20 ms flaked when a cold pack took just as long)
        time.sleep(0.2)
        return compute_cuts_jit(seq, qual, lengths, p)

    fn = HybridCutsFn(p, _adapt_cuts_fn(slow_dev), device_depth=1,
                      rescue_s=0)  # rescue off: pure routing test
    try:
        got = run(fixture_bytes, fn)
    finally:
        fn.close()
    assert got == reference_run
    assert fn.n_device > 0, "device route never used"
    assert fn.n_host > 0, "host overflow never used"
    assert fn.n_rescued == 0


def test_hybrid_stall_rescue_matches(fixture_bytes, reference_run):
    """A 'stalled' device (multi-second per chunk) must not stall the
    pass: the rescue recomputes host-side and output stays identical."""
    p = params()
    calls = {"n": 0}

    def stalling_dev(seq, qual, lengths):
        calls["n"] += 1
        time.sleep(2.0)  # every device chunk stalls vs rescue_s=0.1
        return compute_cuts_jit(seq, qual, lengths, p)

    fn = HybridCutsFn(p, _adapt_cuts_fn(stalling_dev), device_depth=1,
                      rescue_s=0.1)
    t0 = time.perf_counter()
    try:
        got = run(fixture_bytes, fn)
    finally:
        fn.close()
    dt = time.perf_counter() - t0
    assert got == reference_run
    assert fn.n_rescued >= 1
    # ~20 chunks at 2 s each would be ~40 s device-bound; failover keeps
    # the pass near host speed (a couple of rescue timeouts at most)
    assert dt < 10, f"failover did not keep the pass moving ({dt:.1f}s)"


def test_hybrid_propagates_device_errors(fixture_bytes):
    p = params()

    def broken_dev(seq, qual, lengths):
        raise RuntimeError("device exploded")

    fn = HybridCutsFn(p, _adapt_cuts_fn(broken_dev), rescue_s=0)
    try:
        with pytest.raises(RuntimeError, match="device exploded"):
            run(fixture_bytes, fn)
    finally:
        fn.close()


def test_hybrid_quality_error_parity(tmp_path):
    """A touched out-of-range char raises the exact reference message
    through the hybrid host route."""
    from sickle_tpu.oracle import QualityRangeError

    bad = b"@r1\n" + b"A" * 40 + b"\n+\n" + bytes([80]) * 20 + b"\x1f" + bytes([80]) * 19 + b"\n"
    fn = HybridCutsFn(params(), None)
    try:
        with pytest.raises(QualityRangeError) as e:
            run(bad * 8, fn, rpc=8)
    finally:
        fn.close()
    assert "does not fall within correct range" in e.value.message


def test_cli_mesh_path_hybrid_byte_identity(tmp_path, synth_dir):
    """--devices 8 (virtual CPU mesh) goes through the hybrid wrapper in
    the CLI; output must equal the single-device run byte-for-byte."""
    import os
    import subprocess
    import sys

    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    out1 = tmp_path / "one.fastq"
    out8 = tmp_path / "mesh.fastq"
    base = [sys.executable, "-m", "sickle_tpu", "se", "-f",
            str(synth_dir / "se.fastq"), "-t", "sanger", "-q", "30"]
    for out, extra in ((out1, ["--devices", "1"]),
                       (out8, ["--devices", "8"])):
        r = subprocess.run(base + ["-o", str(out)] + extra, env=env,
                           capture_output=True, timeout=240,
                           cwd=os.path.dirname(os.path.dirname(__file__)))
        assert r.returncode == 0, r.stderr.decode()[-2000:]
    assert out1.read_bytes() == out8.read_bytes()
    assert out1.stat().st_size > 0


def test_hybrid_pe_host_only_indexed_matches():
    """pe two-file through the host-only hybrid (indexed rows): byte
    parity with the oracle across outputs and counters."""
    from sickle_tpu import oracle
    from sickle_tpu.engine import run_pe

    d1 = synth_fastq_bytes(1250, seed=2, mate=1)
    d2 = synth_fastq_bytes(1250, seed=2, mate=2)
    p = params()
    fn = HybridCutsFn(p, None)
    o1, o2, so = io.BytesIO(), io.BytesIO(), io.BytesIO()
    try:
        c = run_pe(io.BytesIO(d1), io.BytesIO(d2), out1=o1, out2=o2,
                   singles_out=so, params=p,
                   cfg=EngineConfig(records_per_chunk=256), cuts_fn=fn)
    finally:
        fn.close()
    w1, w2, ws, cc = oracle.trim_pe(d1, d2, qualtype=QualityType.SANGER,
                                    qual_threshold=30, length_threshold=20)
    assert o1.getvalue() == w1
    assert o2.getvalue() == w2
    assert so.getvalue() == ws
    assert (c.kept_p, c.kept_s1, c.kept_s2, c.discard_p) == (
        cc.kept_p, cc.kept_s1, cc.kept_s2, cc.discard_p)
    assert fn.n_host > 0 and fn.n_device == 0


def test_hybrid_host_only_long_reads():
    """ONT-scale reads (50 kbp) through the host-only hybrid (indexed
    path; byte-budget chunk shrinking) match the oracle."""
    from sickle_tpu import oracle

    rng = np.random.default_rng(21)
    recs = []
    for i in range(24):
        L = 50_000 - (i * 13) % 40
        seq = rng.choice(list(b"ACGT"), L).astype(np.uint8).tobytes()
        q = np.full(L, 70, np.uint8)
        q[: L // 6] = 33 + 5
        q[-L // 7:] = 33 + 3
        recs.append(b"@L%d\n%s\n+\n%s\n" % (i, seq, q.tobytes()))
    data = b"".join(recs)
    p = TrimParams(qualtype=QualityType.SANGER, qual_threshold=20,
                   length_threshold=20)
    fn = HybridCutsFn(p, None)
    out = io.BytesIO()
    try:
        c = run_se(io.BytesIO(data), out, p,
                   cfg=EngineConfig(records_per_chunk=8,
                                    bytes_per_batch=1 << 20), cuts_fn=fn)
    finally:
        fn.close()
    want, wc = oracle.trim_se(data, qualtype=QualityType.SANGER,
                              qual_threshold=20, length_threshold=20)
    assert out.getvalue() == want
    assert (c.total, c.kept) == (wc.total, wc.kept) == (24, wc.kept)
