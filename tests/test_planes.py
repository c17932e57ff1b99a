"""Field-wire format tests (io.fastq.qual_fields <-> ops.trim.decode_fields).

The device step ships the p-bit biased quality value as byte-aligned
4/2/1-bit subfields instead of raw u8 rows when a chunk's quality chars
fit a p<=6-bit band inside the encoding's range — p/8 of the H2D bytes
at ~3 decode passes.  These tests pin the
round-trip exactly and prove the engine's output is byte-identical with
the format on and off, including the fallbacks (out-of-range chars, NUL
bytes, -n) where the compressed wire must NOT be used.
"""

import io
import os

import numpy as np
import pytest

from sickle_tpu import oracle
from sickle_tpu.constants import QualityType
from sickle_tpu.engine import EngineConfig, run_se
from sickle_tpu.engine.pipeline import _device_cuts_fn
from sickle_tpu.io.fastq import QUAL_PLANES, qual_fields, qual_minmax
from sickle_tpu.ops import TrimParams
from sickle_tpu.tools.synth_fastq import synth_fastq_bytes

# 2,500 seeded reads (10% ragged, N-rich reads, low-quality tails)
DATA = synth_fastq_bytes(2500, seed=1)


def _random_qual(rng, B, L, lo=59, hi=105):
    qual = rng.integers(lo, hi, (B, L)).astype(np.uint8)
    lens = rng.integers(0, L + 1, B).astype(np.int32)
    lens[0] = 0
    lens[-1] = L
    for b in range(B):
        qual[b, lens[b]:] = 0
    return qual, lens


@pytest.mark.parametrize("L", [8, 152, 160, 1000 + 8 - 1000 % 8])
def test_field_roundtrip(L):
    import jax.numpy as jnp

    from sickle_tpu.ops.trim import decode_fields

    rng = np.random.default_rng(L)
    qual, _ = _random_qual(rng, 32, L)
    mn, mx = qual_minmax(qual)
    assert mn == int(np.where(qual == 0, 255, qual).min())
    assert mx == int(qual.max())
    bias = mn - 1
    assert mx - bias < (1 << QUAL_PLANES)
    buf = qual_fields(qual, bias)
    assert buf.shape == (32, QUAL_PLANES * L // 8)
    v = np.asarray(decode_fields(jnp.asarray(buf), QUAL_PLANES, L))
    vref = np.where(qual > 0, qual.astype(np.int32) - bias, 0)
    np.testing.assert_array_equal(v, vref)


def test_native_matches_numpy_fallback():
    from sickle_tpu.io import native
    from sickle_tpu.io.fastq import _fields_numpy

    if native.get_lib() is None:
        pytest.skip("native lib unavailable")
    rng = np.random.default_rng(7)
    qual, _ = _random_qual(rng, 64, 152)
    got = qual_fields(qual, 58)
    v = np.clip(qual.astype(np.int16) - 58, 0, None).astype(np.uint8)
    np.testing.assert_array_equal(got, _fields_numpy(v, QUAL_PLANES))


def _run(params, data, no_planes, slice_rows=512):
    if no_planes:
        os.environ["SICKLE_TPU_NO_PLANES"] = "1"
    else:
        os.environ.pop("SICKLE_TPU_NO_PLANES", None)
    try:
        fn = _device_cuts_fn(params, slice_rows=slice_rows, inflight=2)
        buf = io.BytesIO()
        c = run_se(io.BytesIO(data), buf, params,
                   cfg=EngineConfig(records_per_chunk=slice_rows,
                                    slice_rows=slice_rows), cuts_fn=fn)
        return buf.getvalue(), c, getattr(fn, "last_h2d", None)
    finally:
        os.environ.pop("SICKLE_TPU_NO_PLANES", None)


def test_engine_byte_identity_planes_vs_raw():
    params = TrimParams(qualtype=QualityType.SANGER, qual_threshold=30,
                        length_threshold=20)
    data = DATA
    out_p, c_p, h2d_p = _run(params, data, no_planes=False)
    out_r, c_r, h2d_r = _run(params, data, no_planes=True)
    assert out_p == out_r
    want, wc = oracle.trim_se(data, qualtype=QualityType.SANGER,
                              qual_threshold=30, length_threshold=20)
    assert out_p == want
    assert (c_p.total, c_p.kept, c_p.discarded) == (
        wc.total, wc.kept, wc.discarded)
    assert 0 < wc.discarded < wc.total == 2500
    assert h2d_p < h2d_r  # planes actually engaged and saved wire bytes


def test_out_of_range_chunk_falls_back_with_exact_error():
    # a char outside sanger [33,126] must produce the reference's exact
    # error regardless of wire format: the min/max gate routes such
    # chunks to the raw path whose device range check + host re-scan
    # preserves the message (reference src/trim.cpp:121-134)
    from sickle_tpu.oracle import SickleError

    rec = b"@r1 x\nACGTACGTACGTACGTACGTACGT\n+\n" + b"I" * 23 + b"\x1f\n"
    params = TrimParams(qualtype=QualityType.SANGER, qual_threshold=20,
                        length_threshold=5)
    msgs = []
    for no_planes in (False, True):
        with pytest.raises(SickleError) as ei:
            _run(params, rec * 50, no_planes=no_planes)
        msgs.append(str(ei.value.message))
    assert msgs[0] == msgs[1]


def test_nul_in_quality_still_errors():
    # NUL inside a read's quality = invalid char; qual_clean=False routes
    # to the explicit path before planes are ever considered
    from sickle_tpu.oracle import SickleError

    rec = b"@r1 x\nACGTACGT\n+\nIIII\x00III\n"
    params = TrimParams(qualtype=QualityType.SANGER, qual_threshold=20,
                        length_threshold=2)
    for no_planes in (False, True):
        with pytest.raises(SickleError):
            _run(params, rec * 4, no_planes=no_planes)


def test_mesh_path_uses_planes_and_matches():
    # --devices N inherits the field wire: byte-identity vs single
    # device, and fewer wire bytes than raw rows
    import jax

    if len(jax.devices()) < 8:
        pytest.skip("needs 8 (virtual) devices")
    from sickle_tpu.parallel import data_mesh, sharded_cuts_fn

    params = TrimParams(qualtype=QualityType.SANGER, qual_threshold=30,
                        length_threshold=20)
    data = DATA
    mesh = data_mesh(8)
    h2d = {}
    outs = {}
    for tag in ("planes", "raw"):
        if tag == "raw":
            os.environ["SICKLE_TPU_NO_PLANES"] = "1"
        try:
            from sickle_tpu.utils.metrics import Metrics

            fn = sharded_cuts_fn(params, mesh, slice_rows=1024)
            buf = io.BytesIO()
            cfg = EngineConfig(records_per_chunk=1024, slice_rows=1024)
            cfg.metrics = Metrics()
            run_se(io.BytesIO(data), buf, params, cfg=cfg, cuts_fn=fn)
            outs[tag] = buf.getvalue()
            h2d[tag] = sum(cfg.metrics.h2d_bytes)
        finally:
            os.environ.pop("SICKLE_TPU_NO_PLANES", None)
    single, _, _ = _run(params, data, no_planes=False, slice_rows=1024)
    assert outs["planes"] == outs["raw"] == single
    assert h2d["planes"] < h2d["raw"]  # planes engaged on the mesh path


def test_trunc_n_uses_seq_path_and_matches():
    # -n needs seq on device; planes are qual-only, so the stacked path
    # must be taken — outputs identical either way
    params = TrimParams(qualtype=QualityType.SANGER, qual_threshold=20,
                        length_threshold=10, trunc_n=True)
    data = DATA
    out_p, c_p, _ = _run(params, data, no_planes=False)
    out_r, c_r, _ = _run(params, data, no_planes=True)
    assert out_p == out_r
    assert c_p.total == 2500


@pytest.mark.parametrize("p", [1, 2, 3, 4, 5, 6, 7])
def test_field_roundtrip_adaptive_counts(p):
    """Round-trip at every adaptive bit width (the wire ships exactly
    ceil(log2(band)) bits — binned Illumina quals ship 2-3)."""
    import jax.numpy as jnp

    from sickle_tpu.ops.trim import decode_fields

    rng = np.random.default_rng(p)
    # chars 59 .. 59 + 2^p - 2 => v = q - 58 in [1, 2^p - 1]: fits p bits
    lo, hi = 59, 59 + (1 << p) - 1
    qual, _ = _random_qual(rng, 16, 64, lo=lo, hi=min(hi, 255))
    bias = 58
    buf = qual_fields(qual, bias, p)
    assert buf.shape == (16, p * 8)
    v = np.asarray(decode_fields(jnp.asarray(buf), p, 64))
    vref = np.where(qual > 0, qual.astype(np.int32) - bias, 0)
    np.testing.assert_array_equal(v, vref)


def test_engine_adaptive_planes_on_binned_quals():
    """Binned-quality data (4 distinct levels) must ship 2 planes
    (~1/4 of the 8-bit wire) and stay byte-identical with planes off."""
    rng = np.random.default_rng(42)
    levels = np.array([ord("#"), ord("0"), ord(":"), ord("F")], np.uint8)
    recs = []
    for i in range(600):
        L = 100
        q = rng.choice(levels, L).astype(np.uint8)
        s = rng.choice(list(b"ACGT"), L).astype(np.uint8)
        recs.append(b"@r%d\n%s\n+\n%s\n" % (i, s.tobytes(), q.tobytes()))
    data = b"".join(recs)
    params = TrimParams(qualtype=QualityType.SANGER, qual_threshold=20,
                        length_threshold=20)
    out_p, c_p, h2d_p = _run(params, data, no_planes=False)
    out_r, c_r, h2d_r = _run(params, data, no_planes=True)
    assert out_p == out_r
    assert c_p.total == 600
    # 4 distinct LEVELS over a 36-char band: the rank wire ships
    # ceil(log2(4+1)) = 3 planes (the band wire would need 6)
    # last chunk: 88 records -> 128 pow2-padded rows of stride 104
    assert h2d_r == 128 * 104
    assert h2d_p <= 3 * 128 * 104 // 8 + 32  # 3 planes + the 8-entry LUT


def test_rank_fields_roundtrip():
    """Host rank-encode (C++ and numpy fallback) -> device LUT decode
    recovers the exact decoded qualities."""
    import jax.numpy as jnp

    from sickle_tpu.io import native
    from sickle_tpu.io.fastq import qual_levels, qual_rank_fields
    from sickle_tpu.ops.trim import apply_rank_lut, decode_fields

    rng = np.random.default_rng(3)
    levels = np.array([35, 45, 56, 70], np.uint8)  # NovaSeq-style chars
    qual = rng.choice(levels, (32, 64)).astype(np.uint8)
    qual[0, 40:] = 0  # padding
    qual[5] = 0
    got_levels = qual_levels(qual)
    np.testing.assert_array_equal(got_levels, levels)
    p = 3  # ceil(log2(4+1))
    buf = qual_rank_fields(qual, levels, p)
    assert buf.shape == (32, p * 8)
    v = np.asarray(decode_fields(jnp.asarray(buf), p, 64))
    vref = np.searchsorted(levels, qual.reshape(-1), side="right").reshape(32, 64)
    np.testing.assert_array_equal(v, vref)
    lut = np.zeros(1 << p, np.int32)
    lut[1:5] = levels.astype(np.int32) - 33
    q = np.asarray(apply_rank_lut(jnp.asarray(v).astype(jnp.int32),
                                  jnp.asarray(lut)))
    qref = np.where(qual > 0, qual.astype(np.int32) - 33, 0)
    np.testing.assert_array_equal(q, qref)

    # numpy fallback path agrees with the C++ path
    if native.available():
        import sickle_tpu.io.native as nat
        real = nat.get_lib
        try:
            nat.get_lib = lambda: None
            buf_np = qual_rank_fields(qual, levels, p)
        finally:
            nat.get_lib = real
        np.testing.assert_array_equal(buf_np, buf)
