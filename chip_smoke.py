#!/usr/bin/env python
"""Smoke run of the trimmer on the GPU: the device kernels, then the CLI
end to end, each checked exactly against the C++ host kernel and the
scalar oracle.

    python chip_smoke.py             # one card: kernel + end-to-end phases
    python chip_smoke.py --four      # four cards: the mesh path against one
                                     # card, and no other phase
    python chip_smoke.py --rehearse  # this script's own dry run on the CPU at
                                     # tiny sizes (no chip result)

Everything runs in this one process, one phase after another, so only one
JAX process ever holds a card.  Inputs come from the seeded generator
(sickle_tpu.tools.synth_fastq) and live in a temporary directory that is
removed when the phase ends.  Any failed check raises: the script then
exits non-zero and prints no "ok" line.  Its last line is

    {"ok": true, "device": {"platform": "gpu", "kind": "...", "count": 1}}
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import filecmp
import functools
import io
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
import types

HERE = os.path.dirname(os.path.abspath(__file__))
# device memory bandwidth by device_kind (NVIDIA H100 data sheet); a kind
# not listed gets no share printed, never an assumed peak
HBM_BYTES_PER_S = {"NVIDIA H100 80GB HBM3": 3.35e12}

FULL = dict(se=4_000_000, pe=2_000_000, binned=1_000_000, ntrunc=1_000_000,
            rows=65_536, long_reads=256, oracle_reads=20_000,
            oracle_rows=2_000, oracle_long=32, iters=30)
REHEARSAL = dict(se=20_000, pe=10_000, binned=8_000, ntrunc=8_000,
                 rows=2_048, long_reads=8, oracle_reads=2_000,
                 oracle_rows=500, oracle_long=4, iters=3)
TRIM_ARGS = ["-t", "sanger", "-q", "20", "-l", "20"]


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line(rehearse: bool) -> str:
    if rehearse:
        return "no card (rehearsal on the CPU)"
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"],
                       capture_output=True, text=True, timeout=120)
    check(r.returncode == 0 and r.stdout.strip(),
          f"nvidia-smi failed: {r.stderr.strip()}")
    return r.stdout.strip()


# ---------------------------------------------------------------------------
# set-up
# ---------------------------------------------------------------------------


def setup(rehearse: bool, n_devices: int):
    """Pin JAX to the card (no silent CPU fallback), import the package
    from this checkout, and report what the process runs on."""
    os.environ["JAX_PLATFORMS"] = "cpu" if rehearse else "cuda"
    if rehearse and n_devices > 1:
        os.environ["XLA_FLAGS"] = (
            os.environ.get("XLA_FLAGS", "")
            + f" --xla_force_host_platform_device_count={n_devices}").strip()
    sys.path.insert(0, HERE)
    import jax

    import sickle_tpu
    from sickle_tpu.io import native

    pkg_root = os.path.dirname(os.path.dirname(os.path.abspath(
        sickle_tpu.__file__)))
    check(pkg_root == HERE, f"imported the package from {pkg_root}, "
          f"not from this checkout ({HERE})")
    backend = jax.default_backend()
    check(backend == ("cpu" if rehearse else "gpu"),
          f"JAX backend is {backend!r}, not the GPU")
    devs = jax.devices()
    check(len(devs) >= n_devices,
          f"{len(devs)} device(s), {n_devices} needed")
    log(f"jax {jax.__version__}: backend={backend} "
        f"device_kind={devs[0].device_kind} devices={len(devs)}")
    log(f"compile cache: {jax.config.jax_compilation_cache_dir}")
    log(f"native host library: built={native.available()} "
        f"inflate={native.inflate_backend()}")
    check(native.available(), "the native host library did not build")
    return devs[:n_devices]


# ---------------------------------------------------------------------------
# kernel phase
# ---------------------------------------------------------------------------


def _time(f, args, iters: int):
    """(median ms of synchronous calls, ms per call when ``iters`` calls
    are queued back to back) over warm iterations."""
    import jax
    import numpy as np

    for _ in range(3):
        jax.block_until_ready(f(*args))
    ts = []
    for _ in range(iters):
        t0 = time.perf_counter()
        jax.block_until_ready(f(*args))
        ts.append(time.perf_counter() - t0)
    t0 = time.perf_counter()
    jax.block_until_ready([f(*args) for _ in range(iters)])
    queued = (time.perf_counter() - t0) / iters
    return float(np.median(ts)) * 1e3, queued * 1e3


def _report_time(name, f, args, nbytes, iters):
    import jax

    sync_ms, queued_ms = _time(f, args, iters)
    peak = HBM_BYTES_PER_S.get(jax.devices()[0].device_kind)
    share = (f"{nbytes / (queued_ms * 1e-3) / peak:.2%} of "
             f"{peak / 1e12:.2f} TB/s" if peak else
             "share not measured (no peak for this device kind)")
    log(f"  time {name}: {sync_ms:.4f} ms/batch synchronous, "
        f"{queued_ms:.4f} ms/batch queued; {nbytes} B in+out = {share}")


def _device_fn(params, raw: bool, rows: int):
    from sickle_tpu.engine.pipeline import _device_cuts_fn

    if raw:
        os.environ["SICKLE_TPU_NO_PLANES"] = "1"
    try:
        return _device_cuts_fn(params, slice_rows=rows, inflight=2)
    finally:
        os.environ.pop("SICKLE_TPU_NO_PLANES", None)


def _check_cuts(name, seq, qual, lens, params, got, n_oracle):
    """(five, three, flagged) of the device step == C++ host kernel for
    every read, and == the scalar oracle for the first ``n_oracle``."""
    import numpy as np

    from sickle_tpu import oracle
    from sickle_tpu.ops.trim_host import compute_cuts_host

    five, three, bad = got
    hf, ht, hb = compute_cuts_host(seq if params.trunc_n else None, qual,
                                   lens, params)
    n = lens.size
    check(np.array_equal(five[:n], hf) and np.array_equal(three[:n], ht),
          f"{name}: device cuts differ from the C++ host kernel in "
          f"{int(((five[:n] != hf) | (three[:n] != ht)).sum())} reads")
    check(np.array_equal(bad[:n] < lens, hb < lens),
          f"{name}: quality flags differ from the C++ host kernel")
    for r in range(min(n_oracle, n)):
        ln = int(lens[r])
        want = oracle.sliding_window_cuts(
            bytes(seq[r, :ln]), bytes(qual[r, :ln]),
            qualtype=params.qualtype, qual_threshold=params.qual_threshold,
            length_threshold=params.length_threshold,
            trunc_n=params.trunc_n, compat=params.compat)
        check(want == (int(five[r]), int(three[r])),
              f"{name}: read {r} cuts {(int(five[r]), int(three[r]))} "
              f"!= oracle {want}")
    log(f"  exact {name}: {n} reads == C++ host kernel, first "
        f"{min(n_oracle, n)} == oracle; kept {int((three[:n] >= 0).sum())}")


def kernel_phase(sz) -> None:
    """Each shape through the engine's device step (wire plan, dispatch,
    packed result) checked exactly; then its step program timed on
    device-resident input, beside the alternative forms the H100 decided
    against (PERF.md, "Kernel decisions on the H100")."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from sickle_tpu.constants import QualityType
    from sickle_tpu.engine.pipeline import _materialize
    from sickle_tpu.ops import TrimParams
    from sickle_tpu.ops.trim import compute_cuts
    from sickle_tpu.tools.synth_fastq import synth_reads

    log("== kernel phase")
    B, iters = sz["rows"], sz["iters"]
    base = TrimParams(qualtype=QualityType.SANGER, qual_threshold=20,
                      length_threshold=20)
    ntrunc = dataclasses.replace(base, trunc_n=True)
    shapes = [
        # name, params, generator keywords, wire allowed, uniform length
        (f"uniform {B}x152 raw", base,
         dict(n=B, seed=21, trimmed_frac=0.0), False, 150),
        (f"uniform {B}x152 band wire", base,
         dict(n=B, seed=21, trimmed_frac=0.0), True, 150),
        (f"ragged 30-150 bp {B}x152 raw", base,
         dict(n=B, seed=22, read_len=151, min_len=30, trimmed_frac=1.0),
         False, None),
        (f"ragged 30-150 bp {B}x152 band wire", base,
         dict(n=B, seed=22, read_len=151, min_len=30, trimmed_frac=1.0),
         True, None),
        (f"binned {B}x152 rank wire", base,
         dict(n=B, seed=23, trimmed_frac=0.0, binned=True), True, 150),
        (f"-n N-rich {B}x152", ntrunc,
         dict(n=B, seed=24, trimmed_frac=0.0, n_rich_frac=0.5), False, 150),
        (f"long 10-50 kbp {sz['long_reads']}x50000", base,
         dict(n=sz["long_reads"], seed=25, read_len=50_000, min_len=10_000,
              trimmed_frac=1.0), False, None),
    ]

    def derive(qual):
        lane = jax.lax.broadcasted_iota(jnp.int32, qual.shape, 1)
        return jnp.min(jnp.where(qual == 0, lane, qual.shape[1]), axis=1)

    for name, params, gen, wire, ul in shapes:
        kw = dict(gen)
        n = kw.pop("n")
        seq, qual, lens = synth_reads(n, **kw)
        pad = (-qual.shape[1]) % 8
        seq = np.pad(seq, ((0, 0), (0, pad)))
        qual = np.pad(qual, ((0, 0), (0, pad)))
        L = qual.shape[1]
        fn = _device_fn(params, raw=not wire, rows=B)
        got = _materialize(fn(seq, qual, lens, qual_clean=True), n)
        check(fn.n_device == 1, f"{name}: the device step did not run")
        if wire:
            check(fn.last_h2d < qual.nbytes,
                  f"{name}: the compressed wire was not used "
                  f"({fn.last_h2d} B for {qual.nbytes} B of rows)")
        n_oracle = sz["oracle_long"] if L > 1024 else sz["oracle_rows"]
        _check_cuts(name, seq, qual, lens, params, got, n_oracle)

        # the step program alone, on device-resident input
        steps = fn.steps(ul)
        out_b = 4 * n if L < 32766 else 12 * n
        if params.trunc_n:
            x = jax.device_put(np.stack([seq, qual]))
            _report_time(f"{name} step", steps["sq"], (x,),
                         x.nbytes + out_b, iters)
        elif wire:
            packed = types.SimpleNamespace(qual=qual, qual_clean=True)
            fn.prepare(packed)
            (mode, arg, p), pieces = packed.wire
            buf = jax.device_put(pieces[0])
            if mode == "rank":
                lut = np.zeros(1 << p, np.int32)
                lut[1:1 + arg.size] = arg.astype(np.int32) - 33
                step = functools.partial(steps["rank"], L=L)
                args = (buf, jax.device_put(lut))
            else:
                step = functools.partial(steps["planes"], L=L)
                args = (buf, jax.device_put(np.int32(arg - 33)))
            _report_time(f"{name} step ({mode} p={p})", step, args,
                         buf.nbytes + out_b, iters)
        else:
            x = jax.device_put(qual)
            _report_time(f"{name} step", steps["q"], (x,),
                         x.nbytes + out_b, iters)
            if ul is not None:
                # the int32 accumulator the int16 gate is measured against
                os.environ["SICKLE_TPU_NO_I16"] = "1"
                try:
                    f32 = jax.jit(lambda q: compute_cuts(
                        q, q, derive(q), params, uniform_len=ul)[:2])
                    jax.block_until_ready(f32(x))
                finally:
                    os.environ.pop("SICKLE_TPU_NO_I16", None)
                _report_time(f"{name} int32 accumulator", f32, (x,),
                             x.nbytes + 8 * n, iters)
            else:
                # the shift formulation the gather default is measured
                # against (exact too: checked here)
                fs = jax.jit(lambda q: compute_cuts(
                    q, q, derive(q), params, formulation="shift"))
                five, three, bad = (np.asarray(a) for a in fs(x))
                check(np.array_equal(five, got[0][:n])
                      and np.array_equal(three, got[1][:n]),
                      f"{name}: shift formulation differs from gather")
                _report_time(f"{name} shift formulation", fs, (x,),
                             x.nbytes + 12 * n, iters)


# ---------------------------------------------------------------------------
# end-to-end phase
# ---------------------------------------------------------------------------


def run_cli(args):
    """``sickle <args> --metrics`` in this process; returns (stdout,
    metrics summary, seconds)."""
    from sickle_tpu import cli

    out, err = (io.TextIOWrapper(io.BytesIO(), encoding="utf-8")
                for _ in range(2))
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = cli.main(list(args) + ["--metrics"])
    dt = time.perf_counter() - t0
    out.flush()
    err.flush()
    stdout = out.buffer.getvalue().decode()
    stderr = err.buffer.getvalue().decode()
    check(rc == 0, f"sickle {' '.join(args)} exited {rc}: {stderr[-3000:]}")
    lines = [ln for ln in stderr.splitlines() if ln.startswith("metrics: ")]
    check(lines, f"sickle {' '.join(args)} printed no metrics")
    return stdout, json.loads(lines[-1][len("metrics: "):]), dt


def head_records(path: str, k: int) -> bytes:
    """The first ``k`` FASTQ records of ``path`` (4-line records)."""
    import numpy as np

    with open(path, "rb") as f:
        blob = f.read(k * 1024)
    nl = np.flatnonzero(np.frombuffer(blob, np.uint8) == 0x0A)
    if nl.size < 4 * k:
        return blob
    return blob[: int(nl[4 * k - 1]) + 1]


def starts_with(path: str, want: bytes) -> bool:
    with open(path, "rb") as f:
        return f.read(len(want)) == want


@dataclasses.dataclass
class Case:
    name: str
    kind: str  # "se" or "pe" (two files)
    n: int  # reads, or pairs
    seed: int
    gen: dict  # generator keywords
    flags: list  # extra CLI flags


def _cli_args(case: Case, mode: str, devices, ins, outdir):
    if case.kind == "se":
        outs = [os.path.join(outdir, "out.fastq")]
        args = ["se", "-f", ins[0], "-o", outs[0]]
    else:
        outs = [os.path.join(outdir, f) for f in ("o1.fastq", "o2.fastq",
                                                  "singles.fastq")]
        args = ["pe", "-f", ins[0], "-r", ins[1], "-o", outs[0],
                "-p", outs[1], "-s", outs[2]]
    args += TRIM_ARGS + case.flags + ["--cuts", mode]
    if devices is not None:
        args += ["--devices", str(devices)]
    return args, outs


def _oracle_prefix(case: Case, ins, outs, k: int) -> None:
    """The first ``k`` reads (pairs) trim to the oracle's exact bytes."""
    from sickle_tpu import oracle
    from sickle_tpu.constants import QualityType

    kw = dict(qualtype=QualityType.SANGER, qual_threshold=20,
              length_threshold=20, trunc_n="-n" in case.flags)
    if case.kind == "se":
        want, _ = oracle.trim_se(head_records(ins[0], k), **kw)
        wants = [want]
    else:
        w1, w2, ws, _ = oracle.trim_pe(head_records(ins[0], k),
                                       head_records(ins[1], k), **kw)
        wants = [w1, w2, ws]
    check(wants[0], f"{case.name}: the oracle kept none of the first {k}")
    for path, want in zip(outs, wants):
        check(starts_with(path, want),
              f"{case.name}: output {os.path.basename(path)} differs from "
              f"the oracle within the first {k} reads")
    log(f"  exact {case.name}: first {k} reads == oracle")


def run_case(case: Case, runs, card: str, k_oracle: int) -> None:
    """Generate ``case``'s input, trim it once per ``(label, --cuts mode,
    --devices)`` run, and require every run's output bytes and summary to
    equal the first run's, and the first run's to begin with the
    oracle's.  Device runs must have computed every chunk on the
    device."""
    from sickle_tpu.tools.synth_fastq import write_fastq

    td = tempfile.mkdtemp(prefix="sickle_smoke_")
    try:
        t0 = time.perf_counter()
        ins = [os.path.join(td, f"in{m}.fastq")
               for m in ((1, 2) if case.kind == "pe" else (1,))]
        for mate, path in enumerate(ins, start=1):
            with open(path, "wb") as f:
                write_fastq(f, case.n, seed=case.seed, mate=mate, **case.gen)
        unit = "pairs" if case.kind == "pe" else "reads"
        log(f"-- {case.name}: {case.n} {unit} "
            f"({sum(os.path.getsize(p) for p in ins)} B) generated in "
            f"{time.perf_counter() - t0:.1f} s")
        ref = None
        for label, mode, devices in runs:
            outdir = os.path.join(td, label.replace(" ", "_"))
            os.mkdir(outdir)
            args, outs = _cli_args(case, mode, devices, ins, outdir)
            stdout, m, dt = run_cli(args)
            chunks = m["chunks"]
            log(f"  {label} (--cuts {mode}): {case.n / dt:,.0f} {unit}/s "
                f"on {card.splitlines()[0]} ({dt:.2f} s); chunks={chunks} "
                f"device_chunks={m['device_chunks']} "
                f"host_chunks={m['host_chunks']} "
                f"rescued_chunks={m['rescued_chunks']}; stage totals ms: "
                + " ".join(f"{k}={m[k]['total_ms']}" for k in
                           ("pack", "dispatch", "fetch", "consume")))
            check(chunks > 0, f"{case.name} {label}: no chunks")
            if mode == "device":
                check(m["device_chunks"] == chunks and m["host_chunks"] == 0,
                      f"{case.name} {label}: the device computed "
                      f"{m['device_chunks']} of {chunks} chunks")
            elif mode == "host":
                # indexed host cuts take a pe chunk one mate at a time
                check(m["device_chunks"] == 0
                      and m["host_chunks"] >= chunks,
                      f"{case.name} {label}: host mode used the device")
            else:
                check(m["device_chunks"] + m["host_chunks"] >= chunks,
                      f"{case.name} {label}: chunks unaccounted for")
            if ref is None:
                ref = (label, stdout, outs)
                _oracle_prefix(case, ins, outs, k_oracle)
                continue
            check(stdout == ref[1], f"{case.name}: {label} summary differs "
                  f"from {ref[0]}:\n{stdout}\nvs\n{ref[1]}")
            for mine, theirs in zip(outs, ref[2]):
                check(filecmp.cmp(mine, theirs, shallow=False),
                      f"{case.name}: {label} output "
                      f"{os.path.basename(mine)} differs from {ref[0]}")
            log(f"  identical {case.name}: {label} == {ref[0]} "
                f"({sum(os.path.getsize(p) for p in outs)} B, summary)")
            shutil.rmtree(outdir)
        log("  summary: " + " ".join(ref[1].split()))
    finally:
        shutil.rmtree(td, ignore_errors=True)


def e2e_phase(sz, card: str) -> None:
    log("== end-to-end phase")
    one = [("device", "device", None), ("host", "host", None)]
    cases = [
        (Case("se", "se", sz["se"], 31, {}, []),
         one + [("auto", "auto", None)]),
        (Case("pe two-file", "pe", sz["pe"], 32, {}, []), one),
        (Case("binned se", "se", sz["binned"], 33, {"binned": True}, []),
         one),
        (Case("se -n", "se", sz["ntrunc"], 34, {}, ["-n"]), one),
    ]
    for case, runs in cases:
        run_case(case, runs, card, sz["oracle_reads"])


# ---------------------------------------------------------------------------
# four-card phase
# ---------------------------------------------------------------------------


def shard_check(sz, devs) -> None:
    """One batch through the row-sharded device step: each card holds
    its own row shard of the result, and the cuts are exact."""
    import numpy as np

    from sickle_tpu.constants import QualityType
    from sickle_tpu.engine.pipeline import _materialize
    from sickle_tpu.ops import TrimParams
    from sickle_tpu.parallel import data_mesh, sharded_cuts_fn
    from sickle_tpu.tools.synth_fastq import synth_reads

    B = sz["rows"]
    params = TrimParams(qualtype=QualityType.SANGER, qual_threshold=20,
                        length_threshold=20)
    fn = sharded_cuts_fn(params, data_mesh(len(devs)), slice_rows=B)
    seq, qual, lens = synth_reads(B, seed=41, trimmed_frac=0.0)
    seq = np.pad(seq, ((0, 0), (0, 2)))
    qual = np.pad(qual, ((0, 0), (0, 2)))
    res = fn(seq, qual, lens, qual_clean=True)
    arrays = list(res.futs)
    check(arrays, "the sharded step returned no device arrays")
    for arr in arrays:
        shards = arr.addressable_shards
        held = {s.device.id: s.data.shape for s in shards}
        log(f"  result shards: {held}")
        check(sorted(held) == sorted(d.id for d in devs),
              f"result shards on devices {sorted(held)}, "
              f"not on all of {[d.id for d in devs]}")
        check(all(shape[-1] == arr.shape[-1] // len(devs)
                  for shape in held.values()),
              "row shards are not an even split")
    _check_cuts(f"sharded {B}x152 over {len(devs)} cards", seq, qual, lens,
                params, _materialize(res, B), sz["oracle_rows"])
    for d in devs:
        stats = d.memory_stats() or {}
        log(f"  device {d.id}: peak_bytes_in_use="
            f"{stats.get('peak_bytes_in_use', 'n/a')}")


def four_phase(sz, card: str, devs) -> None:
    log(f"== four-card phase ({len(devs)} cards)")
    shard_check(sz, devs)
    runs = [("4 cards", "device", len(devs)), ("1 card", "device", 1)]
    run_case(Case("se", "se", sz["se"], 31, {}, []), runs, card,
             sz["oracle_reads"])
    run_case(Case("pe two-file", "pe", sz["pe"], 32, {}, []), runs, card,
             sz["oracle_reads"])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Smoke run of the trimmer on the GPU.")
    ap.add_argument("--four", action="store_true",
                    help="run the four-card mesh path against one card "
                         "and no other phase")
    ap.add_argument("--rehearse", action="store_true",
                    help="dry run of this script on the CPU at tiny sizes")
    a = ap.parse_args(argv)
    n_dev = 4 if a.four else 1
    card = card_line(a.rehearse)
    log(f"card: {card}")
    devs = setup(a.rehearse, n_dev)
    sz = REHEARSAL if a.rehearse else FULL
    t0 = time.perf_counter()
    if a.four:
        four_phase(sz, card, devs)
    else:
        kernel_phase(sz)
        e2e_phase(sz, card)
    log(f"all phases passed in {time.perf_counter() - t0:.1f} s")
    log(f"card: {card}")
    import jax

    d = jax.devices()[0]
    result = {"ok": True, "device": {"platform": d.platform,
                                     "kind": d.device_kind,
                                     "count": len(jax.devices())}}
    if a.rehearse:
        result["rehearsal"] = True
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
