#!/usr/bin/env python
"""End-to-end benchmark: file -> trimmed file through the engine.

    python bench.py [--reads N] [--passes K] [--seed S] [--rehearse]

Inputs come from the seeded generator (sickle_tpu.tools.synth_fastq):
150 bp Illumina-like reads, trimmed with the tool defaults
(``-t sanger -q 20 -l 20``).  Rows, each timed over ``--passes`` passes
after an untimed warm pass:

* ``se``           plain file -> plain file, the default (hybrid) step
* ``pe``           two plain files, pairs/s
* ``gzip_in``      BGZF-compressed input
* ``binned_se``    NovaSeq 4-level qualities (the rank wire)
* ``device_only``  the device step alone, no host route

Every row reports its median and best rate, the chunk routes of its last
pass, and the number of XLA compilations inside its timed passes (the
device programs are compiled ahead of time; any inline compile shows
here).  The last stdout line is one JSON object naming the device and,
on a GPU, the card's name and power limit.  The benchmark refuses to run
without a GPU unless ``--rehearse`` (tiny sizes, CPU) is given.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time

_COMPILES = {"n": 0}


def log(text):
    sys.stderr.write(f"[bench] {text}\n")
    sys.stderr.flush()


def _install_compile_counter():
    """Count XLA compilations through JAX's monitoring events.  An
    unavailable hook is an error: a count of 0 must mean none happened."""
    from jax._src import monitoring

    def _on_event(event, **kw):
        if "compile" in event:
            _COMPILES["n"] += 1

    monitoring.register_event_listener(_on_event)


def _card():
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"],
                       capture_output=True, text=True, timeout=120)
    if r.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {r.stderr.strip()}")
    return r.stdout.strip().splitlines()[0]


def measured(name, n_units, run, passes):
    """One warm pass, then ``passes`` timed passes of ``run(metrics)``."""
    from sickle_tpu.utils.metrics import Metrics

    run(Metrics())
    rates, compiles0, m = [], _COMPILES["n"], None
    for i in range(passes):
        m = Metrics()
        t0 = time.perf_counter()
        n = run(m)
        dt = time.perf_counter() - t0
        if n != n_units:
            raise RuntimeError(f"{name}: processed {n} of {n_units}")
        rates.append(n_units / dt)
        log(f"{name} pass {i}: {n_units} in {dt:.3f} s -> "
            f"{rates[-1]:,.0f}/s")
    s = m.summary()
    return {
        "median": sorted(rates)[len(rates) // 2],
        "best": max(rates),
        "passes": rates,
        "chunks": s["chunks"],
        "device_chunks": s["device_chunks"],
        "host_chunks": s["host_chunks"],
        "rescued_chunks": s["rescued_chunks"],
        "inline_compiles": _COMPILES["n"] - compiles0,
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reads", type=int, default=1_000_000,
                    help="reads per se row (pe: half as many pairs)")
    ap.add_argument("--passes", type=int, default=3)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--rehearse", action="store_true",
                    help="allow the CPU backend (numbers are not device "
                         "metrics)")
    a = ap.parse_args(argv)

    import jax

    _install_compile_counter()
    dev = jax.devices()[0]
    if dev.platform != "gpu" and not a.rehearse:
        raise SystemExit(f"bench: backend is {dev.platform!r}, not a GPU "
                         "(pass --rehearse for a CPU dry run)")
    card = _card() if dev.platform == "gpu" else "not measured (no card)"
    log(f"backend={dev.platform} kind={dev.device_kind} "
        f"devices={len(jax.devices())} card={card}")

    from sickle_tpu.constants import QualityType
    from sickle_tpu.engine import EngineConfig, run_pe, run_se
    from sickle_tpu.engine.pipeline import default_cuts_fn
    from sickle_tpu.io.compression import BgzfWriter, open_input, open_output
    from sickle_tpu.ops import TrimParams
    from sickle_tpu.tools.synth_fastq import write_fastq

    params = TrimParams(qualtype=QualityType.SANGER, qual_threshold=20,
                        length_threshold=20)
    cfg0 = EngineConfig()
    cuts_fn = default_cuts_fn(params, cfg0)
    dev_fn = default_cuts_fn(params, dataclasses.replace(cfg0, hybrid=False))
    n_se, n_pe = a.reads, max(a.reads // 2, 1)

    rows = {}
    with tempfile.TemporaryDirectory() as td:
        src = os.path.join(td, "se.fastq")
        src_b = os.path.join(td, "binned.fastq")
        src_f = os.path.join(td, "r1.fastq")
        src_r = os.path.join(td, "r2.fastq")
        src_gz = os.path.join(td, "se.fastq.gz")
        t0 = time.perf_counter()
        for path, n, mate, kw in ((src, n_se, 1, {}),
                                  (src_b, n_se, 1, {"binned": True}),
                                  (src_f, n_pe, 1, {}), (src_r, n_pe, 2, {})):
            with open(path, "wb") as f:
                write_fastq(f, n, seed=a.seed, mate=mate, **kw)
        w = BgzfWriter(src_gz)
        with open(src, "rb") as f:
            w.write(f.read())
        w.close()
        log(f"inputs generated in {time.perf_counter() - t0:.1f} s")

        # compile the steady-state programs ahead of the timed passes:
        # raw rows, the band wire (6 bits) and the rank wire (3 bits)
        t0 = time.perf_counter()
        for fn in (cuts_fn, dev_fn):
            fn.warmup_aot(152, min_rows=32, planes=(6,), ranks=(3,),
                          read_len=150)
            fn.warmup_aot(152, min_rows=32, planes=(6,), ranks=(3,))
        log(f"AOT warmup in {time.perf_counter() - t0:.1f} s")
        out = os.path.join(td, "out.fastq")

        def se_row(path, fn, opener=lambda p: open(p, "rb")):
            def run(m):
                cfg = dataclasses.replace(cfg0, metrics=m)
                with opener(path) as fin:
                    fout = open_output(out)
                    try:
                        return run_se(fin, fout, params, cfg=cfg,
                                      cuts_fn=fn).total
                    finally:
                        fout.close()
            return run

        def pe_run(m):
            cfg = dataclasses.replace(cfg0, metrics=m)
            o = [open_output(os.path.join(td, f"pe{i}.fastq"))
                 for i in range(3)]
            try:
                with open(src_f, "rb") as f1, open(src_r, "rb") as f2:
                    return run_pe(f1, f2, out1=o[0], out2=o[1],
                                  singles_out=o[2], params=params, cfg=cfg,
                                  cuts_fn=cuts_fn).total // 2
            finally:
                for w in o:
                    w.close()

        rows["se"] = measured("se", n_se, se_row(src, cuts_fn), a.passes)
        rows["pe"] = measured("pe", n_pe, pe_run, a.passes)
        rows["gzip_in"] = measured("gzip_in", n_se,
                                   se_row(src_gz, cuts_fn, open_input),
                                   a.passes)
        rows["binned_se"] = measured("binned_se", n_se,
                                     se_row(src_b, cuts_fn), a.passes)
        rows["device_only"] = measured("device_only", n_se,
                                       se_row(src, dev_fn), a.passes)
    cuts_fn.close()

    for name, r in rows.items():
        unit = "pairs/s" if name == "pe" else "reads/s"
        r["unit"] = unit
        log(f"{name}: median {r['median']:,.0f} {unit}, best "
            f"{r['best']:,.0f} (chunks {r['chunks']}: device "
            f"{r['device_chunks']}, host {r['host_chunks']}, rescued "
            f"{r['rescued_chunks']}; inline compiles "
            f"{r['inline_compiles']}) on {card}")
    print(json.dumps({
        "metric": "se_reads_per_s",
        "value": round(rows["se"]["median"]),
        "unit": "reads/s",
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices()), "card": card},
        "reads": n_se, "passes": a.passes, "seed": a.seed,
        "rows": rows,
    }))


if __name__ == "__main__":
    main()
