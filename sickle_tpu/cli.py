"""Drop-in ``sickle se|pe`` command-line interface.

Flag-compatible with the reference CLI (same short/long options, defaults,
required-argument checks, usage/summary text shapes and exit codes —
src/sickle.cpp:41-84, src/trim_single.cpp:83-211, src/trim_paired.cpp:109-263),
with these deliberate differences (SURVEY.md §2.4):

* ``pe -M`` is actually implemented (upstream semantics; the fork exits
  with usage).
* pe ``Total input FastQ records`` is correct (the fork reports only the
  last batch's locals).
* gzip output works (streamed; the fork's gzprintf misuse emits nothing).
* output order always equals input order at any parallelism.
* new flags: ``--compat {1.33,fork}`` (comment-line rewrite + -n N-order;
  default 1.33), ``--devices N`` (shard batches over N chips),
  ``--profile DIR`` (jax profiler trace).

``-a/--threads`` sets the host worker-thread count (parse/pack/assemble
parallelism — reference src/trim_single.cpp:163 semantics mapped to our
intra-op pools); ``-b/--batch`` is accepted for compatibility, with batch
size record-counted internally (fixed device shapes), derived from -b.
"""

from __future__ import annotations

import dataclasses
import getopt
import os
import sys
from typing import List, Optional

from .constants import (
    AUTHORS,
    CLI_QUALITY_TYPES,
    Compat,
    PROGRAM_NAME,
    VERSION,
)
from .engine import EngineConfig, run_pe, run_se
from .io import native
from .io.compression import open_input, open_output
from .oracle import PECounters, SECounters, SickleError
from .ops import TrimParams


def _merge_counters(counters):
    """Sum counters across hosts in a multi-host run (psum over the
    coordination fabric); no-op single-host.  The printed summary then
    reports GLOBAL totals on every host."""
    import jax

    if jax.process_count() == 1:
        return counters
    from .parallel.dist import allreduce_host_counters

    if isinstance(counters, SECounters):
        t, k, d = allreduce_host_counters(
            [counters.total, counters.kept, counters.discarded]
        )
        return SECounters(total=t, kept=k, discarded=d)
    vals = allreduce_host_counters([
        counters.total, counters.kept_p, counters.kept_s1, counters.kept_s2,
        counters.discard_p, counters.discard_s1, counters.discard_s2,
    ])
    return PECounters(*vals)

class _Dist:
    """Multi-host run context (--dist).

    Wires ``jax.distributed`` (SURVEY.md §5.8), after which the CLI shards
    plain-file inputs by record-aligned byte ranges (parallel.dist), gives
    each host its own ``<output>.shard<i>`` (concatenating shards in shard
    order reproduces the single-host bytes; gzip shards concatenate into a
    valid multi-member stream too), and prints the psum-merged GLOBAL
    summary on host 0 only.
    """

    def __init__(self, enabled: bool, coordinator: Optional[str],
                 num_processes: Optional[int], process_id: Optional[int]):
        self.pid, self.nproc = 0, 1
        if not enabled:
            return
        import jax

        from .parallel.dist import init_distributed

        init_distributed(coordinator, num_processes, process_id)
        self.pid = jax.process_index()
        self.nproc = jax.process_count()

    @property
    def active(self) -> bool:
        return self.nproc > 1

    def shard_path(self, path: Optional[str]) -> Optional[str]:
        if path is None or not self.active:
            return path
        return f"{path}.shard{self.pid}"

    def check_splittable(self, *paths) -> Optional[str]:
        """Error text if any input cannot be byte-split across hosts.

        Plain files split by record-aligned byte ranges; BGZF gzip
        (blocked — bgzip/samtools output and this framework's own ``-g``
        output) splits in uncompressed space via its block index.  Only
        SERIAL gzip is rejected: it has no splittable address space.
        """
        if not self.active:
            return None
        from .io import native
        from .io.compression import BgzfReader

        for fp in paths:
            if fp is None:
                continue
            try:
                with open(fp, "rb") as f:
                    if f.read(2) != b"\x1f\x8b":
                        continue
                if native.available() and BgzfReader.try_open(fp) is not None:
                    continue  # block-splittable; sharded in u-space
                return (
                    "****Error: multi-host runs need plain or BGZF "
                    "(block-splittable) input; serial gzip inputs must "
                    f"be pre-sharded per host ('{fp}').\n\n"
                )
            except FileNotFoundError:
                pass  # open_input reports missing files with parity text
            # other OSErrors (permissions, IO) propagate: downstream opens
            # would hit them anyway, and swallowing here would silently
            # disable the splittability check
        return None


DEFAULT_RECORDS_PER_CHUNK = 1 << 16


def _msg(debug: bool, text: str) -> None:
    if debug:
        from .utils import set_debug
        from .utils.logging import msg as _log_msg

        set_debug(True)
        _log_msg(text)


def _reader_msg(debug: bool, compat: Compat, path) -> None:
    """Stdout parity for "Building reader for <path>".

    The fork prints this line UNCONDITIONALLY from the reader ctor
    (/root/reference/src/GZReader.cpp:12 — a bare std::cout, not gated on
    _DEBUGMODE_), so even a debug-disabled fork build emits it on every
    clean run (it is in the recorded goldens' stdout).  --compat fork
    therefore always prints it; upstream 1.33 has no such line, so the
    default compat stays quiet unless -d."""
    if compat == Compat.FORK:
        sys.stdout.write(f"Building reader for {path}\n")
        sys.stdout.flush()
    else:
        _msg(debug, f"Building reader for {path}")


def main_usage(status: int) -> int:
    sys.stdout.write(
        f"\nUsage: {PROGRAM_NAME} <command> [options]\n\n"
        "Command:\n"
        "pe\tpaired-end sequence trimming\n"
        "se\tsingle-end sequence trimming\n\n"
        "--help, display this help and exit\n"
        "--version, output version information and exit\n\n"
    )
    return status


def version_text() -> str:
    return (
        f"{PROGRAM_NAME} version {VERSION}\n"
        "Copyright (c) 2011 The Regents of University of California, Davis Campus.\n"
        f"{PROGRAM_NAME} is free software and comes with ABSOLUTELY NO WARRANTY.\n"
        "Distributed under the MIT License.\n\n"
        f"Written by {AUTHORS}"
        "Rebuilt as a batched JAX/XLA trimmer with a C++ host path.\n"
    )


SE_USAGE = f"""
Usage: {PROGRAM_NAME} se [options] -f <fastq sequence file> -t <quality type> -o <trimmed fastq file>

Options:
-f, --fastq-file, Input fastq file (required)
-t, --qual-type, Type of quality values (solexa (CASAVA < 1.3), illumina (CASAVA 1.3 to 1.7), sanger (which is CASAVA >= 1.8)) (required)
-o, --output-file, Output trimmed fastq file (required)
-q, --qual-threshold, Threshold for trimming based on average quality in a window. Default 20.
-l, --length-threshold, Threshold to keep a read based on length after trimming. Default 20.
-x, --no-fiveprime, Don't do five prime trimming.
-n, --trunc-n, Truncate sequences at position of first N.
-g, --gzip-output, Output gzipped files.
-a, --threads, Number of host worker threads.
-b, --batch, maximum MB of data to read from the input file at each cycle.
--compat, Behavior where the fork and sickle 1.33 disagree: '1.33' (default, '+' comment rewrite) or 'fork' (comment verbatim).
--devices, Number of accelerator chips to shard each batch over. Default: all.
--profile, Write a JAX profiler trace to the given directory.
--metrics, Print per-chunk pipeline stage timings (pack/dispatch/fetch/write) to stderr at exit.
--checkpoint, Sidecar file making the run restartable (re-run the same command to resume; gzip output resumes at BGZF member boundaries).
--strict, Error on ANY out-of-range quality char (default: only chars the trimming scan touches error, matching sickle 1.33).
--cuts, Compute placement: 'auto' (default: accelerator + host failover/assist), 'hybrid', 'device' (accelerator only), or 'host' (C++ host kernel only, no JAX).
--dist, Join a multi-host run (jax.distributed); each host trims its record-aligned shard of the input into <output>.shard<i> and host 0 prints the merged global summary.
--coordinator, host:port of the jax.distributed coordinator (with --dist; omit only where jax.distributed detects the cluster itself, e.g. under SLURM).
--num-processes, Total processes in the --dist run (omit only under cluster auto-detection).
--process-id, This process's index in the --dist run (omit only under cluster auto-detection).
--quiet, Don't print out any trimming information
--help, display this help and exit
--version, output version information and exit

"""

PE_USAGE = f"""
If you have separate files for forward and reverse reads:
Usage: {PROGRAM_NAME} pe [options] -f <paired-end forward fastq file> -r <paired-end reverse fastq file> -t <quality type> -o <trimmed PE forward file> -p <trimmed PE reverse file> -s <trimmed singles file>

If you have one file with interleaved forward and reverse reads:
Usage: {PROGRAM_NAME} pe [options] -c <interleaved input file> -t <quality type> -m <interleaved trimmed paired-end output> -s <trimmed singles file>

If you have one file with interleaved reads as input and you want ONLY one interleaved file as output:
Usage: {PROGRAM_NAME} pe [options] -c <interleaved input file> -t <quality type> -m <interleaved trimmed output>

Options:
Paired-end separated reads
--------------------------
-f, --pe-file1, Input paired-end forward fastq file (Input files must have same number of records)
-r, --pe-file2, Input paired-end reverse fastq file
-o, --output-pe1, Output trimmed forward fastq file
-p, --output-pe2, Output trimmed reverse fastq file. Must use -s option.

Paired-end interleaved reads
----------------------------
-c, --pe-interleaved, Combined (interleaved) input paired-end fastq
-m, --output-interleaved, Output combined (interleaved) paired-end fastq file. Must use -s option.
-M, --output-n, Output combined (interleaved) file with any discarded read written as a single 'N' record, preserving pairing. Cannot be used with -m or -s.
--------------
-t, --qual-type, Type of quality values (solexa (CASAVA < 1.3), illumina (CASAVA 1.3 to 1.7), sanger (which is CASAVA >= 1.8)) (required)
-s, --output-single, Output trimmed singles fastq file
-q, --qual-threshold, Threshold for trimming based on average quality in a window. Default 20.
-l, --length-threshold, Threshold to keep a read based on length after trimming. Default 20.
-x, --no-fiveprime, Don't do five prime trimming.
-n, --truncate-n, Truncate sequences at position of first N.
-a, --threads, Number of host worker threads.
-b, --batch, maximum MB of data to read from the input file at each cycle.
--compat, Behavior where the fork and sickle 1.33 disagree: '1.33' (default) or 'fork'.
--devices, Number of accelerator chips to shard each batch over. Default: all.
--profile, Write a JAX profiler trace to the given directory.
--metrics, Print per-chunk pipeline stage timings (pack/dispatch/fetch/write) to stderr at exit.
--checkpoint, Sidecar file making the run restartable (re-run the same command to resume; gzip output resumes at BGZF member boundaries).
--strict, Error on ANY out-of-range quality char (default: only chars the trimming scan touches error, matching sickle 1.33).
--cuts, Compute placement: 'auto' (default: accelerator + host failover/assist), 'hybrid', 'device' (accelerator only), or 'host' (C++ host kernel only, no JAX).
--dist, Join a multi-host run (jax.distributed); each host trims its record-aligned shard of the input into <output>.shard<i> and host 0 prints the merged global summary.
--coordinator, host:port of the jax.distributed coordinator (with --dist; omit only where jax.distributed detects the cluster itself, e.g. under SLURM).
--num-processes, Total processes in the --dist run (omit only under cluster auto-detection).
--process-id, This process's index in the --dist run (omit only under cluster auto-detection).
-g, --gzip-output, Output gzipped files.
--quiet, do not output trimming info
--help, display this help and exit
--version, output version information and exit

"""


def _usage_exit(text: str, status: int, msg: Optional[str] = None) -> int:
    sys.stderr.write(text)
    if msg:
        sys.stderr.write(f"{msg}\n\n")
    return status


def _parse_qualtype(optarg: str):
    qt = CLI_QUALITY_TYPES.get(optarg)
    if qt is None:
        sys.stderr.write(f"Error: Quality type '{optarg}' is not a valid type.\n")
    return qt


def _records_per_chunk(batch_mb: Optional[int]) -> int:
    """Map the reference's -b (MB per cycle) to a record count.

    Assumes ~256 bytes/record (150bp reads); clamped so device batches stay
    in a practical range.  The shapes are fixed per run regardless.
    """
    if batch_mb is None:
        return DEFAULT_RECORDS_PER_CHUNK
    recs = (max(batch_mb, 1) << 20) // 256
    return max(4096, min(recs, 1 << 18))


_ACTIVE_CUTS_FN = None  # last built cuts fn; finalized by main()


def _apply_cuts_mode(mode: str):
    """--cuts {auto,hybrid,device,host} -> engine env contract.

    'host' runs the whole pipeline on the C++ host kernel (no accelerator
    backend is initialized); 'device' disables the hybrid dispatcher;
    'hybrid' forces it on; 'auto' (default) restores the engine default
    (hybrid on), so an earlier in-process mode does not leak into this run.
    Returns the mode, or None if unrecognized."""
    mode = mode.strip().lower()
    if mode == "auto":
        os.environ.pop("SICKLE_TPU_CUTS", None)
        os.environ.pop("SICKLE_TPU_HYBRID", None)
    elif mode == "host":
        os.environ["SICKLE_TPU_CUTS"] = "host"
    elif mode == "device":
        os.environ.pop("SICKLE_TPU_CUTS", None)
        os.environ["SICKLE_TPU_HYBRID"] = "0"
    elif mode == "hybrid":
        os.environ.pop("SICKLE_TPU_CUTS", None)
        os.environ["SICKLE_TPU_HYBRID"] = "1"
    else:
        return None
    return mode


def _build_cuts_fn(params: TrimParams, devices: Optional[int], rpc: int):
    """The engine's cuts fn over ``devices`` local devices (default: all);
    returns (fn, rpc').

    One device step serves every device count: with 2+ devices it is
    row-sharded over a 1-D mesh, and rpc is rounded to a multiple of the
    mesh size (and 8).  Local devices only: multi-host runs shard rows
    per host (parallel.mesh)."""
    global _ACTIVE_CUTS_FN
    from .engine.pipeline import default_cuts_fn

    mesh = None
    if os.environ.get("SICKLE_TPU_CUTS") != "host":
        # --cuts host never initializes an accelerator backend
        import jax

        n_avail = len(jax.local_devices())
        n = min(devices or n_avail, n_avail)
        if n > 1:
            from .parallel import data_mesh

            mesh = data_mesh(n)
            mult = max(n, 8)
            rpc = -(-rpc // mult) * mult
    fn = default_cuts_fn(params, mesh=mesh)
    _ACTIVE_CUTS_FN = fn
    return fn, rpc


def _open_resumable(path: str, gzip_out: bool = False):
    """Open an output for checkpointed writing (create if missing).

    gzip outputs open as a resumable BgzfWriter: flushes land on member
    boundaries, so checkpointed sizes are valid truncation points."""
    if gzip_out:
        from .io.compression import BgzfWriter

        return BgzfWriter(path, resumable=True)
    if native.available() and not os.environ.get("SICKLE_TPU_NO_MMAP_OUT"):
        # MmapWriter supports the resume protocol (truncate/seek/tell)
        # and gives checkpointed plain outputs the zero-copy emit path;
        # existing content is KEPT (r+b semantics) for resume_outputs
        from .io.output import MmapWriter

        w = MmapWriter.open_regular(path)
        if w is not None:
            return w
    try:
        return open(path, "r+b")
    except FileNotFoundError:
        return open(path, "w+b")


def _checkpoint_path(base: str) -> str:
    """Per-host checkpoint file in multi-host runs (independent input
    shards advance independently)."""
    import jax

    if jax.process_count() > 1:
        return f"{base}.host{jax.process_index()}"
    return base


class _Profile:
    def __init__(self, trace_dir: Optional[str]):
        self.trace_dir = trace_dir

    def __enter__(self):
        if self.trace_dir:
            import jax

            jax.profiler.start_trace(self.trace_dir)
        return self

    def __exit__(self, *exc):
        if self.trace_dir:
            import jax

            jax.profiler.stop_trace()
        return False


def se_main(argv: List[str]) -> int:
    longopts = [
        "fastq-file=", "output-file=", "qual-type=", "qual-threshold=",
        "length-threshold=", "no-fiveprime", "discard-n", "gzip-output",
        "quiet", "threads=", "batch=", "compat=", "devices=", "profile=",
        "metrics", "checkpoint=", "strict", "cuts=", "dist", "coordinator=",
        "num-processes=", "process-id=", "help", "version",
    ]
    try:
        opts, extra = getopt.gnu_getopt(argv, "df:t:o:q:a:b:l:zxng", longopts)
    except getopt.GetoptError as e:
        sys.stderr.write(f"{e}\n")
        return _usage_exit(SE_USAGE, 1)

    infn = outfn = None
    qualtype = None
    q_thresh, l_thresh = 20, 20
    no_five = trunc_n = gzip_out = quiet = debug = strict = False
    dist_on, coordinator, n_procs, proc_id = False, None, None, None
    batch_mb = None
    devices = None
    compat = Compat.V133
    profile = None
    metrics_on = False
    ckfn = None

    for o, a in opts:
        if o in ("-f", "--fastq-file"):
            infn = a
        elif o in ("-o", "--output-file"):
            outfn = a
        elif o in ("-t", "--qual-type"):
            qualtype = _parse_qualtype(a)
            if qualtype is None:
                return _usage_exit(SE_USAGE, 1)
        elif o in ("-q", "--qual-threshold"):
            q_thresh = int(a)
            if q_thresh < 0:
                sys.stderr.write("Quality threshold must be >= 0\n")
                return 1
        elif o in ("-l", "--length-threshold"):
            l_thresh = int(a)
            if l_thresh < 0:
                sys.stderr.write("Length threshold must be >= 0\n")
                return 1
        elif o in ("-x", "--no-fiveprime"):
            no_five = True
        elif o == "--strict":
            strict = True
        elif o == "--cuts":
            if _apply_cuts_mode(a) is None:
                sys.stderr.write(
                    f"****Error: --cuts must be auto, hybrid, device or host, got '{a}'.\n\n")
                return 1
        elif o == "--dist":
            dist_on = True
        elif o == "--coordinator":
            coordinator = a
        elif o == "--num-processes":
            n_procs = int(a)
        elif o == "--process-id":
            proc_id = int(a)
        elif o in ("-n", "--discard-n"):
            trunc_n = True
        elif o in ("-g", "--gzip-output"):
            gzip_out = True
        elif o in ("-z", "--quiet"):
            quiet = True
        elif o == "-d":
            debug = True
        elif o in ("-a", "--threads"):
            native.set_threads(int(a))
        elif o in ("-b", "--batch"):
            batch_mb = int(a)
        elif o == "--compat":
            compat = Compat(a) if a != "1.33" else Compat.V133
        elif o == "--devices":
            devices = int(a)
        elif o == "--profile":
            profile = a
        elif o == "--metrics":
            metrics_on = True
        elif o == "--checkpoint":
            ckfn = a
        elif o == "--help":
            sys.stdout.write(SE_USAGE)
            return 0
        elif o == "--version":
            sys.stdout.write(version_text())
            return 0

    if qualtype is None or infn is None or outfn is None:
        return _usage_exit(
            SE_USAGE, 1,
            "****Error: Must have quality type, input file, and output file.",
        )
    if infn == outfn:
        sys.stderr.write("****Error: Input file is same as output file.\n\n")
        return 1

    _msg(debug, "Setting se trimming params")
    params = TrimParams(
        qualtype=qualtype,
        qual_threshold=q_thresh,
        length_threshold=l_thresh,
        no_fiveprime=no_five,
        trunc_n=trunc_n,
        compat=compat,
        strict=strict,
    )
    dist = _Dist(dist_on, coordinator, n_procs, proc_id)
    rpc = _records_per_chunk(batch_mb)
    cuts_fn, rpc = _build_cuts_fn(params, devices, rpc)
    cfg = EngineConfig(records_per_chunk=rpc, compat=compat)
    if metrics_on:
        from .utils.metrics import Metrics

        cfg.metrics = Metrics()
    in_off = 0
    if dist.active:
        err = dist.check_splittable(infn)
        if err:
            sys.stderr.write(err)
            return 1
        from .parallel.dist import shard_record_ranges

        in_off, cfg.byte_limit = shard_record_ranges(infn, dist.nproc)[dist.pid]
        outfn = dist.shard_path(outfn)

    counters_in = None
    ck = None
    if ckfn:
        if gzip_out and not native.available():
            sys.stderr.write(
                "****Error: --checkpoint with -g needs the native BGZF "
                "codec (serial gzip has no member-aligned truncation "
                "points).\n\n"
            )
            return 1
        from .engine.checkpoint import TrimCheckpoint, progress_saver, resume_outputs

        ck = TrimCheckpoint(_checkpoint_path(ckfn))
        st = ck.load()

    _msg(debug, "trim_main()")
    _reader_msg(debug, compat, infn)
    try:
        with open_input(infn) as fin:
            if in_off:
                fin.seek(in_off)
            if ck is not None:
                out = _open_resumable(outfn, gzip_out)
                if st is not None:
                    resume_outputs(st, {outfn: out})
                    counters_in = SECounters(**st.counters)
                    cfg.skip_records = st.records_done
                    _msg(debug, f"Resuming at record {st.records_done}")
                cfg.progress_cb = progress_saver(
                    ck, dataclasses.asdict, {outfn: out}
                )
            else:
                out = open_output(outfn, gzip_out)
            try:
                with _Profile(profile):
                    counters = run_se(fin, out, params, cfg=cfg,
                                      cuts_fn=cuts_fn, counters=counters_in)
            finally:
                if out is not sys.stdout.buffer:
                    out.close()
    except FileNotFoundError:
        sys.stderr.write(f"****Error: Could not open input file '{infn}'.\n\n")
        return 1
    except SickleError as e:
        sys.stderr.write(e.message + "\n")
        return e.exit_code

    if cfg.metrics is not None:
        cfg.metrics.report()
    counters = _merge_counters(counters)
    if not quiet and dist.pid == 0:
        sys.stdout.write(
            f"\nSE input file: {infn}\n\n"
            f"Total FastQ records: {counters.total}\n"
            f"FastQ records kept: {counters.kept}\n"
            f"FastQ records discarded: {counters.discarded}\n\n"
        )
    return 0


def pe_main(argv: List[str]) -> int:
    longopts = [
        "qual-type=", "pe-file1=", "pe-file2=", "pe-interleaved=",
        "output-pe1=", "output-pe2=", "output-single=", "output-interleaved=",
        "output-n=", "qual-threshold=", "length-threshold=", "no-fiveprime",
        "truncate-n", "gzip-output", "quiet", "threads=", "batch=",
        "compat=", "devices=", "profile=", "metrics", "checkpoint=",
        "strict", "cuts=", "dist", "coordinator=", "num-processes=",
        "process-id=", "help", "version",
    ]
    try:
        opts, extra = getopt.gnu_getopt(argv, "df:r:c:t:o:p:m:M:s:q:a:b:l:xng", longopts)
    except getopt.GetoptError as e:
        sys.stderr.write(f"{e}\n")
        return _usage_exit(PE_USAGE, 1)

    infn = infn2 = infnc = None
    outfn = outfn2 = outfnc = sfn = None
    n_record_mode = False
    qualtype = None
    q_thresh, l_thresh = 20, 20
    no_five = trunc_n = gzip_out = quiet = debug = strict = False
    dist_on, coordinator, n_procs, proc_id = False, None, None, None
    batch_mb = None
    devices = None
    compat = Compat.V133
    profile = None
    metrics_on = False
    ckfn = None

    for o, a in opts:
        if o in ("-f", "--pe-file1"):
            infn = a
        elif o in ("-r", "--pe-file2"):
            infn2 = a
        elif o in ("-c", "--pe-interleaved"):
            infnc = a
        elif o in ("-o", "--output-pe1"):
            outfn = a
        elif o in ("-p", "--output-pe2"):
            outfn2 = a
        elif o in ("-m", "--output-interleaved"):
            outfnc = a
        elif o in ("-M", "--output-n"):
            outfnc = a
            n_record_mode = True
        elif o in ("-s", "--output-single"):
            sfn = a
        elif o in ("-t", "--qual-type"):
            qualtype = _parse_qualtype(a)
            if qualtype is None:
                return _usage_exit(PE_USAGE, 1)
        elif o in ("-q", "--qual-threshold"):
            q_thresh = int(a)
            if q_thresh < 0:
                sys.stderr.write("Quality threshold must be >= 0\n")
                return 1
        elif o in ("-l", "--length-threshold"):
            l_thresh = int(a)
            if l_thresh < 0:
                sys.stderr.write("Length threshold must be >= 0\n")
                return 1
        elif o in ("-x", "--no-fiveprime"):
            no_five = True
        elif o == "--strict":
            strict = True
        elif o == "--cuts":
            if _apply_cuts_mode(a) is None:
                sys.stderr.write(
                    f"****Error: --cuts must be auto, hybrid, device or host, got '{a}'.\n\n")
                return 1
        elif o == "--dist":
            dist_on = True
        elif o == "--coordinator":
            coordinator = a
        elif o == "--num-processes":
            n_procs = int(a)
        elif o == "--process-id":
            proc_id = int(a)
        elif o in ("-n", "--truncate-n"):
            trunc_n = True
        elif o in ("-g", "--gzip-output"):
            gzip_out = True
        elif o == "--quiet":
            quiet = True
        elif o == "-d":
            debug = True
        elif o in ("-a", "--threads"):
            native.set_threads(int(a))
        elif o in ("-b", "--batch"):
            batch_mb = int(a)
        elif o == "--compat":
            compat = Compat(a) if a != "1.33" else Compat.V133
        elif o == "--devices":
            devices = int(a)
        elif o == "--profile":
            profile = a
        elif o == "--metrics":
            metrics_on = True
        elif o == "--checkpoint":
            ckfn = a
        elif o == "--help":
            sys.stdout.write(PE_USAGE)
            return 0
        elif o == "--version":
            sys.stdout.write(version_text())
            return 0

    if qualtype is None:
        return _usage_exit(PE_USAGE, 1, "****Error: Quality type is required.")
    if not infn and not infnc:
        return _usage_exit(
            PE_USAGE, 1, "****Error: Must have either -f OR -c argument."
        )
    if infnc:
        if infn or infn2 or outfn or outfn2:
            return _usage_exit(
                PE_USAGE, 1,
                "****Error: Cannot have -f, -r, -o, or -p options with -c.",
            )
        if not outfnc:
            return _usage_exit(
                PE_USAGE, 1,
                "****Error: Interleaved input requires -m or -M output.",
            )
        if n_record_mode and sfn:
            return _usage_exit(
                PE_USAGE, 1, "****Error: Cannot use -M with -s."
            )
        # -m without -s is the "only one interleaved output" mode: singles
        # are counted but not written (reference writes them only if sfn,
        # src/trim_paired.cpp:712-726)
    else:
        if not infn2 or not outfn or not outfn2 or not sfn:
            return _usage_exit(
                PE_USAGE, 1,
                "****Error: Using the -f option means you must have the -r, -o, -p, and -s options.",
            )
        if outfnc or n_record_mode:
            return _usage_exit(
                PE_USAGE, 1,
                "****Error: The -f option cannot be used in combination with -c, -m, or -M.",
            )

    params = TrimParams(
        qualtype=qualtype,
        qual_threshold=q_thresh,
        length_threshold=l_thresh,
        no_fiveprime=no_five,
        trunc_n=trunc_n,
        compat=compat,
        strict=strict,
    )
    dist = _Dist(dist_on, coordinator, n_procs, proc_id)
    rpc = _records_per_chunk(batch_mb)
    cuts_fn, rpc = _build_cuts_fn(params, devices, rpc)
    cfg = EngineConfig(records_per_chunk=rpc, compat=compat)
    if metrics_on:
        from .utils.metrics import Metrics

        cfg.metrics = Metrics()
    in_off = in_off2 = 0
    if dist.active:
        err = dist.check_splittable(infnc, infn, infn2)
        if err:
            sys.stderr.write(err)
            return 1
        if infnc:
            from .parallel.dist import shard_record_ranges

            in_off, cfg.byte_limit = shard_record_ranges(
                infnc, dist.nproc, align=2
            )[dist.pid]
        else:
            from .parallel.dist import shard_paired_ranges

            (r1, r2) = shard_paired_ranges(infn, infn2, dist.nproc)[dist.pid]
            in_off, cfg.byte_limit = r1
            in_off2, cfg.byte_limit2 = r2
        outfn = dist.shard_path(outfn)
        outfn2 = dist.shard_path(outfn2)
        outfnc = dist.shard_path(outfnc)
        sfn = dist.shard_path(sfn)

    counters_in = None
    ck = None
    if ckfn:
        if gzip_out and not native.available():
            sys.stderr.write(
                "****Error: --checkpoint with -g needs the native BGZF "
                "codec (serial gzip has no member-aligned truncation "
                "points).\n\n"
            )
            return 1
        from .engine.checkpoint import TrimCheckpoint, progress_saver, resume_outputs

        ck = TrimCheckpoint(_checkpoint_path(ckfn))
        st = ck.load()

    outs = []
    ck_streams = {}

    def out_stream(path):
        if ck is not None:
            s = _open_resumable(path, gzip_out)
            ck_streams[path] = s
        else:
            s = open_output(path, gzip_out)
        outs.append(s)
        return s

    def apply_resume():
        if ck is None:
            return None
        nonlocal counters_in
        if st is not None:
            resume_outputs(st, ck_streams)
            counters_in = PECounters(**st.counters)
            cfg.skip_records = st.records_done
            _msg(debug, f"Resuming at record {st.records_done}")
        cfg.progress_cb = progress_saver(ck, dataclasses.asdict, ck_streams)

    try:
        if infnc:
            _reader_msg(debug, compat, infnc)
            with open_input(infnc) as fin:
                if in_off:
                    fin.seek(in_off)
                o1 = out_stream(outfnc)
                so = out_stream(sfn) if sfn else None
                apply_resume()
                with _Profile(profile):
                    counters = run_pe(
                        fin, None, interleaved=True,
                        out1=o1,
                        singles_out=so,
                        n_record_mode=n_record_mode,
                        params=params, cfg=cfg, cuts_fn=cuts_fn,
                        counters=counters_in,
                    )
        else:
            _reader_msg(debug, compat, infn)
            _reader_msg(debug, compat, infn2)
            with open_input(infn) as f1, open_input(infn2) as f2:
                if in_off:
                    f1.seek(in_off)
                if in_off2:
                    f2.seek(in_off2)
                o1 = out_stream(outfn)
                o2 = out_stream(outfn2)
                so = out_stream(sfn)
                apply_resume()
                with _Profile(profile):
                    counters = run_pe(
                        f1, f2, interleaved=False,
                        out1=o1,
                        out2=o2,
                        singles_out=so,
                        params=params, cfg=cfg, cuts_fn=cuts_fn,
                        counters=counters_in,
                    )
    except FileNotFoundError as e:
        sys.stderr.write(f"****Error: Could not open input file '{e.filename}'.\n\n")
        return 1
    except SickleError as e:
        sys.stderr.write(e.message + "\n")
        return e.exit_code
    finally:
        for s in outs:
            if s is not sys.stdout.buffer:
                s.close()

    if cfg.metrics is not None:
        cfg.metrics.report()
    counters = _merge_counters(counters)
    if not quiet and dist.pid == 0:
        c = counters
        if infn and infn2:
            sys.stdout.write(f"\nPE forward file: {infn}\nPE reverse file: {infn2}\n")
        if infnc:
            sys.stdout.write(f"\nPE interleaved file: {infnc}\n")
        sys.stdout.write(
            f"\nTotal input FastQ records: {c.total} ({c.total // 2} pairs)\n"
        )
        sys.stdout.write(
            f"\nFastQ paired records kept: {c.kept_p} ({c.kept_p // 2} pairs)\n"
        )
        if infnc:
            sys.stdout.write(f"FastQ single records kept: {c.kept_s1 + c.kept_s2}\n")
        else:
            sys.stdout.write(
                f"FastQ single records kept: {c.kept_s1 + c.kept_s2} "
                f"(from PE1: {c.kept_s1}, from PE2: {c.kept_s2})\n"
            )
        sys.stdout.write(
            f"FastQ paired records discarded: {c.discard_p} ({c.discard_p // 2} pairs)\n"
        )
        if infnc:
            sys.stdout.write(
                f"FastQ single records discarded: {c.discard_s1 + c.discard_s2}\n\n"
            )
        else:
            sys.stdout.write(
                f"FastQ single records discarded: {c.discard_s1 + c.discard_s2} "
                f"(from PE1: {c.discard_s1}, from PE2: {c.discard_s2})\n\n"
            )
    return 0


def main(argv: Optional[List[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] not in ("pe", "se", "--version", "--help"):
        return main_usage(1)
    if argv[0] == "--version":
        sys.stdout.write(version_text())
        return 0
    if argv[0] == "--help":
        return main_usage(0)
    if argv[0] == "pe":
        return _finish(pe_main(argv[1:]))
    return _finish(se_main(argv[1:]))


def _finish(rc: int) -> int:
    """Stop hybrid workers before interpreter teardown.  If a worker is
    WEDGED in a device call that never returns, the accelerator runtime's
    exit hooks would hang or abort the process ("terminate called ...");
    all user-visible output is already flushed, so exit hard with the
    real return code instead."""
    fn = _ACTIVE_CUTS_FN
    close = getattr(fn, "close", None)
    if close is not None and close() is False:
        sys.stdout.flush()
        sys.stderr.flush()
        os._exit(rc)
    return rc


if __name__ == "__main__":
    sys.exit(main())
