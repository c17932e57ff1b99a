"""Pipelined se/pe trimming drivers.

Three overlapped stages with deterministic, order-preserving output
(unlike the reference's racy detached writer, SURVEY.md §2.4.3):

  [prefetch thread]  read + pack chunk i+1        (host, numpy/C++)
  [main thread]      dispatch device compute i    (async under jit)
  [writer thread]    materialize + assemble + write chunk i-1

Chunks hold a fixed record count, so every device call shares one
compiled executable.  Counters are exact and global (the reference's pe
``total`` bug, SURVEY.md §2.4.7, is not reproduced).
"""

from __future__ import annotations

import dataclasses
import functools
import io as _io
import mmap as _mmap
import os
import queue
import stat as _stat
import threading
from typing import BinaryIO, Callable, Iterator, Optional, Tuple

import numpy as np

from ..constants import Compat
from ..io import native
from ..io.fastq import (
    QUAL_PLANES,
    OutputBuffer,
    PackedReads,
    PackWorkspace,
    _clamp_bm,
    _round_up,
    assemble_records,
    assemble_records_at,
    pack_fastq,
    pack_fastq_stream,
    qual_fields,
    qual_levels,
    qual_rank_fields,
    record_out_sizes,
)
from ..oracle import (
    FastqValidationError,
    PECounters,
    SECounters,
    decode_qual,
    sliding_window_cuts,
)
from ..ops import TrimParams
from ..utils.metrics import Metrics, maybe as _stage
from .chunker import iter_record_chunks

CutsFn = Callable[[np.ndarray, np.ndarray, np.ndarray], Tuple]

_SENTINEL = object()


def _idx_layout(packed):
    """(starts4_view, lens4_view) when the chunk's field views are the
    canonical stride-4 line-index layout sk_plan_assemble reads (base =
    name_start, lines at +0..+3), else None.  True for every packer
    product including _split_packed mate views; defensive for exotic
    callers passing hand-built PackedReads."""
    ns, nl = packed.name_start, packed.name_len
    if (ns.base is not None and ns.strides == (32,)
            and nl.strides == (16,) and ns.dtype == np.int64
            and nl.dtype == np.int32):
        return ns, nl
    return None


def _plan_assemble_fast(out_stream, packed, five, three, compat,
                        three_mask=None):
    """Fused emit: one native call (sk_plan_assemble) does the
    keep-filter, per-record sizes, prefix offsets, and record assembly
    straight into the output mapping, reading the parse line index
    in place — no numpy gathers, no intermediate arrays.

    ``three_mask``: optional bool[n] — rows where it is False are
    dropped (pe pair/single routing: the caller selects which records
    this stream gets by masking, order preserved).

    Returns ``(kept, bytes)`` or ``(None, 0)`` when the chunk/stream
    can't take the fused path (no reserve protocol, no stride-4 index
    layout, numpy fallback mode)."""
    reserve = getattr(out_stream, "reserve", None)
    lib = native.get_lib()
    n = packed.n_records
    idx = _idx_layout(packed) if n else None
    if reserve is None or lib is None or n == 0 or idx is None:
        return (None, 0) if n else (0, 0)
    import ctypes

    ns_view, nl_view = idx
    three = np.ascontiguousarray(three, np.int32)
    if three_mask is not None:
        three = np.where(three_mask, three, -1).astype(np.int32)
    five = np.ascontiguousarray(five, np.int32)
    # output bound: each record's emission never exceeds its source
    # extent +1 (a rewritten '+' can outgrow an EMPTY comment line);
    # the span end is the last record's qual line end (qual len == seq
    # len == lengths[n-1] by validation)
    cap = (int(packed.qual_start[n - 1]) + int(packed.lengths[n - 1]) + 1
           - int(packed.name_start[0])) + n
    buf, start = reserve(cap)
    out_kept = np.zeros(1, np.int64)
    s4 = ctypes.cast(ns_view.ctypes.data, ctypes.POINTER(ctypes.c_int64))
    l4 = ctypes.cast(nl_view.ctypes.data, ctypes.POINTER(ctypes.c_int32))
    total = lib.sk_plan_assemble(
        native.ptr(packed.data, ctypes.c_uint8), s4, l4,
        native.ptr(five, ctypes.c_int32),
        native.ptr(three, ctypes.c_int32),
        n, 1 if compat == Compat.V133 else 0,
        native.ptr(buf[start:], ctypes.c_uint8),
        native.ptr(out_kept, ctypes.c_int64),
        native.N_THREADS,
    )
    out_stream.commit(int(total))
    return int(out_kept[0]), int(total)


def _emit_records(out_stream, data, fields, five, three, compat, qualtype,
                  outbuf, n_record_mask=None) -> int:
    """Assemble one chunk's (already filtered/ordered) records and emit
    them to ``out_stream``; returns bytes written.

    Streams exposing the ``reserve``/``commit`` protocol (io.output.
    MmapWriter) get records scattered straight into the output file's
    mapped pages — no intermediate buffer, no ``write(2)`` copy (the
    reference pays both: src/trim_single.cpp:390-419).  Everything else
    takes the classic assemble-then-write path."""
    k = fields["name_start"].size
    if k == 0:
        return 0
    reserve = getattr(out_stream, "reserve", None)
    if reserve is not None and native.available():
        sizes = record_out_sizes(fields["name_len"], fields["comment_len"],
                                 five, three, compat, n_record_mask)
        offsets = np.zeros(k, np.int64)
        if k > 1:
            np.cumsum(sizes[:-1], out=offsets[1:])
        total = int(offsets[-1] + sizes[-1])
        buf, start = reserve(total)
        assemble_records_at(
            data, **fields, five=five, three=three, offsets=offsets + start,
            out_buf=buf, compat=compat, n_record_mask=n_record_mask,
            qualtype=qualtype,
        )
        out_stream.commit(total)
        return total
    b = assemble_records(
        data, **fields, five=five, three=three, compat=compat,
        n_record_mask=n_record_mask, qualtype=qualtype, out=outbuf,
    )
    out_stream.write(b)
    return len(b)


def _adapt_cuts_fn(fn: CutsFn) -> Callable:
    """Normalize a cuts fn to the kwarg-accepting form
    (seq, qual, lengths, qual_clean=..., wire=...).

    ``qual_clean=True`` tells backend-aware fns the packer proved the
    zero-padding invariant (PackedReads.qual_clean), skipping any rescan;
    ``wire`` carries producer-thread-prepared wire payloads (field wire).
    Plain 3-arg fns (tests, custom backends) are wrapped to ignore both.
    """
    import inspect

    def forward_attrs(wrapped):
        # backend fns carry engine-protocol attributes (lazy dispatch, AOT
        # warmup, producer-thread wire prep, wire accounting); a wrapper
        # that dropped them would silently disable those paths for
        # qual_clean-only or 3-arg custom fns
        for attr in ("lazy", "warmup_aot", "prepare"):
            if hasattr(fn, attr):
                setattr(wrapped, attr, getattr(fn, attr))
        return wrapped

    try:
        sig = inspect.signature(fn)
        if "wire" in sig.parameters or any(
            p.kind == inspect.Parameter.VAR_KEYWORD
            for p in sig.parameters.values()
        ):
            return fn
        if "qual_clean" in sig.parameters:
            return forward_attrs(
                lambda seq, qual, lengths, qual_clean=False, wire=None: fn(
                    seq, qual, lengths, qual_clean=qual_clean))
    except (TypeError, ValueError):
        pass
    return forward_attrs(
        lambda seq, qual, lengths, qual_clean=False, wire=None: fn(
            seq, qual, lengths))


def _need_rows_fn(cuts_fn):
    """Per-chunk row-packing decision for the producer.  Static for
    plain fns (needs_rows attr; default True); dynamic for hybrid fns
    (want_rows()): rows are packed only when the device might see the
    chunk, the indexed host path reads the source buffer directly."""
    want = getattr(cuts_fn, "want_rows", None)
    if want is not None and getattr(cuts_fn, "call_packed", None) is not None:
        return want
    static = bool(getattr(cuts_fn, "needs_rows", True))
    return lambda: static


def _gated_prep(cuts_fn):
    """Producer-thread wire prep, gated by the fn's routing hint: hybrid
    fns skip the (expensive) field-wire prep for chunks that will take the
    host kernel anyway (wire_useful); device probes build their own wire
    on the device worker."""
    prep = getattr(cuts_fn, "prepare", None)
    if prep is None:
        return None
    gate = getattr(cuts_fn, "wire_useful", None)
    if gate is None:
        return prep

    def gated(packed):
        # never build wire from unpacked (garbage) rows — an indexed
        # chunk is host-bound by construction
        if packed.rows_packed and gate():
            prep(packed)

    return gated


def _route_counts(cuts_fn) -> Tuple[int, int, int]:
    """``(device, host, rescued)`` chunk counts so far of a cuts fn.  The
    device step counts its calls; the hybrid router counts its routing,
    and chunks it routed to the device but recomputed on the host
    (rescued, or drained at end of input) count as host chunks."""
    rescued = (getattr(cuts_fn, "n_rescued", 0)
               + getattr(cuts_fn, "n_drained", 0))
    return (getattr(cuts_fn, "n_device", 0) - rescued,
            getattr(cuts_fn, "n_host", 0) + rescued, rescued)


def _finalize_window(cuts_fn) -> int:
    """In-order finalize window (chunks dispatched ahead of the oldest
    un-fetched result).  0 for eager fns; lazy fns default to 1 (H2D of
    chunk i+1 overlaps compute of chunk i); hybrid fns advertise a deeper
    ``pipeline_window`` spanning both routes' queues."""
    if not getattr(cuts_fn, "lazy", False):
        return 0
    env = os.environ.get("SICKLE_TPU_WINDOW")
    if env:
        return int(env)
    return int(getattr(cuts_fn, "pipeline_window", 1))


class _Cancelled(BaseException):
    """Internal: a pipeline stage was cancelled because a peer failed."""


@dataclasses.dataclass
class EngineConfig:
    """Pipeline tuning knobs.

    ``records_per_chunk`` plays the role of the reference's -b batch size
    (bytes), but counted in records so device shapes stay constant.
    ``slice_rows`` is the device dispatch granularity: each host chunk is
    dispatched as B/slice_rows independent sub-batches so one compiled
    executable serves every chunk including the ragged last one (chunks
    are padded only to a slice multiple, not to a full chunk).
    ``inflight`` sub-batches are kept in flight so transfers overlap
    device compute while one thread issues all device work.
    """

    records_per_chunk: int = 1 << 16
    prefetch: int = 2
    compat: Compat = Compat.V133
    # cap on one padded device batch's bytes (rows x padded length): long
    # reads (ONT/PacBio) shrink the row count per chunk instead of
    # exploding host/device memory (SURVEY.md §5.7)
    bytes_per_batch: int = 64 << 20
    slice_rows: int = dataclasses.field(
        default_factory=lambda: int(os.environ.get("SICKLE_TPU_SLICE_ROWS", 1 << 16))
    )
    inflight: int = dataclasses.field(
        default_factory=lambda: int(os.environ.get("SICKLE_TPU_INFLIGHT", 2))
    )
    # checkpoint/resume (SURVEY.md §5.3): fast-forward this many input
    # records (pe: total mates, even) before processing, and call
    # ``progress_cb(counters)`` after each chunk's output is written —
    # deterministic output makes "records done" a complete restart state
    skip_records: int = 0
    progress_cb: Optional[Callable[[object], None]] = None
    # multi-host input sharding: process at most this many bytes from the
    # stream's starting position (record-aligned by the sharder;
    # parallel.dist.shard_record_ranges).  byte_limit2 bounds pe's second
    # input file.  None = to EOF.
    byte_limit: Optional[int] = None
    byte_limit2: Optional[int] = None
    # per-chunk stage timing collector (SURVEY.md §5.1); CLI --metrics /
    # bench.py stall detection.  None = zero-overhead no-op.
    metrics: Optional[Metrics] = None
    # hybrid device+host dispatch (engine/hybrid.py): None = env
    # SICKLE_TPU_HYBRID, default ON (each chunk goes to the device or
    # the host kernel by measured per-chunk service time)
    hybrid: Optional[bool] = None


def _mmap_input(stream: BinaryIO, byte_limit: Optional[int] = None):
    """``(uint8 view of the readable span, start offset)`` for a plain
    regular-file stream, else ``None``.

    Enables the zero-copy producer: records are parsed straight out of
    the mapped pages (one scan, no chunk byte copies).  Gzip streams,
    pipes, and in-memory streams fall back to the chunked reader.
    ``byte_limit`` bounds the span at ``tell() + byte_limit`` (multi-host
    shard ranges).
    """
    raw = stream.raw if isinstance(stream, _io.BufferedReader) else stream
    if not isinstance(raw, _io.FileIO) or "r" not in getattr(raw, "mode", ""):
        return None
    try:
        st = os.fstat(stream.fileno())
        if not _stat.S_ISREG(st.st_mode) or st.st_size == 0:
            return None
        mm = _mmap.mmap(stream.fileno(), st.st_size, access=_mmap.ACCESS_READ)
    except (OSError, ValueError, AttributeError):
        return None
    arr = np.frombuffer(mm, dtype=np.uint8)
    off = stream.tell()
    if byte_limit is not None:
        arr = arr[: min(arr.size, off + byte_limit)]
    return arr, off


class _LimitedStream:
    """Read-only view of at most ``limit`` bytes from ``stream``'s current
    position (multi-host shard bound for non-mmap inputs)."""

    def __init__(self, stream: BinaryIO, limit: int):
        self._stream = stream
        self._left = limit

    def read(self, n: int = -1) -> bytes:
        if self._left <= 0:
            return b""
        if n is None or n < 0 or n > self._left:
            n = self._left
        data = self._stream.read(n)
        self._left -= len(data)
        return data


def _bounded(stream: BinaryIO, byte_limit: Optional[int]):
    return stream if byte_limit is None else _LimitedStream(stream, byte_limit)


class _RefBuf:
    """One decoded-window buffer with a refcount: the producer holds a
    ref while packing from it, and every chunk packed from it holds one
    until the writer recycles the chunk — so refills can never overwrite
    bytes that output assembly still references."""

    __slots__ = ("arr", "_refs", "_pool", "_lk")

    def __init__(self, arr: np.ndarray, pool: queue.Queue):
        self.arr = arr
        self._refs = 1
        self._pool = pool
        self._lk = threading.Lock()

    def retain(self):
        with self._lk:
            self._refs += 1

    def release(self):
        with self._lk:
            self._refs -= 1
            if self._refs:
                return
        self._pool.put(self.arr)


class _BgzfSource:
    """Zero-copy gzip producer source: BGZF blocks inflate in parallel
    STRAIGHT into the pack source buffer (BgzfReader.inflate_into), and
    records are parsed from it in place — no bytes()/join copies and no
    chunk copies (a serial read() chain left gzip input at 0.44x of a
    serial-zlib C++ reader).  Buffers rotate
    through a bounded pool; chunks pin their window via _RefBuf."""

    # >= the pipeline's in-flight chunk depth so pinned windows never
    # throttle the producer (each ~24 MiB window usually backs one chunk)
    MAX_BUFFERS = 6

    def __init__(self, reader, byte_limit: Optional[int], stop: threading.Event):
        self.r = reader
        self.remaining = byte_limit
        self._free: queue.Queue = queue.Queue()
        self._made = 0
        self._stop = stop
        self.cur: Optional[_RefBuf] = None
        self.pos = 0
        self.end = 0

    def _take_buffer(self, size: int) -> np.ndarray:
        if self._made < self.MAX_BUFFERS:
            self._made += 1
            return np.empty(size, np.uint8)
        while True:  # stop-aware: a failed writer must not deadlock us
            if self._stop.is_set():
                raise _Cancelled()
            try:
                arr = self._free.get(timeout=0.05)
                break
            except queue.Empty:
                continue
        if arr.size < size:
            arr = np.empty(size, np.uint8)
        return arr

    def refill(self, min_total: int = 0) -> bool:
        """Extend the live span with the next inflate window.  False at
        EOF/limit.  Appends IN PLACE when the current buffer has room
        (bytes before ``end`` are immutable, so pinned chunks are
        unaffected); rotates to a fresh buffer — sized for
        ``min_total`` so a multi-window chunk rotates once, not per
        window — only when capacity runs out."""
        if self.remaining is not None and self.remaining <= 0:
            return False
        need = self.r.peek_window_bytes()
        if need == 0:
            return False
        live = self.end - self.pos
        if self.cur is None or self.cur.arr.size - self.end < need:
            # rotate: carry the leftover into a fresh, generously sized
            # buffer (growth-doubling keeps the pool's arrays reusable)
            size = max(live + need, min_total,
                       (self.cur.arr.size * 2) if self.cur is not None else 0)
            arr = self._take_buffer(size)
            if live:
                arr[:live] = self.cur.arr[self.pos : self.end]
            if self.cur is not None:
                self.cur.release()  # producer's ref on the old window
            self.cur = _RefBuf(arr, self._free)
            self.pos, self.end = 0, live
        n = self.r.inflate_into(self.cur.arr, self.end)
        if n <= 0:
            return False
        if self.remaining is not None:
            n = min(n, self.remaining)
            self.remaining -= n
        self.end += n
        return True

    def exhausted(self) -> bool:
        """True when no further bytes can be produced (the parser may
        then apply EOF trailing-line semantics to the current span)."""
        if self.remaining is not None and self.remaining <= 0:
            return True
        return self.r.peek_window_bytes() == 0

    def close(self):
        if self.cur is not None:
            self.cur.release()
            self.cur = None


def _bgzf_source(stream, byte_limit, stop) -> Optional[_BgzfSource]:
    from ..io.compression import BgzfReader

    if isinstance(stream, BgzfReader) and native.available():
        return _BgzfSource(stream, byte_limit, stop)
    return None


def _produce_bgzf(src, pipe, state, mtr, params, need_rows, eff_fn,
                  prep_put, batch_bytes=None, pair_align=False):
    """Shared zero-copy BGZF producer loop (se and interleaved pe): pack
    records in place from the decode window, extending the span (never
    advancing past partial-record bytes) when a record straddles a
    window, and — for interleaved pairs — handing an odd trailing record
    back to the stream so pairs stay whole.  ``prep_put`` consumes each
    finished chunk (position bookkeeping + wire prep + queue put)."""
    try:
        while True:
            eff, bm = eff_fn()
            want = eff * max(state["est"], 300)
            while (src.end - src.pos < want
                   and not pipe.stop.is_set()
                   and src.refill(min_total=want)):
                pass
            if src.end <= src.pos:
                break
            ws = pipe.get_workspace()
            view = src.cur.arr[: src.end]
            with _stage(mtr, "pack"):
                packed, consumed = pack_fastq_stream(
                    view, src.pos, eff,
                    start_position=state["consumed"],
                    l_max=state["l_max"], batch_multiple=bm,
                    workspace=ws, need_seq=params.trunc_n,
                    est_rec_bytes=state["est"],
                    batch_bytes=batch_bytes,
                    need_rows=need_rows(),
                    at_eof=src.exhausted(),
                )
            n = packed.n_records
            if n == 0:
                # a record spans past the window: extend WITHOUT advancing
                # pos (the n==0 'consumed' covers the partial bytes, which
                # the next pack still needs)
                pipe.ws_pool.put(ws)
                if not src.refill(min_total=2 * want):
                    src.pos += consumed  # true EOF: partial dropped
                    break
                continue
            if pair_align and n % 2 and src.r.peek_window_bytes() > 0:
                # keep pairs whole across window boundaries: hand the odd
                # record back to the stream (it leads the next chunk); at
                # true EOF the odd count stands and errors like the
                # reference
                n -= 1
                consumed = int(ws.starts4[4 * n])
                packed.n_records = n
                packed.lengths[n] = 0
                if packed.rows_packed:
                    packed.qual[n] = 0
            src.pos += consumed
            if n == 0:
                # the odd-carry emptied a single-record window: extend
                pipe.ws_pool.put(ws)
                if not src.refill(min_total=2 * want):
                    break
                continue
            if mtr is not None:
                mtr.add_chunk(n, consumed)
            state["l_max"] = max(state["l_max"], packed.max_len)
            state["est"] = max(state["est"], -(-consumed // n))
            packed.source_ref = src.cur
            src.cur.retain()
            prep_put(packed)
    finally:
        src.close()


def _skip_offset(arr: np.ndarray, offset: int, n_lines: int) -> Optional[int]:
    """Byte offset just past the ``n_lines``-th newline at/after ``offset``
    (checkpoint fast-forward), or None if the buffer has fewer lines."""
    if n_lines == 0:
        return offset
    import ctypes

    lib = native.get_lib()
    view = arr[offset:]
    if lib is not None:
        pos = int(lib.sk_kth_newline(native.ptr(view, ctypes.c_uint8),
                                     view.size, n_lines))
    else:
        nl = np.flatnonzero(view == 0x0A)
        pos = int(nl[n_lines - 1]) if nl.size >= n_lines else -1
    return None if pos < 0 else offset + pos + 1


def _effective_chunk(cfg: EngineConfig, l_max: int) -> Tuple[int, int]:
    """(records, batch_multiple) for the next chunk, bounded so one padded
    batch stays within ``cfg.bytes_per_batch``.  150 bp reads keep the
    configured chunk/slice shape; 50 kbp reads drop to ~1.3k rows/chunk
    with a matching power-of-two padding multiple."""
    L = max(l_max, 8)
    eff = min(cfg.records_per_chunk, max(8, cfg.bytes_per_batch // L))
    eff &= ~1  # pe interleaved packs mates adjacently; keep pairs whole
    if eff >= cfg.slice_rows:
        return eff, cfg.slice_rows
    return eff, max(8, 1 << (eff.bit_length() - 1))


def default_cuts_fn(params: TrimParams, cfg: Optional[EngineConfig] = None,
                    mesh=None) -> CutsFn:
    """The engine's compute step, the same on every backend and device
    count: the sliced device step (``_device_cuts_fn``; row-sharded over
    ``mesh`` when given) wrapped in the hybrid device+host router
    (engine/hybrid.py) unless disabled.  ``SICKLE_TPU_CUTS=host`` runs the
    C++ host kernel alone, without touching an accelerator.
    """
    from .hybrid import HybridCutsFn, hybrid_enabled

    cfg = cfg or EngineConfig()
    if os.environ.get("SICKLE_TPU_CUTS") == "host":
        return HybridCutsFn(params, None)
    dev = _device_cuts_fn(params, cfg.slice_rows, cfg.inflight, mesh=mesh)
    if hybrid_enabled(cfg.hybrid) and native.available():
        return HybridCutsFn(params, dev)
    return dev


def _device_cuts_fn(params: TrimParams, slice_rows: int = 4096,
                    inflight: int = 4, mesh=None) -> CutsFn:
    """The device step:

    * qual-only input (seq stacked into the same array only when -n needs
      it); per-row lengths are derived ON DEVICE from the zero padding
      (quality bytes are never NUL in a valid file — the host verifies
      that invariant cheaply and falls back to explicit lengths
      otherwise, preserving the range-check error semantics)
    * the compressed field wire (band or rank, see ``_wire_plan``) when
      a chunk's quality chars allow it: p/8 of the raw qual bytes H2D
    * the chunk is dispatched as [slice_rows, L] sub-batches with an
      ``inflight`` window, so transfers overlap compute while all device
      interaction stays on the calling thread; uniform-length chunks use
      executables compiled for that length, and ``warmup_aot`` compiles
      them ahead of the pass
    * per sub-batch output: one int32 per read — (five+1) in bits 16-30,
      a has-bad-quality flag in bit 15, (three+1) in bits 0-14.  Long
      reads (L >= 32766, where three+1 no longer fits 15 bits) switch to
      an unpacked [3, B] result: 12 B/read D2H, negligible next to their
      row bytes.
    * the result fetch is deferred (``lazy``): the engine finalizes a
      chunk only after the next one has been dispatched.

    ``mesh``: a 1-D device mesh — every step is then jitted with
    row-sharded in_shardings (the kernel is row-local, so XLA compiles
    one SPMD program with zero collectives) and the same wire and result
    formats apply per device.  Slice size is rounded to a mesh multiple;
    ragged batches pad rows (length 0 => discarded).

    ``n_device`` counts the chunks this step has computed.
    """
    import jax
    import jax.numpy as jnp

    from ..constants import QUALITY_CONSTANTS
    from ..ops.trim import (
        apply_rank_lut,
        compute_cuts,
        compute_cuts_from_q,
        decode_fields,
    )

    def encode(seq, qual, lengths, ul=None):
        five, three, bad = compute_cuts(seq, qual, lengths, params,
                                        uniform_len=ul)
        flagged = (bad < lengths).astype(jnp.int32)
        if qual.shape[1] < MAX_PACKED_L:
            return (three + 1) | (flagged << 15) | ((five + 1) << 16)
        return jnp.stack([five, three, flagged])

    def derive_lengths(qual):
        lane = jax.lax.broadcasted_iota(jnp.int32, qual.shape, 1)
        padded = jnp.where(qual == 0, lane, qual.shape[1])
        return jnp.min(padded, axis=1)

    n_mesh = 1
    if mesh is not None:
        from jax.sharding import NamedSharding, PartitionSpec as P

        from ..parallel.mesh import DATA_AXIS

        n_mesh = mesh.devices.size
        slice_rows = -(-slice_rows // n_mesh) * n_mesh
        row = NamedSharding(mesh, P(DATA_AXIS))
        row2 = NamedSharding(mesh, P(DATA_AXIS, None))
        stack3 = NamedSharding(mesh, P(None, DATA_AXIS, None))

        # explicit sharded device_put (multi-process jit rejects numpy
        # args with non-trivial in_shardings); jit then traces on the
        # committed sharded arrays -> one SPMD program, zero collectives
        rep = NamedSharding(mesh, P())

        def put2(x):
            return jax.device_put(x, row2)

        def put1(x):
            return jax.device_put(x, row)

        def put3(x):
            return jax.device_put(x, stack3)

        def put0(x):
            return jax.device_put(x, rep)
    else:
        put2 = put1 = put3 = put0 = lambda x: x  # noqa: E731

    def make_steps(ul=None):
        """The wire-format device steps, at a STATIC uniform read length
        ``ul`` or generic (None).  Uniform chunks — the common Illumina
        case, including pow2-padded tails (padding rows are length 0) —
        get a compile-time window size: the O(log wmax) per-row shift
        chain collapses to ONE static shift (round-4 kernel rework)."""

        @jax.jit
        def step_q(qual):  # no -n: qual only
            lengths = derive_lengths(qual)
            return encode(qual, qual, lengths, ul)  # seq unused

        @functools.partial(jax.jit, static_argnames=("L",))
        def step_planes(buf, bias, L):
            # field wire format (io.fastq.qual_fields): the p-bit biased
            # value ships as byte-aligned 4/2/1-bit subfields — p/8 of
            # the raw u8 H2D bytes at ~3 decode passes instead of p.
            # The host levels gate proved every char in-range, so no
            # bad-quality flag bits.
            p = buf.shape[1] * 8 // L
            v = decode_fields(buf, p, L)  # uint8[B, L]; 0 marks padding
            lane = jax.lax.broadcasted_iota(jnp.int32, (v.shape[0], L), 1)
            lengths = jnp.min(jnp.where(v == 0, lane, L), axis=1)
            five, three = compute_cuts_from_q(v.astype(jnp.int32) + bias,
                                              lengths, params,
                                              uniform_len=ul)
            return (three + 1) | ((five + 1) << 16)

        @functools.partial(jax.jit, static_argnames=("L",))
        def step_planes_rank(buf, lut, L):
            # rank wire (dictionary encoding): v = 1 + rank of the char
            # in the chunk's <=7 distinct levels; lut maps rank ->
            # decoded quality.  Binned Illumina data ships
            # ceil(log2(levels+1)) bits regardless of how wide the
            # LEVEL BAND is — 3-bit ranks = 57 B per 150 bp read.
            p = buf.shape[1] * 8 // L
            v = decode_fields(buf, p, L)  # uint8[B, L]; 0 marks padding
            lane = jax.lax.broadcasted_iota(jnp.int32, (v.shape[0], L), 1)
            lengths = jnp.min(jnp.where(v == 0, lane, L), axis=1)
            q = apply_rank_lut(v.astype(jnp.int32), lut)
            five, three = compute_cuts_from_q(q, lengths, params,
                                              uniform_len=ul)
            return (three + 1) | ((five + 1) << 16)

        @jax.jit
        def step_sq(stacked):  # -n: [2, B, L] seq+qual in one transfer
            seq, qual = stacked[0], stacked[1]
            lengths = derive_lengths(qual)
            return encode(seq, qual, lengths, ul)

        return {"q": step_q, "planes": step_planes,
                "rank": step_planes_rank, "sq": step_sq}

    import functools as _ft

    base_steps = make_steps(None)
    _uniform_steps = _ft.lru_cache(maxsize=4)(make_steps)

    @jax.jit
    def step_explicit(seq, qual, lengths):  # fallback: NUL bytes in qual
        return encode(seq, qual, lengths.astype(jnp.int32))

    @jax.jit
    def step_explicit_q(qual, lengths):  # same, qual-only (no -n)
        return encode(qual, qual, lengths.astype(jnp.int32))

    needs_seq = params.trunc_n
    SL = slice_rows
    enc_offset, enc_qmin, enc_qmax = QUALITY_CONSTANTS[params.qualtype]
    no_planes = bool(os.environ.get("SICKLE_TPU_NO_PLANES"))

    def warmup_aot(L: int, min_rows: int = 2048,
                   planes=(QUAL_PLANES,), ranks=(),
                   read_len: Optional[int] = None) -> None:
        """Compile the steady-state executables WITHOUT touching the device.

        ``jit.lower(...).compile()`` runs the AOT compiler only — no
        transfers, no execution — so compilation is set-up time, never
        part of the pass.  Compiles the full
        [slice_rows, L] shape plus the power-of-two ladder down to
        ``min_rows``: ragged final chunks are pow2-padded by the packer
        (_clamp_bm) and dispatched as pow2 tail pieces, so the measured
        pass never compiles inline.  On the qual-only path the raw-row
        format plus every requested wire bit width is compiled (the
        plane count is per-chunk data-dependent — pass the counts the
        run's data can produce; a miss compiles inline).
        ``read_len``: the run's uniform read length — the engine will
        dispatch the uniform-window executables, so THOSE are compiled.
        """
        import jax.numpy as _jnp

        steps = (_uniform_steps(read_len) if read_len is not None
                 else base_steps)
        rows = SL
        while rows >= min_rows or rows == SL:
            if needs_seq:
                steps["sq"].lower(
                    jax.ShapeDtypeStruct((2, rows, L), _jnp.uint8)).compile()
            else:
                if L % 8 == 0 and not no_planes:
                    for p in planes:
                        steps["planes"].lower(
                            jax.ShapeDtypeStruct((rows, p * L // 8),
                                                 _jnp.uint8),
                            jax.ShapeDtypeStruct((), _jnp.int32),
                            L=L).compile()
                    for p in ranks:
                        steps["rank"].lower(
                            jax.ShapeDtypeStruct((rows, p * L // 8),
                                                 _jnp.uint8),
                            jax.ShapeDtypeStruct((1 << p,),
                                                 _jnp.int32),
                            L=L).compile()
                steps["q"].lower(
                    jax.ShapeDtypeStruct((rows, L), _jnp.uint8)).compile()
            if rows & (rows - 1):  # mesh-rounded SL: drop to pow2 ladder
                rows = 1 << (rows.bit_length() - 1)
            else:
                rows //= 2

    def _wire_plan(qual, qual_clean, B):
        """Per-chunk compressed-wire selection (data-dependent): the
        whole chunk's chars must fit the encoding's range (=> the range
        check cannot fire; out-of-range chunks take the raw path whose
        device check preserves the reference's error semantics).  Then
        the cheapest exact format wins:

        * ("rank", levels, p) — <= 7 distinct quality values (binned
          Illumina): chars ship as dictionary ranks in
          p = ceil(log2(levels+1)) planes, regardless of band width
          (NovaSeq's 4 levels span a 36-char band: 3 planes, not 6);
        * ("band", bias, p)  — narrow band above bias = min - 1,
          p = band bit width (<= 6);
        * None — raw u8 rows.
        """
        if (needs_seq or no_planes or not qual_clean or B % 8
                or qual.shape[1] % 8 or qual.shape[1] >= MAX_PACKED_L
                or (mesh is not None and B % SL)):
            return None
        levels = qual_levels(qual)
        if levels.size == 0:
            return None
        mn, mx = int(levels[0]), int(levels[-1])
        if mn < enc_qmin or mx > enc_qmax:
            return None
        p_band = (mx - (mn - 1)).bit_length()
        p_rank = levels.size.bit_length() if levels.size <= 7 else 99
        if p_rank < min(p_band, QUAL_PLANES + 1):
            return ("rank", levels, p_rank)
        if p_band <= QUAL_PLANES:
            return ("band", mn - 1, max(p_band, 1))
        return None

    def _wire_pieces(qual, plan):
        mode, arg, p = plan
        if mode == "rank":
            return [qual_rank_fields(qual[i : i + n], arg, p)
                    for i, n in _pieces(qual.shape[0])]
        return [qual_fields(qual[i : i + n], arg, p)
                for i, n in _pieces(qual.shape[0])]

    def _pieces(B):
        # full slices, then the pow2-padded ragged tail (_clamp_bm) as
        # descending power-of-two pieces — every piece hits a
        # warmup_aot-precompiled executable on the qual-only path instead
        # of the explicit fallback (+lengths wire, inline compile mid-pass)
        i = 0
        while i < B:
            rem = B - i
            n = SL if rem >= SL else 1 << (rem.bit_length() - 1)
            yield i, n
            i += n

    def prepare(packed):
        """Producer-thread wire prep: pack the chunk's wire fields OFF the
        dispatch thread (overlaps the previous chunk's device work).
        Stores (plan, [per-piece planes]) on ``packed.wire``."""
        qual = packed.qual
        plan = _wire_plan(qual, packed.qual_clean, qual.shape[0])
        if plan is None:
            packed.wire = None
            return
        packed.wire = (plan, _wire_pieces(qual, plan))

    def fn(seq, qual, lengths, qual_clean=False, wire=None):
        lengths = np.asarray(lengths)
        B = qual.shape[0]
        if n_mesh > 1 and B % n_mesh:
            # rare fallback (engine batches are padded to a slice/mesh
            # multiple): pad rows so the mesh shards evenly; padding rows
            # have length 0 and are discarded; callers slice results back
            pad = n_mesh - B % n_mesh
            qual = np.pad(qual, ((0, pad), (0, 0)))
            if needs_seq:
                seq = np.pad(seq, ((0, pad), (0, 0)))
            lengths = np.pad(lengths, (0, pad))
            B += pad
            wire = None
        # padding-derivation invariant: zero bytes in `qual` are exactly
        # the padding — proven by the packer (PackedReads.qual_clean).
        # (A NUL inside a read is an invalid quality char; route through
        # the explicit path so it errors, not truncates.)
        # The mesh path keeps the explicit fallback for ragged batches
        # (pow2 tail pieces need not divide the mesh size).
        if not qual_clean or B % 8 or (mesh is not None and B % SL):
            fn.last_h2d = qual.nbytes * (2 if needs_seq else 1) + 4 * B
            r = (step_explicit(put2(seq), put2(qual), put1(lengths))
                 if needs_seq
                 else step_explicit_q(put2(qual), put1(lengths)))
            fn.n_device += 1
            return _PendingCuts([], [r])

        if wire is not None:
            plan, planes_list = wire
        else:
            plan = _wire_plan(qual, qual_clean, B)
            planes_list = _wire_pieces(qual, plan) if plan is not None else None
        if plan is not None and plan[0] == "rank":
            levels, p = plan[1], plan[2]
            lut = np.zeros(1 << p, np.int32)
            lut[1 : 1 + levels.size] = levels.astype(np.int32) - enc_offset
        # uniform-length chunk (incl. length-0 padding rows): dispatch the
        # static-window executables — one shift instead of the per-row
        # shift chain on device
        mx = int(lengths.max()) if lengths.size else 0
        uniform = (mx > 0 and int(np.count_nonzero(
            (lengths == mx) | (lengths == 0))) == lengths.size)
        steps = _uniform_steps(mx) if uniform else base_steps
        futs: list = []
        outs: list = []
        h2d = 0
        for k, (i, n) in enumerate(_pieces(B)):
            if needs_seq:
                futs.append(steps["sq"](put3(
                    np.stack([seq[i : i + n], qual[i : i + n]]))))
                h2d += 2 * n * qual.shape[1]
            elif plan is not None:
                fields = planes_list[k]
                if plan[0] == "rank":
                    futs.append(steps["rank"](put2(fields), put0(lut),
                                              L=qual.shape[1]))
                    h2d += fields.nbytes + lut.nbytes
                else:
                    futs.append(steps["planes"](
                        put2(fields), put0(np.int32(plan[1] - enc_offset)),
                        L=qual.shape[1]))
                    h2d += fields.nbytes + 4
            else:
                futs.append(steps["q"](put2(qual[i : i + n])))
                h2d += n * qual.shape[1]
            if len(futs) > inflight:
                outs.append(np.asarray(futs.pop(0)))
        fn.last_h2d = h2d
        fn.n_device += 1
        return _PendingCuts(outs, futs)

    fn.warmup_aot = warmup_aot
    # the jitted step programs at a static uniform read length (or
    # generic, None): {"q", "planes", "rank", "sq"}
    fn.steps = lambda ul=None: (_uniform_steps(ul) if ul is not None
                                else base_steps)
    fn.n_device = 0
    fn.prepare = prepare
    fn.lazy = True  # returns _PendingCuts; fetch deferred to the window
    return fn


class _PendingCuts:
    """One chunk's device results, fetch deferred (lazy dispatch).

    ``outs`` are already-fetched numpy slices (the in-chunk inflight
    window); ``futs`` are outstanding device arrays.  Deferring the final
    fetch lets the engine dispatch chunk i+1's H2D before synchronizing
    on chunk i's result, so transfer and device compute overlap across
    chunks while all device interaction stays on the calling thread."""

    __slots__ = ("outs", "futs")

    def __init__(self, outs: list, futs: list):
        self.outs = outs
        self.futs = futs

    def materialize(self):
        outs = self.outs + [np.asarray(f) for f in self.futs]
        if len(outs) == 1:
            return _decode_codes(outs[0])
        axis = 1 if outs[0].ndim == 2 else 0
        return _decode_codes(np.concatenate(outs, axis=axis))


# (three+1) must fit 15 bits in the packed result encoding; longer rows
# use the unpacked [3, B] device result
MAX_PACKED_L = 32766


def _decode_codes(arr: np.ndarray):
    """Device result -> (five, three, bad) int32 arrays.

    ``arr`` is either the packed per-read int32 codes (see _device_cuts_fn)
    or the long-read [3, B] (five, three, flag) stack.  ``bad`` is 0 for
    rows the device flagged as containing an out-of-range quality char,
    BIG otherwise (exact position re-derived host-side from the bytes).
    """
    from ..ops.trim import BIG

    if arr.ndim == 2:
        five = arr[0].astype(np.int32)
        three = arr[1].astype(np.int32)
        flag = arr[2] != 0
    else:
        three = (arr & 0x7FFF).astype(np.int32) - 1
        five = (arr >> 16).astype(np.int32) - 1
        flag = (arr >> 15) & 1 == 1
    bad = np.where(flag, 0, BIG).astype(np.int32)
    return five, three, bad


def _materialize(result, n: int):
    """Fetch device results -> (five, three, first_bad) numpy arrays.

    Accepts a (five, three, bad) tuple of device arrays, any lazy result
    exposing ``materialize()`` (the device step's deferred ``_PendingCuts``,
    the hybrid dispatcher's ordered slots), or the encoded int32 device
    result (see _decode_codes), decoded into the same contract."""
    if hasattr(result, "materialize"):
        five, three, bad = result.materialize()
        return five[:n], three[:n], bad
    if isinstance(result, tuple):
        five, three, bad = (np.asarray(r) for r in result)
        return five[:n], three[:n], bad
    five, three, bad = _decode_codes(np.asarray(result))
    return five[:n], three[:n], bad


def _recheck_quality_row(packed: PackedReads, row: int, params: TrimParams):
    """The device flagged an out-of-range quality char in this row; decide
    host-side with the scalar reference semantics.

    Under ``--strict`` every bad char errors (whole-read check).  The
    default matches sickle 1.33 exactly: only chars the scan touches
    error (it breaks at the 3' cut, src/trim.cpp:66-73), so the lazy
    scalar re-scan raises iff the reference would — with its exact
    message — and completes silently for junk past the scan extent
    (whose device-computed cuts are unaffected; see ops.trim.decode_check).
    """
    arr = packed.data
    name = arr[
        packed.name_start[row] : packed.name_start[row] + packed.name_len[row]
    ].tobytes()
    L = int(packed.lengths[row])
    qual = arr[packed.qual_start[row] : packed.qual_start[row] + L].tobytes()
    if params.strict:
        decode_qual(qual, params.qualtype, name)
        raise AssertionError(
            "device flagged a quality error the host cannot find"
        )
    seq = arr[packed.seq_start[row] : packed.seq_start[row] + L].tobytes()
    sliding_window_cuts(
        seq, qual,
        qualtype=params.qualtype,
        qual_threshold=params.qual_threshold,
        length_threshold=params.length_threshold,
        no_fiveprime=params.no_fiveprime,
        trunc_n=params.trunc_n,
        compat=params.compat,
        name=name,
    )


def _check_quality(packed: PackedReads, first_bad: np.ndarray, params: TrimParams):
    n = packed.n_records
    for row in np.flatnonzero(first_bad[:n] < packed.lengths[:n]):
        _recheck_quality_row(packed, int(row), params)


# Process-level reuse pools.  A PackWorkspace's buffers are tens of MB
# and this container's first-touch page faults cost ~400 us each, so a
# run that allocates fresh workspaces pays 100+ ms before the first
# chunk packs; back-to-back runs (bench passes, trim_all directories)
# reuse warm pages instead.  Bounded so idle processes don't hoard.
_POOL_LOCK = threading.Lock()
_WS_POOL: dict = {}  # need_seq -> [PackWorkspace]
_OUTBUF_POOL: list = []
_POOL_MAX = 8


def _ws_checkout(need_seq: bool, n: int) -> list:
    with _POOL_LOCK:
        have = _WS_POOL.setdefault(need_seq, [])
        out = [have.pop() for _ in range(min(len(have), n))]
    out.extend(PackWorkspace(need_seq=need_seq) for _ in range(n - len(out)))
    return out


def _ws_return(need_seq: bool, ws_list: list) -> None:
    with _POOL_LOCK:
        have = _WS_POOL.setdefault(need_seq, [])
        have.extend(ws_list)
        del have[_POOL_MAX:]


def _outbuf_checkout() -> OutputBuffer:
    with _POOL_LOCK:
        if _OUTBUF_POOL:
            return _OUTBUF_POOL.pop()
    return OutputBuffer()


def _outbuf_return(buf: OutputBuffer) -> None:
    with _POOL_LOCK:
        _OUTBUF_POOL.append(buf)
        del _OUTBUF_POOL[_POOL_MAX:]


class _Pipeline:
    """Shared 3-stage machinery; stage bodies are provided by the driver.

    ``producer`` fills ``pack_q`` (and terminates it with the sentinel);
    ``dispatcher(item)`` runs on the main thread (device dispatch);
    ``consume(result)`` runs on the writer thread, strictly in dispatch
    order.  Any stage's exception is re-raised on the main thread; failed
    stages drain their queues so no peer can block forever.
    """

    def __init__(self, prefetch: int, n_workspaces: int = 0, need_seq: bool = True):
        self.pack_q: queue.Queue = queue.Queue(maxsize=prefetch)
        self.write_q: queue.Queue = queue.Queue(maxsize=prefetch)
        self.errors: list = []
        self.stop = threading.Event()
        # reusable pack workspaces, one per in-flight chunk (+2 slack);
        # producer checks out, writer recycles after materializing
        # results; checked out of (and returned to) the process pool
        self._need_seq = need_seq
        self.ws_pool: queue.Queue = queue.Queue()
        for ws in _ws_checkout(need_seq, n_workspaces):
            self.ws_pool.put(ws)

    def get_workspace(self) -> PackWorkspace:
        # stop-aware: when the writer fails, drained chunks are never
        # recycled, so a plain blocking get would deadlock the producer
        while True:
            if self.stop.is_set():
                raise _Cancelled()
            try:
                return self.ws_pool.get(timeout=0.05)
            except queue.Empty:
                continue

    def recycle(self, *packed_list):
        for p in packed_list:
            if p is None:
                continue
            src = getattr(p, "source_ref", None)
            if src is not None:  # unpin the decoded gzip window
                p.source_ref = None
                src.release()
            if p.workspace is not None:
                self.ws_pool.put(p.workspace)

    def check(self):
        if self.errors:
            raise self.errors[0]

    def _producer_loop(self, producer):
        try:
            producer()
        except _Cancelled:
            pass  # another stage already failed; its error wins
        except BaseException as e:
            self.errors.append(e)
            self.stop.set()
        finally:
            self.pack_q.put(_SENTINEL)

    def _writer_loop(self, consume):
        while True:
            item = self.write_q.get()
            if item is _SENTINEL:
                return
            if self.errors:
                continue  # drain
            try:
                consume(item)
            except BaseException as e:
                self.errors.append(e)
                self.stop.set()

    def run(self, producer, dispatcher, consume, finalize=None, window=0,
            on_drain=None):
        """``finalize``/``window``: dispatched chunks are held in a
        bounded deque and finalized (device-result fetch) on the main
        thread only after ``window`` newer chunks have been dispatched —
        H2D of chunk i+1 overlaps compute/D2H of chunk i without any
        concurrent device interaction (single calling thread).
        ``on_drain`` fires once the producer has delivered its last
        chunk (hybrid fns rescue their pending device tail)."""
        from collections import deque

        tp = threading.Thread(target=self._producer_loop, args=(producer,), daemon=True)
        tw = threading.Thread(target=self._writer_loop, args=(consume,), daemon=True)
        tp.start()
        tw.start()
        pending: deque = deque()
        if finalize is None:
            finalize = lambda item: item  # noqa: E731
            window = 0
        try:
            while True:
                item = self.pack_q.get()
                if item is _SENTINEL:
                    break
                if self.stop.is_set():
                    continue  # drain
                pending.append(dispatcher(item))
                while len(pending) > window:
                    self.write_q.put(finalize(pending.popleft()))
            if on_drain is not None and not self.stop.is_set():
                on_drain()
            while pending and not self.stop.is_set():
                self.write_q.put(finalize(pending.popleft()))
        finally:
            self.write_q.put(_SENTINEL)
            tw.join()
            tp.join(timeout=10)
            drained = []
            while True:
                try:
                    drained.append(self.ws_pool.get_nowait())
                except queue.Empty:
                    break
            _ws_return(self._need_seq, drained)
        self.check()


# ---------------------------------------------------------------------------
# Single-end
# ---------------------------------------------------------------------------


def run_se(
    in_stream: BinaryIO,
    out_stream: BinaryIO,
    params: TrimParams,
    *,
    cfg: Optional[EngineConfig] = None,
    cuts_fn: Optional[CutsFn] = None,
    counters: Optional[SECounters] = None,
) -> SECounters:
    """Trim a single-end stream; returns exact global counters.

    Pass ``counters`` (and ``cfg.skip_records``) to resume a partial run:
    skipped records are fast-forwarded without compute or output.
    """
    cfg = cfg or EngineConfig()
    cuts_fn = _adapt_cuts_fn(cuts_fn or default_cuts_fn(params, cfg))
    prep = _gated_prep(cuts_fn)
    call_packed = getattr(cuts_fn, "call_packed", None)
    # indexed host-cuts mode: the fn reads records straight from the
    # source buffer via the line index; skip packing row matrices.
    # Hybrid fns decide PER CHUNK (want_rows): rows are packed only when
    # the device might see the chunk (competitive routing / due probe).
    need_rows = _need_rows_fn(cuts_fn)
    # lazy cuts fns defer the result fetch so chunk i+1's dispatch
    # overlaps chunk i's device compute/D2H (one extra in-flight chunk,
    # hence one extra workspace); hybrid fns ask for a deeper window
    # covering both routes' queues (pipeline_window); SICKLE_TPU_WINDOW=0
    # restores strictly serialized dispatch+fetch
    window = _finalize_window(cuts_fn)
    pipe = _Pipeline(cfg.prefetch, n_workspaces=cfg.prefetch + 2 + window,
                     need_seq=params.trunc_n)
    counters = counters if counters is not None else SECounters()
    state = {"consumed": cfg.skip_records, "l_max": 0, "est": 0}
    outbuf = _outbuf_checkout()
    mtr = cfg.metrics

    mapped = (_mmap_input(in_stream, cfg.byte_limit)
              if native.available() else None)

    def producer():
        if mapped is not None:
            # zero-copy: parse fixed-record chunks straight from the mmap
            arr, off = mapped
            off = _skip_offset(arr, off, 4 * cfg.skip_records)
            while off is not None and off < arr.size:
                ws = pipe.get_workspace()
                eff, bm = _effective_chunk(cfg, state["l_max"])
                with _stage(mtr, "pack"):
                    packed, consumed = pack_fastq_stream(
                        arr, off, eff,
                        start_position=state["consumed"],
                        l_max=state["l_max"],
                        batch_multiple=bm,
                        workspace=ws,
                        need_seq=params.trunc_n,
                        est_rec_bytes=state["est"],
                        batch_bytes=cfg.bytes_per_batch,
                        need_rows=need_rows(),
                    )
                off += consumed
                if packed.n_records == 0:  # trailing partial record
                    pipe.ws_pool.put(ws)
                    break
                if mtr is not None:
                    mtr.add_chunk(packed.n_records, consumed)
                state["consumed"] += packed.n_records
                state["l_max"] = max(state["l_max"], packed.max_len)
                state["est"] = max(state["est"], -(-consumed // packed.n_records))
                if prep is not None:
                    prep(packed)  # wire prep off the dispatch thread
                pipe.pack_q.put(packed)
            return
        src = (_bgzf_source(in_stream, cfg.byte_limit, pipe.stop)
               if cfg.skip_records == 0 else None)
        if src is not None:
            # zero-copy gzip: BGZF windows inflate straight into the pack
            # source buffer; records parse in place (see _BgzfSource)
            def prep_put(packed):
                state["consumed"] += packed.n_records
                if prep is not None:
                    prep(packed)
                pipe.pack_q.put(packed)

            _produce_bgzf(src, pipe, state, mtr, params, need_rows,
                          lambda: _effective_chunk(cfg, state["l_max"]),
                          prep_put, batch_bytes=cfg.bytes_per_batch)
            return
        for chunk in iter_record_chunks(
            _bounded(in_stream, cfg.byte_limit),
            lambda: _effective_chunk(cfg, state["l_max"])[0],
            skip_records=cfg.skip_records,
            max_chunk_bytes=3 * cfg.bytes_per_batch,
        ):
            with _stage(mtr, "pack"):
                packed = pack_fastq(
                    chunk,
                    start_position=state["consumed"],
                    l_max=state["l_max"],
                    batch_multiple=_effective_chunk(cfg, state["l_max"])[1],
                    workspace=pipe.get_workspace(),
                    need_seq=params.trunc_n,
                    batch_bytes=cfg.bytes_per_batch,
                    need_rows=need_rows(),
                )
            if mtr is not None:
                mtr.add_chunk(packed.n_records, len(chunk))
            state["consumed"] += packed.n_records
            state["l_max"] = max(state["l_max"], packed.max_len)
            if prep is not None:
                prep(packed)  # wire prep off the dispatch thread
            pipe.pack_q.put(packed)

    def dispatcher(packed: PackedReads):
        # device dispatch on the main thread; the result fetch happens
        # in finalize (also main thread, after `window` newer dispatches)
        # so all device interaction stays strictly sequential while H2D
        # overlaps compute across chunks
        h2d = packed.qual.nbytes * (2 if params.trunc_n else 1)
        with _stage(mtr, "dispatch", h2d):
            if call_packed is not None:
                result = call_packed(packed)
            else:
                result = cuts_fn(packed.seq, packed.qual, packed.lengths,
                                 qual_clean=packed.qual_clean,
                                 wire=packed.wire)
        if mtr is not None:  # actual wire bytes (e.g. field-wire format)
            mtr.h2d_bytes[-1] = getattr(cuts_fn, "last_h2d", h2d)
        return packed, result

    def finalize(item):
        packed, result = item
        with _stage(mtr, "fetch"):
            mat = _materialize(result, packed.n_records)
        return packed, mat

    def consume(item):
        packed, (five, three, first_bad) = item
        with _stage(mtr, "consume"):
            _check_quality(packed, first_bad, params)
            n = packed.n_records
            kept, nbytes = _plan_assemble_fast(out_stream, packed, five,
                                               three, cfg.compat)
            if kept is None:
                keep = three >= 0
                kept = int(keep.sum())
                nbytes = 0
                if kept:
                    idx = np.flatnonzero(keep)
                    nbytes = _emit_records(
                        out_stream, packed.data, _sel(packed, idx),
                        five[idx].astype(np.int64),
                        three[idx].astype(np.int64),
                        cfg.compat, params.qualtype, outbuf,
                    )
            counters.kept += kept
            counters.discarded += n - kept
            counters.total += n
            if mtr is not None:
                mtr.add_out_bytes(nbytes)
            pipe.recycle(packed)
        if cfg.progress_cb is not None:
            cfg.progress_cb(counters)

    routes0 = _route_counts(cuts_fn)
    try:
        pipe.run(producer, dispatcher, consume, finalize=finalize,
                 window=window, on_drain=getattr(cuts_fn, "drain", None))
    finally:
        _outbuf_return(outbuf)
    if mtr is not None:
        mtr.set_routes(*(a - b for a, b in
                         zip(_route_counts(cuts_fn), routes0)))
    return counters


# ---------------------------------------------------------------------------
# Paired-end
# ---------------------------------------------------------------------------


def _pair_chunks_two_file(
    in1: BinaryIO, in2: BinaryIO, records_per_chunk, skip_each: int = 0,
    max_chunk_bytes: int = 0,
) -> Iterator[Tuple[bytes, bytes]]:
    # Only file 1 is byte-capped; file 2 follows file 1's exact record
    # count, so a short (byte-capped) chunk can never desynchronize the
    # pair streams even when mate record sizes differ.
    follow = {"n": 0}
    it1 = iter_record_chunks(in1, records_per_chunk, skip_records=skip_each,
                             max_chunk_bytes=max_chunk_bytes)
    it2 = iter_record_chunks(in2, lambda: follow["n"], skip_records=skip_each)
    while True:
        c1 = next(it1, None)
        if c1 is not None:
            nl = c1.count(b"\n")
            if not c1.endswith(b"\n"):
                nl += 1
            follow["n"] = max(nl // 4, 1)
        c2 = next(it2, None)
        if c1 is None and c2 is None:
            return
        if c1 is None or c2 is None:
            raise FastqValidationError(
                "Batch2 and Batch1 have different lengths, exiting"
            )
        yield c1, c2


def run_pe(
    in1: BinaryIO,
    in2: Optional[BinaryIO],
    *,
    interleaved: bool = False,
    out1: Optional[BinaryIO] = None,
    out2: Optional[BinaryIO] = None,
    singles_out: Optional[BinaryIO] = None,
    n_record_mode: bool = False,
    params: TrimParams,
    cfg: Optional[EngineConfig] = None,
    cuts_fn: Optional[CutsFn] = None,
    counters: Optional[PECounters] = None,
) -> PECounters:
    """Trim a paired-end stream.

    Modes (reference src/trim_paired.cpp:626-731):
    * two-file: ``in1``/``in2`` -> ``out1``/``out2`` + ``singles_out``
    * interleaved (-c -m): ``in1`` -> ``out1`` (interleaved) + ``singles_out``
    * interleaved -M (``n_record_mode``): ``in1`` -> ``out1`` with failed
      mates replaced by N records (pairing preserved); no singles file.

    Pair decision per src/trim_paired.cpp:543-567: both pass -> pair
    outputs; one passes -> singles (or N record); neither -> discarded
    (or two N records).
    """
    cfg = cfg or EngineConfig()
    cuts_fn = _adapt_cuts_fn(cuts_fn or default_cuts_fn(params, cfg))
    prep = _gated_prep(cuts_fn)
    call_packed = getattr(cuts_fn, "call_packed", None)
    need_rows = _need_rows_fn(cuts_fn)  # see run_se
    window = _finalize_window(cuts_fn)  # see run_se
    # two-file runs check out one workspace per mate file per chunk
    pipe = _Pipeline(cfg.prefetch,
                     n_workspaces=(cfg.prefetch + 2 + window)
                     * (1 if interleaved else 2),
                     need_seq=params.trunc_n)
    counters = counters if counters is not None else PECounters()
    if cfg.skip_records % 2:
        raise ValueError("pe skip_records must be even (whole pairs)")
    state = {"consumed": cfg.skip_records, "l_max": 0, "est": 0}
    outbuf = _outbuf_checkout()
    mtr = cfg.metrics

    def eff_chunk():
        """Per-chunk (records, batch_multiple), byte-capped for long reads.
        Both are even (whole pairs; mates packed adjacently always land in
        the same padded batch)."""
        eff, bm = _effective_chunk(cfg, state["l_max"])
        if bm % 2:
            bm *= 2
        return eff, bm

    def pack(chunk: bytes) -> PackedReads:
        with _stage(mtr, "pack"):
            packed = pack_fastq(
                chunk,
                start_position=state["consumed"],
                l_max=state["l_max"],
                batch_multiple=eff_chunk()[1],
                workspace=pipe.get_workspace(),
                need_seq=params.trunc_n,
                batch_bytes=cfg.bytes_per_batch,
                need_rows=need_rows(),
            )
        if mtr is not None:
            mtr.add_chunk(packed.n_records, len(chunk))
        state["l_max"] = max(state["l_max"], packed.max_len)
        return packed

    def put_interleaved(packed: PackedReads):
        if packed.n_records % 2:
            raise FastqValidationError(
                "Reading interleaved pair: read1 loaded, but no read2 "
                "to load. Maybe it's not an interleaved file?"
            )
        state["consumed"] += packed.n_records
        if prep is not None:
            prep(packed)  # wire prep off the dispatch thread
        pipe.pack_q.put((packed, None))

    def producer():
        if interleaved:
            mapped = (_mmap_input(in1, cfg.byte_limit)
                      if native.available() else None)
            if mapped is not None:  # zero-copy (see run_se)
                arr, off = mapped
                off = _skip_offset(arr, off, 4 * cfg.skip_records)
                while off is not None and off < arr.size:
                    ws = pipe.get_workspace()
                    eff, bm = eff_chunk()
                    with _stage(mtr, "pack"):
                        packed, consumed = pack_fastq_stream(
                            arr, off, eff,
                            start_position=state["consumed"],
                            l_max=state["l_max"],
                            batch_multiple=bm,
                            workspace=ws,
                            need_seq=params.trunc_n,
                            est_rec_bytes=state["est"],
                            need_rows=need_rows(),
                        )
                    off += consumed
                    if packed.n_records == 0:
                        pipe.ws_pool.put(ws)
                        break
                    if mtr is not None:
                        mtr.add_chunk(packed.n_records, consumed)
                    state["l_max"] = max(state["l_max"], packed.max_len)
                    state["est"] = max(
                        state["est"], -(-consumed // packed.n_records)
                    )
                    put_interleaved(packed)
                return
            src = (_bgzf_source(in1, cfg.byte_limit, pipe.stop)
                   if cfg.skip_records == 0 else None)
            if src is not None:  # zero-copy gzip (see run_se)
                _produce_bgzf(src, pipe, state, mtr, params, need_rows,
                              eff_chunk, put_interleaved, pair_align=True)
                return
            for chunk in iter_record_chunks(_bounded(in1, cfg.byte_limit),
                                            lambda: eff_chunk()[0],
                                            skip_records=cfg.skip_records,
                                            max_chunk_bytes=3 * cfg.bytes_per_batch,
                                            align_records=2):
                put_interleaved(pack(chunk))
        else:
            m1 = (_mmap_input(in1, cfg.byte_limit)
                  if native.available() else None)
            m2 = (_mmap_input(in2, cfg.byte_limit2)
                  if native.available() else None)
            if m1 is not None and m2 is not None:
                _produce_two_file_mmap(m1, m2)
                return
            # pack both mate files' chunks as ONE batch (mate-2 rows after
            # mate-1 rows): one device call per chunk, one shared source
            # buffer for output assembly (incl. mixed-source singles)
            for c1, c2 in _pair_chunks_two_file(
                _bounded(in1, cfg.byte_limit), _bounded(in2, cfg.byte_limit2),
                lambda: max(eff_chunk()[0] // 2, 4),
                skip_each=cfg.skip_records // 2,
                max_chunk_bytes=3 * cfg.bytes_per_batch,
            ):
                if not c1.endswith(b"\n"):
                    c1 += b"\n"  # keep c2's first line separate at EOF
                n1 = c1.count(b"\n") // 4
                packed = pack(c1 + c2)
                if packed.n_records != 2 * n1:
                    raise FastqValidationError(
                        "Batch2 and Batch1 have different lengths, exiting"
                    )
                state["consumed"] += packed.n_records
                if prep is not None:
                    prep(packed)
                pipe.pack_q.put((packed, n1))

    def _produce_two_file_mmap(m1, m2):
        """Zero-copy two-file producer, ONE device batch per chunk: both
        mate files are parsed straight from their mmaps into one shared
        workspace (mate-2 rows after mate-1 rows via an offset view), so
        the chunk ships as a single combined [2*n1, L] dispatch — one set
        of slice dispatches and one wire prep instead of two.  The
        per-mate index metadata stays separate (two source buffers) for
        output assembly.  Record positions are per input file, as in the
        reference's two readers (src/trim_paired.cpp:670-680).

        Falls back to two independent batches for a chunk when the
        combined pack cannot share one row stride (row-length growth
        discovered mid-chunk) or in indexed host-cuts mode (a combined
        line index cannot span two buffers)."""
        arr1, off1 = m1
        arr2, off2 = m2
        skip_each = cfg.skip_records // 2
        off1 = _skip_offset(arr1, off1, 4 * skip_each)
        off2 = _skip_offset(arr2, off2, 4 * skip_each)
        pos = skip_each
        # indexed chunks keep per-mate dispatch (two source buffers)
        while True:
            pk1 = pk2 = None
            n1 = n2 = 0
            c1 = c2 = 0
            comb = None
            eff, bm = eff_chunk()
            combine = nr = need_rows()
            timer = _stage(mtr, "pack")
            timer.__enter__()
            ws1 = None
            if off1 is not None and off1 < arr1.size:
                ws1 = pipe.get_workspace()
                if combine:
                    # reserve rows for BOTH mates up front: a later
                    # ensure() would reallocate and drop mate-1's rows
                    ws1.ensure(2 * eff + bm,
                               _round_up(max(state["l_max"], 1), 8), bm)
                pk1, c1 = pack_fastq_stream(
                    arr1, off1, eff, start_position=pos,
                    l_max=state["l_max"], batch_multiple=bm,
                    workspace=ws1, need_seq=params.trunc_n,
                    est_rec_bytes=state["est"],
                    batch_bytes=cfg.bytes_per_batch,
                    need_rows=nr,
                )
                off1 += c1
                state["l_max"] = max(state["l_max"], pk1.max_len)
                n1 = pk1.n_records
                if n1:
                    state["est"] = max(state["est"], -(-c1 // n1))
                if n1 == 0:
                    pipe.ws_pool.put(ws1)
                    ws1 = None
                    pk1 = None
            if off2 is not None and off2 < arr2.size:
                ws2 = (_OffsetWorkspace(ws1, n1, pk1.max_len)
                       if combine and n1 else pipe.get_workspace())
                try:
                    pk2, c2 = pack_fastq_stream(
                        arr2, off2, n1 if n1 else 1, start_position=pos,
                        l_max=pk1.max_len if combine and n1 else state["l_max"],
                        batch_multiple=bm,
                        workspace=ws2, need_seq=params.trunc_n,
                        est_rec_bytes=state["est"],
                        batch_bytes=cfg.bytes_per_batch,
                        need_rows=nr,
                    )
                except _OffsetOverflow:
                    # mate-2 rows outgrow the shared stride: repack this
                    # chunk as two independent batches.  The failed
                    # facade pack may have scribbled on pk1's padding
                    # rows — restore the all-zero invariant.
                    if pk1.n_records < pk1.batch_size:
                        pk1.qual[pk1.n_records:] = 0
                        pk1.lengths[pk1.n_records:] = 0
                    ws2 = pipe.get_workspace()
                    pk2, c2 = pack_fastq_stream(
                        arr2, off2, n1 if n1 else 1, start_position=pos,
                        l_max=state["l_max"], batch_multiple=bm,
                        workspace=ws2, need_seq=params.trunc_n,
                        est_rec_bytes=state["est"],
                        batch_bytes=cfg.bytes_per_batch,
                        need_rows=nr,
                    )
                off2 += c2
                state["l_max"] = max(state["l_max"], pk2.max_len)
                n2 = pk2.n_records
                if isinstance(ws2, _OffsetWorkspace):
                    pk2.workspace = None  # ws1 owns the rows
                    if n2 == n1:
                        comb = _combined_pair_batch(pk1, pk2, ws1, bm)
                if n2 == 0:
                    if not isinstance(ws2, _OffsetWorkspace):
                        pipe.ws_pool.put(ws2)
                    pk2 = None
            timer.__exit__()
            if n1 != n2:
                for pk in (pk1, pk2):
                    if pk is not None:
                        pipe.recycle(pk)
                raise FastqValidationError(
                    "Batch2 and Batch1 have different lengths, exiting"
                )
            if n1 == 0:
                return
            if mtr is not None:
                mtr.add_chunk(2 * n1, c1 + c2)
            pos += n1
            state["consumed"] += 2 * n1
            if prep is not None:
                if comb is not None:
                    prep(comb)
                else:
                    prep(pk1)
                    prep(pk2)
            if comb is not None:
                pk1.pair_batch = comb
            pipe.pack_q.put(((pk1, pk2), None))

    def dispatcher(item):
        # device dispatch only; fetch deferred to finalize (see run_se)
        packed, n1 = item
        mul = 2 if params.trunc_n else 1
        def call(pk):
            if call_packed is not None:
                return call_packed(pk)
            return cuts_fn(pk.seq, pk.qual, pk.lengths,
                           qual_clean=pk.qual_clean, wire=pk.wire)

        if isinstance(packed, tuple):  # split mate batches (mmap producer)
            pk1, pk2 = packed
            comb = getattr(pk1, "pair_batch", None)
            if comb is not None:
                # one combined [2*n1, L] dispatch: one set of slice
                # dispatches, one wire prep
                with _stage(mtr, "dispatch", comb.qual.nbytes * mul):
                    result = call(comb)
                if mtr is not None:
                    mtr.h2d_bytes[-1] = getattr(cuts_fn, "last_h2d",
                                                comb.qual.nbytes * mul)
                return packed, n1, result
            with _stage(mtr, "dispatch",
                        (pk1.qual.nbytes + pk2.qual.nbytes) * mul):
                r1 = call(pk1)
                h2d = getattr(cuts_fn, "last_h2d", pk1.qual.nbytes * mul)
                r2 = call(pk2)
                h2d += getattr(cuts_fn, "last_h2d", pk2.qual.nbytes * mul)
            if mtr is not None:  # actual wire bytes (e.g. field-wire format)
                mtr.h2d_bytes[-1] = h2d
            return packed, n1, (r1, r2)
        with _stage(mtr, "dispatch", packed.qual.nbytes * mul):
            result = call(packed)
        if mtr is not None:
            mtr.h2d_bytes[-1] = getattr(cuts_fn, "last_h2d",
                                        packed.qual.nbytes * mul)
        return packed, n1, result

    def finalize(item):
        packed, n1, result = item
        with _stage(mtr, "fetch"):
            if isinstance(packed, tuple):
                pk1, pk2 = packed
                comb = getattr(pk1, "pair_batch", None)
                if comb is not None:
                    f, t, bad = _materialize(result, comb.n_records)
                    k = pk1.n_records
                    mat = ((f[:k], t[:k], bad[:k]),
                           (f[k:2 * k], t[k:2 * k], bad[k:2 * k]))
                    pk1.pair_batch = None  # drop combined views pre-recycle
                else:
                    mat = (_materialize(result[0], pk1.n_records),
                           _materialize(result[1], pk2.n_records))
            else:
                mat = _materialize(result, packed.n_records)
        return packed, n1, mat

    def consume(item):
        packed, n1, result = item
        with _stage(mtr, "consume"):
            if interleaved:
                _write_interleaved_chunk(packed, result, counters, out1,
                                         singles_out, n_record_mode, params,
                                         cfg, outbuf)
                pipe.recycle(packed)
            elif isinstance(packed, tuple):
                p1k, p2k = packed
                r1, r2 = result
                _write_two_file_chunk(p1k, p2k, r1, r2, counters, out1, out2,
                                      singles_out, params, cfg, outbuf)
                pipe.recycle(p1k, p2k)
            else:
                p1, p2 = _split_packed(packed, n1)
                f, t, bad = result
                r1 = (f[:n1], t[:n1], bad[:n1])
                r2 = (f[n1:], t[n1:], bad[n1:])
                _write_two_file_chunk(p1, p2, r1, r2, counters, out1, out2,
                                      singles_out, params, cfg, outbuf)
                pipe.recycle(packed)
        if cfg.progress_cb is not None:
            cfg.progress_cb(counters)

    routes0 = _route_counts(cuts_fn)
    try:
        pipe.run(producer, dispatcher, consume, finalize=finalize,
                 window=window, on_drain=getattr(cuts_fn, "drain", None))
    finally:
        _outbuf_return(outbuf)
    if mtr is not None:
        mtr.set_routes(*(a - b for a, b in
                         zip(_route_counts(cuts_fn), routes0)))
    return counters


class _OffsetOverflow(Exception):
    """Mate-2 rows cannot share mate-1's row stride/capacity (row-length
    growth discovered mid-chunk); the producer repacks the chunk as two
    independent batches."""


class _OffsetWorkspace:
    """PackWorkspace view starting at record ``row0`` with a FIXED row
    stride: the combined pe batch packs mate-2's rows/index right after
    mate-1's in the same buffers, so the chunk dispatches as one device
    batch.  ``ensure`` never reallocates — any growth request raises
    :class:`_OffsetOverflow` (rows before ``row0`` would be lost)."""

    def __init__(self, ws: PackWorkspace, row0: int, stride: int):
        self._stride = stride
        self.capacity = ws.capacity - row0
        self.L = stride
        self.need_seq = ws.need_seq
        self.est_rec_bytes = ws.est_rec_bytes
        self.starts4 = ws.starts4[4 * row0:]
        self.lens4 = ws.lens4[4 * row0:]
        self.lengths = ws.lengths[row0:]
        flat = ws.qual.reshape(-1)
        self.qual = flat[row0 * stride:]
        if ws.need_seq:
            self.seq = ws.seq.reshape(-1)[row0 * stride:]
        else:
            self.seq = self.qual

    def ensure(self, max_records: int, L: int, batch_multiple: int) -> None:
        B = _round_up(max(max_records, 1), batch_multiple)
        if L != self._stride or B > self.capacity:
            raise _OffsetOverflow()


def _combined_pair_batch(pk1: PackedReads, pk2: PackedReads,
                         ws: PackWorkspace, bm: int) -> PackedReads:
    """One [2*n1, L] batch over rows packed back to back in ``ws``
    (mate-1 then mate-2).  Index metadata stays on pk1/pk2 (two source
    buffers); this object only carries the fused rows for dispatch."""
    n1 = pk1.n_records
    L = pk1.seq.shape[1]
    total = 2 * n1
    B = _round_up(total, _clamp_bm(bm, total, L, None))
    flat_q = ws.qual.reshape(-1)
    qual = flat_q[: B * L].reshape(B, L)
    seq = (ws.seq.reshape(-1)[: B * L].reshape(B, L) if ws.need_seq else qual)
    covered = n1 + pk2.batch_size  # pk2's own pack zeroed up to here
    if B > covered:
        qual[covered:] = 0
        ws.lengths[covered:B] = 0
    return dataclasses.replace(
        pk1,
        seq=seq,
        qual=qual,
        lengths=ws.lengths[:B],
        n_records=total,
        workspace=None,  # pk1 owns/recycles the real workspace
        qual_clean=pk1.qual_clean and pk2.qual_clean,
        wire=None,
    )


def _split_packed(packed: PackedReads, n1: int):
    """Two logical PackedReads views over one combined two-file batch
    (mate-1 rows [0, n1), mate-2 rows [n1, 2*n1); same data buffer)."""
    import dataclasses as _dc

    def view(lo, hi, ws):
        return _dc.replace(
            packed,
            lengths=packed.lengths[lo:hi],
            name_start=packed.name_start[lo:hi],
            name_len=packed.name_len[lo:hi],
            seq_start=packed.seq_start[lo:hi],
            comment_start=packed.comment_start[lo:hi],
            comment_len=packed.comment_len[lo:hi],
            qual_start=packed.qual_start[lo:hi],
            positions=packed.positions[lo:hi],
            n_records=hi - lo,
            workspace=ws,
        )

    return view(0, n1, None), view(n1, 2 * n1, None)


def _sel(packed: PackedReads, idx: np.ndarray, offset: int = 0) -> dict:
    return dict(
        name_start=packed.name_start[idx] + offset,
        name_len=packed.name_len[idx],
        seq_start=packed.seq_start[idx] + offset,
        comment_start=packed.comment_start[idx] + offset,
        comment_len=packed.comment_len[idx],
        qual_start=packed.qual_start[idx] + offset,
    )


def _interleave_fields(f1: dict, f2: dict, k: int) -> dict:
    """Merge two per-pair field dicts into mate-interleaved order."""
    out = {}
    for key in f1:
        a = np.empty(2 * k, dtype=np.asarray(f1[key]).dtype)
        a[0::2] = f1[key]
        a[1::2] = f2[key]
        out[key] = a
    return out


def _update_pe_counters(c: PECounters, p1: np.ndarray, p2: np.ndarray):
    both = p1 & p2
    only1 = p1 & ~p2
    only2 = p2 & ~p1
    neither = ~p1 & ~p2
    c.kept_p += 2 * int(both.sum())
    c.kept_s1 += int(only1.sum())
    c.kept_s2 += int(only2.sum())
    c.discard_s2 += int(only1.sum())
    c.discard_s1 += int(only2.sum())
    c.discard_p += 2 * int(neither.sum())
    c.total = c.kept_p + c.kept_s1 + c.kept_s2 + c.discard_p + c.discard_s1 + c.discard_s2


def _write_interleaved_chunk(
    packed, result, counters, out1, singles_out, n_record_mode, params, cfg,
    outbuf=None,
):
    n = packed.n_records
    five, three, first_bad = result  # materialized by the dispatcher
    five = five.astype(np.int64)
    three = three.astype(np.int64)
    _check_quality(packed, first_bad, params)
    f1, t1 = five[0::2], three[0::2]
    f2, t2 = five[1::2], three[1::2]
    p1, p2 = t1 >= 0, t2 >= 0
    _update_pe_counters(counters, p1, p2)
    idx1 = np.arange(n)[0::2]
    idx2 = np.arange(n)[1::2]

    if n_record_mode:
        # every pair appears; failed mates become N records
        sel1 = _sel(packed, idx1)
        sel2 = _sel(packed, idx2)
        k = idx1.size
        fields = _interleave_fields(sel1, sel2, k)
        fv = np.empty(2 * k, np.int64)
        tv = np.empty(2 * k, np.int64)
        fv[0::2], fv[1::2] = np.maximum(f1, 0), np.maximum(f2, 0)
        tv[0::2], tv[1::2] = np.maximum(t1, 0), np.maximum(t2, 0)
        mask = np.empty(2 * k, bool)
        mask[0::2], mask[1::2] = ~p1, ~p2
        _emit_records(out1, packed.data, fields, fv, tv, cfg.compat,
                      params.qualtype, outbuf, n_record_mask=mask)
        return

    both = p1 & p2
    if both.any():
        # fused fast path: both-pass pairs are the even/odd row pairs of
        # the interleaved batch, selected by mask in record order
        kf, _ = _plan_assemble_fast(out1, packed, five, three, cfg.compat,
                                    three_mask=np.repeat(both, 2))
        if kf is None:
            kb = np.flatnonzero(both)
            fields = _interleave_fields(
                _sel(packed, idx1[kb]), _sel(packed, idx2[kb]), kb.size
            )
            fv = np.empty(2 * kb.size, np.int64)
            tv = np.empty(2 * kb.size, np.int64)
            fv[0::2], fv[1::2] = f1[kb], f2[kb]
            tv[0::2], tv[1::2] = t1[kb], t2[kb]
            _emit_records(out1, packed.data, fields, fv, tv, cfg.compat,
                          params.qualtype, outbuf)
    single = p1 ^ p2
    if single.any() and singles_out is not None:
        ks = np.flatnonzero(single)
        take1 = p1[ks]
        rows = np.where(take1, idx1[ks], idx2[ks])
        mask_s = np.zeros(n, bool)
        mask_s[rows] = True
        kf, _ = _plan_assemble_fast(singles_out, packed, five, three,
                                    cfg.compat, three_mask=mask_s)
        if kf is None:
            fv = np.where(take1, f1[ks], f2[ks])
            tv = np.where(take1, t1[ks], t2[ks])
            _emit_records(singles_out, packed.data, _sel(packed, rows), fv,
                          tv, cfg.compat, params.qualtype, outbuf)


def _write_two_file_chunk(
    p1k, p2k, r1, r2, counters, out1, out2, singles_out, params, cfg,
    outbuf=None,
):
    n = p1k.n_records
    f1, t1, bad1 = r1  # materialized by the dispatcher
    f2, t2, bad2 = r2
    f1, t1 = f1.astype(np.int64), t1.astype(np.int64)
    f2, t2 = f2.astype(np.int64), t2.astype(np.int64)
    _check_quality(p1k, bad1, params)
    _check_quality(p2k, bad2, params)
    p1, p2 = t1 >= 0, t2 >= 0
    _update_pe_counters(counters, p1, p2)

    both = p1 & p2
    if both.any():
        # fused fast path: mask-select the both-pass records in place
        # (order preserved); numpy fallback for exotic layouts/sinks
        k1, _ = _plan_assemble_fast(out1, p1k, f1, t1, cfg.compat,
                                    three_mask=both)
        k2, _ = _plan_assemble_fast(out2, p2k, f2, t2, cfg.compat,
                                    three_mask=both)
        kb = None
        if k1 is None:
            kb = np.flatnonzero(both)
            _emit_records(out1, p1k.data, _sel(p1k, kb), f1[kb], t1[kb],
                          cfg.compat, params.qualtype, outbuf)
        if k2 is None:
            if kb is None:
                kb = np.flatnonzero(both)
            _emit_records(out2, p2k.data, _sel(p2k, kb), f2[kb], t2[kb],
                          cfg.compat, params.qualtype, outbuf)
    single = p1 ^ p2
    if single.any() and singles_out is not None:
        # singles come from either source file, in pair order
        ks = np.flatnonzero(single)
        take1 = p1[ks]
        fv = np.where(take1, f1[ks], f2[ks])
        tv = np.where(take1, t1[ks], t2[ks])
        if p1k.data is p2k.data:
            # both mates in one source buffer: single assembly pass
            s1 = _sel(p1k, ks)
            s2 = _sel(p2k, ks)
            fields = {key: np.where(take1, s1[key], s2[key]) for key in s1}
            _emit_records(singles_out, p1k.data, fields, fv, tv,
                          cfg.compat, params.qualtype, outbuf)
        else:
            # two source buffers (zero-copy mmap producer): compute the
            # interleaved output offsets once, then one placement pass
            # per source — never concatenate the buffers
            nl = np.where(take1, p1k.name_len[ks], p2k.name_len[ks])
            cl = np.where(take1, p1k.comment_len[ks], p2k.comment_len[ks])
            sizes = record_out_sizes(nl, cl, fv, tv, cfg.compat)
            offsets = np.zeros(ks.size, np.int64)
            if ks.size > 1:
                np.cumsum(sizes[:-1], out=offsets[1:])
            total = int(offsets[-1] + sizes[-1])
            reserve = getattr(singles_out, "reserve", None)
            if reserve is not None and native.available():
                # scatter both sources straight into the output mapping
                buf, start = reserve(total)
                offsets += start
            else:
                buf = (outbuf or OutputBuffer()).ensure(total)
            for pk, fx, tx, take in (
                (p1k, f1, t1, take1),
                (p2k, f2, t2, ~take1),
            ):
                sub = np.flatnonzero(take)
                if sub.size:
                    rows = ks[sub]
                    assemble_records_at(
                        pk.data, **_sel(pk, rows),
                        five=fx[rows], three=tx[rows],
                        offsets=offsets[sub], out_buf=buf,
                        compat=cfg.compat, qualtype=params.qualtype,
                    )
            if reserve is not None and native.available():
                singles_out.commit(total)
            else:
                singles_out.write(memoryview(buf)[:total])
