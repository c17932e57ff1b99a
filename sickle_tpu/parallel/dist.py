"""Multi-host distribution: runtime init, input sharding, counter merge.

The reference is strictly single-process (SURVEY.md §2.2/§5.8).  Here
every process streams its own shard of the input (reads are
embarrassingly parallel; no cross-device traffic on the read path), the
devices of one process shard each batch row-wise
(``mesh.sharded_cuts_fn``), and the ONLY global communication is the
end-of-run scalar counter reduction.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from ..ops.trim import TrimParams, compute_cuts
from .mesh import DATA_AXIS


def init_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> None:
    """Initialize the JAX distributed runtime (multi-host).

    Wires the JAX coordination service so ``jax.devices()`` spans the
    processes.  Each process opens every GPU it can see, and a JAX GPU
    process reserves most of a card's memory: run one process per host
    (its cards sharded through ``--devices``), or give each process its
    own card with ``CUDA_VISIBLE_DEVICES``.
    """
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )


def host_file_shard(paths: Sequence, process_id: Optional[int] = None,
                    num_processes: Optional[int] = None) -> List:
    """Round-robin assignment of input files to this host.

    SERIAL gzip inputs are not byte-splittable, so multi-host sharding
    for them is by file (pre-shard datasets per host); plain files and
    BGZF gzip (including this framework's own ``-g`` output) are
    byte-range split with :func:`split_record_ranges`.
    """
    pid = jax.process_index() if process_id is None else process_id
    n = jax.process_count() if num_processes is None else num_processes
    return [p for i, p in enumerate(paths) if i % n == pid]


def _looks_like_record_start(lines: List[bytes]) -> bool:
    """Phase detection for FASTQ byte-range splitting: a line is a record
    start if it begins with '@', the line 2 later begins with '+', and the
    seq/qual line lengths match.  ('@' can also start a quality line, so
    the single-char test alone is ambiguous.)"""
    if len(lines) < 4:
        return False
    return (
        lines[0][:1] == b"@"
        and lines[2][:1] == b"+"
        and len(lines[1]) == len(lines[3])
    )


def _first_record_start(probe: bytes) -> Optional[int]:
    """Offset within ``probe`` of the first FASTQ record start after a
    line boundary, else None."""
    starts = []
    pos = probe.find(b"\n")
    while pos >= 0 and pos + 1 < len(probe):
        starts.append(pos + 1)
        pos = probe.find(b"\n", pos + 1)
    for s in starts:
        if _looks_like_record_start(probe[s:].split(b"\n")):
            return s
    return None


class _PlainSpan:
    """Record-address space of a plain FASTQ file (mmap-backed)."""

    def __init__(self, path):
        self.arr = _mapped(path)
        self.size = int(self.arr.size)

    def probe(self, offset: int, n: int) -> bytes:
        return self.arr[offset : offset + n].tobytes()

    def records_before(self, offset: int) -> int:
        """Record count in [0, offset) (offset must be record-aligned)."""
        from ..io import native

        lib = native.get_lib()
        view = self.arr[:offset]
        if lib is not None:
            import ctypes

            nl = int(lib.sk_count_newlines(
                native.ptr(view, ctypes.c_uint8), view.size))
        else:
            nl = int(np.count_nonzero(view == 0x0A))
        return nl // 4

    def offset_of_record(self, k: int) -> int:
        """Byte offset where 0-based record ``k`` starts (size if past EOF)."""
        if k == 0:
            return 0
        from ..io import native

        lib = native.get_lib()
        if lib is not None:
            import ctypes

            pos = int(lib.sk_kth_newline(
                native.ptr(self.arr, ctypes.c_uint8), self.arr.size, 4 * k))
        else:
            nl = np.flatnonzero(self.arr == 0x0A)
            pos = int(nl[4 * k - 1]) if nl.size >= 4 * k else -1
        return self.size if pos < 0 else pos + 1


class _BgzfSpan:
    """Record-address space of a BGZF FASTQ file, in UNCOMPRESSED bytes.

    The block index makes the compressed file byte-splittable: offsets
    here are uncompressed offsets, which the engine consumes directly
    (BgzfReader.seek + byte_limit on the inflated stream).  Counting
    streams block-parallel inflate windows (io/_fastqio.cpp), so a
    boundary probe costs one window and a record count costs one prefix
    pass — never a whole-file inflate per host.

    Sharding-time cost scaling: ``records_before``/``offset_of_record``
    inflate from offset 0 per boundary, so computing N shard boundaries
    is O(N * file) of (block-parallel) inflate at STARTUP — fine at the
    2-8 hosts this targets, noticeable by ~64.  The fix, if a fleet that
    wide materializes, is one shared prefix pass caching per-block
    newline counts in the block index (the scan is already blockwise);
    the per-read path is unaffected either way.
    """

    CHUNK = 1 << 24

    def __init__(self, path, reader):
        self._r = reader
        self.size = int(reader.usize)

    def probe(self, offset: int, n: int) -> bytes:
        self._r.seek(offset)
        return self._r.read(n)

    def records_before(self, offset: int) -> int:
        self._r.seek(0)
        left, nl = offset, 0
        while left > 0:
            chunk = self._r.read(min(left, self.CHUNK))
            if not chunk:
                break
            nl += chunk.count(b"\n")
            left -= len(chunk)
        return nl // 4

    def offset_of_record(self, k: int) -> int:
        if k == 0:
            return 0
        self._r.seek(0)
        need, pos = 4 * k, 0
        while True:
            chunk = self._r.read(self.CHUNK)
            if not chunk:
                return self.size
            c = chunk.count(b"\n")
            if c >= need:
                nls = np.flatnonzero(
                    np.frombuffer(chunk, np.uint8) == 0x0A)
                return pos + int(nls[need - 1]) + 1
            need -= c
            pos += len(chunk)


def open_span(path):
    """The record-address space of ``path``: plain bytes, or BGZF
    uncompressed bytes (block-splittable gzip).  Raises ValueError for
    serial gzip, which has no splittable address space."""
    from ..io.compression import BgzfReader, is_gzip
    from ..io import native

    if is_gzip(path):
        r = BgzfReader.try_open(path) if native.available() else None
        if r is None:
            raise ValueError(
                f"'{path}' is serial gzip (not BGZF): no byte-splittable "
                "address space; pre-shard per host"
            )
        return _BgzfSpan(path, r)
    return _PlainSpan(path)


def realign_to_record(path, offset: int, probe_bytes: int = 1 << 16) -> int:
    """Smallest byte offset >= ``offset`` that starts a FASTQ record."""
    return _realign_span(open_span(path), offset, probe_bytes)


def _realign_span(span, offset: int, probe_bytes: int = 1 << 16) -> int:
    if offset == 0:
        return 0
    probe = span.probe(offset, probe_bytes)
    s = _first_record_start(probe)
    if s is None:
        raise ValueError(
            f"no FASTQ record boundary within {probe_bytes} bytes of offset {offset}"
        )
    return offset + s


def split_record_ranges(path, n_shards: int) -> List[Tuple[int, int]]:
    """Split a FASTQ file (plain, or BGZF in uncompressed space) into
    record-aligned (offset, length) byte ranges, one per shard."""
    return _split_span(open_span(path), n_shards)


def _split_span(span, n_shards: int) -> List[Tuple[int, int]]:
    size = span.size
    bounds = [_realign_span(span, size * i // n_shards) for i in range(n_shards)]
    bounds.append(size)
    return [(bounds[i], bounds[i + 1] - bounds[i]) for i in range(n_shards)]


def _mapped(path) -> np.ndarray:
    return np.memmap(path, dtype=np.uint8, mode="r")


def shard_record_ranges(path, n_shards: int, align: int = 1) -> List[Tuple[int, int]]:
    """Record-aligned (offset, length) byte ranges, one per host, with
    every boundary additionally on an ``align``-record multiple
    (interleaved pe passes 2 so no host splits a pair).  BGZF inputs
    shard in uncompressed space (the engine seeks the block index).

    The per-host work is an independent stream over its range — no
    cross-host traffic on the read path (SURVEY.md §2.2); concatenating
    the shard outputs in shard order reproduces the single-host bytes.
    """
    span = open_span(path)
    ranges = _split_span(span, n_shards)
    if align <= 1:
        return ranges
    bounds = []
    for off, _length in ranges:
        rec = span.records_before(off)
        if rec % align:
            off = span.offset_of_record(rec + (align - rec % align))
        bounds.append(off)
    bounds.append(span.size)
    return [(bounds[i], bounds[i + 1] - bounds[i]) for i in range(n_shards)]


def shard_paired_ranges(
    path1, path2, n_shards: int
) -> List[Tuple[Tuple[int, int], Tuple[int, int]]]:
    """Per-host byte ranges for a two-file pe run, split by PAIR index.

    File 1 is split byte-proportionally (record-aligned); file 2's
    boundaries are derived from file 1's record counts so both shards of a
    host hold exactly the same mates — pair decisions never cross hosts.
    Either file may be plain or BGZF (uncompressed-space offsets).
    """
    span1 = open_span(path1)
    span2 = open_span(path2)
    r1 = _split_span(span1, n_shards)
    recs = [span1.records_before(off) for off, _ in r1]
    bounds2 = [span2.offset_of_record(k) for k in recs] + [span2.size]
    out = []
    for i in range(n_shards):
        out.append(
            (r1[i], (bounds2[i], bounds2[i + 1] - bounds2[i]))
        )
    return out


@dataclasses.dataclass
class GlobalCounts:
    total: jnp.ndarray
    kept: jnp.ndarray


def sharded_trim_step(params: TrimParams, mesh: Mesh, kernel=compute_cuts):
    """The full sharded device step: per-row cuts + psum'd global counters.

    This is the complete multi-chip computation — the per-read work is
    row-local; the psum over the ``data`` axis is the only collective, and
    it reduces two scalars.  Returns a jitted fn
    ``(seq, qual, lengths) -> (five, three, first_bad, total, kept)``
    where the counters are replicated across the mesh.
    """

    def step(seq, qual, lengths):
        five, three, first_bad = kernel(seq, qual, lengths, params)
        valid = lengths > 0
        keep = three >= 0
        total = jax.lax.psum(jnp.sum(valid.astype(jnp.int32)), DATA_AXIS)
        kept = jax.lax.psum(jnp.sum(keep.astype(jnp.int32)), DATA_AXIS)
        return five, three, first_bad, total, kept

    return jax.jit(
        jax.shard_map(
            step,
            mesh=mesh,
            in_specs=(P(DATA_AXIS, None), P(DATA_AXIS, None), P(DATA_AXIS)),
            out_specs=(P(DATA_AXIS), P(DATA_AXIS), P(DATA_AXIS), P(), P()),
        )
    )


def allreduce_host_counters(values: Sequence[int]) -> List[int]:
    """Sum per-host scalar counters across all hosts (no-op single-host).

    Used to merge the exact host-side SE/PE counters at end of run; rides
    the same coordination fabric as the device collectives.
    """
    if jax.process_count() == 1:
        return list(values)
    from jax.experimental import multihost_utils

    arr = np.asarray(values, dtype=np.int64)
    gathered = multihost_utils.process_allgather(arr)
    return list(np.sum(gathered, axis=0))
