"""Per-chunk pipeline stage metrics (SURVEY.md §5.1).

The reference's only observability is the ``msg()`` debug macro and
end-of-run counters (src/sickle.h:99-120, src/trim_single.cpp:347).  For
a pipelined engine that is not enough: when a pass is slow, the record
must say *which chunk* and *which stage* (pack / dispatch / fetch /
assemble+write) ate the time, and where each chunk's cuts were computed
(device or host kernel).

Stage rows are appended by each pipeline stage in its own thread; FIFO
queues guarantee the per-stage lists stay index-aligned per chunk, so no
chunk ids need to be threaded through the queues.  Overhead when
disabled: one ``is None`` test per stage per chunk.

Stages recorded per chunk:

* ``pack``      — host parse+pack (producer thread), plus input bytes
* ``dispatch``  — device RPC issue (main thread; H2D + async compute)
* ``fetch``     — result materialization (main thread; D2H sync point)
* ``consume``   — quality recheck + assemble + output write (writer thread)

Per run: how many chunks the device computed, how many the host kernel
computed, and how many of those the hybrid router rescued from the
device (``device_chunks`` / ``host_chunks`` / ``rescued_chunks``).  A
paired chunk whose mates could not share one batch counts once per mate.
"""

from __future__ import annotations

import json
import sys
import time
from typing import Optional


class StageTimer:
    """Context manager appending elapsed ms to a Metrics stage list."""

    __slots__ = ("_lst", "_t0")

    def __init__(self, lst: list):
        self._lst = lst

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self._lst.append((time.perf_counter() - self._t0) * 1e3)
        return False


class Metrics:
    """Collects per-chunk stage timings for one engine run."""

    def __init__(self) -> None:
        self.pack_ms: list = []
        self.dispatch_ms: list = []
        self.fetch_ms: list = []
        self.consume_ms: list = []
        self.records: list = []
        self.in_bytes: list = []
        self.h2d_bytes: list = []
        self.out_bytes: list = []
        self.device_chunks = 0
        self.host_chunks = 0
        self.rescued_chunks = 0
        self.t_start = time.perf_counter()

    # -- stage hooks (each returns a context manager) -----------------
    def pack(self) -> StageTimer:
        return StageTimer(self.pack_ms)

    def add_chunk(self, records: int, in_bytes: int) -> None:
        """Record a packed chunk's size (call once per chunk, post-pack)."""
        self.records.append(records)
        self.in_bytes.append(in_bytes)

    def dispatch(self, h2d_bytes: int) -> StageTimer:
        self.h2d_bytes.append(h2d_bytes)
        return StageTimer(self.dispatch_ms)

    def fetch(self) -> StageTimer:
        return StageTimer(self.fetch_ms)

    def consume(self) -> StageTimer:
        return StageTimer(self.consume_ms)

    def add_out_bytes(self, n: int) -> None:
        self.out_bytes.append(n)

    def set_routes(self, device: int, host: int, rescued: int) -> None:
        """Record where the run's chunks were computed (once per run)."""
        self.device_chunks = device
        self.host_chunks = host
        self.rescued_chunks = rescued

    # -- analysis ------------------------------------------------------
    @property
    def n_chunks(self) -> int:
        return len(self.records)

    def chunk_device_ms(self) -> list:
        """Per-chunk device interaction time (dispatch + fetch)."""
        return [d + f for d, f in zip(self.dispatch_ms, self.fetch_ms)]

    def stalled(self, abs_ms: float = 2000.0, rel: float = 20.0) -> bool:
        """True if any chunk's device time is a stall outlier.

        A stall means one chunk's device time exceeds ``abs_ms`` AND
        ``rel``x the median chunk device time (a uniformly slow device
        is not flagged — that is an honest throughput state).
        """
        dev = self.chunk_device_ms()
        if len(dev) < 2:
            return False
        med = sorted(dev)[len(dev) // 2]
        worst = max(dev)
        return worst > abs_ms and worst > rel * max(med, 1e-3)

    def summary(self) -> dict:
        def agg(lst):
            if not lst:
                return {"total_ms": 0.0, "median_ms": 0.0, "max_ms": 0.0}
            return {
                "total_ms": round(sum(lst), 2),
                "median_ms": round(sorted(lst)[len(lst) // 2], 3),
                "max_ms": round(max(lst), 2),
            }

        return {
            "chunks": self.n_chunks,
            "device_chunks": self.device_chunks,
            "host_chunks": self.host_chunks,
            "rescued_chunks": self.rescued_chunks,
            "records": sum(self.records),
            "in_bytes": sum(self.in_bytes),
            "h2d_bytes": sum(self.h2d_bytes),
            "out_bytes": sum(self.out_bytes),
            "wall_ms": round((time.perf_counter() - self.t_start) * 1e3, 2),
            "pack": agg(self.pack_ms),
            "dispatch": agg(self.dispatch_ms),
            "fetch": agg(self.fetch_ms),
            "consume": agg(self.consume_ms),
            "stalled": self.stalled(),
        }

    def report(self, stream=None, per_chunk: bool = True) -> None:
        """Human-readable table to ``stream`` (default stderr)."""
        out = stream or sys.stderr
        if per_chunk and self.n_chunks:
            out.write(
                "chunk  records      pack  dispatch     fetch   consume"
                "   h2d_KB\n"
            )
            n = self.n_chunks
            for i in range(n):
                def col(lst, j=i):
                    return f"{lst[j]:9.2f}" if j < len(lst) else "        -"
                h2d = (f"{self.h2d_bytes[i] / 1024:8.0f}"
                       if i < len(self.h2d_bytes) else "       -")
                rec = (f"{self.records[i]:8d}"
                       if i < len(self.records) else "       -")
                out.write(
                    f"{i:5d} {rec} {col(self.pack_ms)}"
                    f" {col(self.dispatch_ms)} {col(self.fetch_ms)}"
                    f" {col(self.consume_ms)} {h2d}\n"
                )
        out.write("metrics: " + json.dumps(self.summary()) + "\n")
        out.flush()


def maybe(metrics: Optional[Metrics], stage: str, *args):
    """Stage hook that no-ops when metrics is None.

    Returns a context manager; usage:
        with maybe(m, "pack", n_records, n_bytes): ...
    """
    if metrics is None:
        return _NULL
    return getattr(metrics, stage)(*args)


class _NullTimer:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL = _NullTimer()
