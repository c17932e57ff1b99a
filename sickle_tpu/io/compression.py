"""Transparent plain/gzip stream handling, with parallel BGZF fast paths.

The reference opens every input with zlib's gzopen, which transparently
reads both plain and gzipped files (/root/reference/src/GZReader.cpp:13).
We sniff the gzip magic bytes instead.  Output gzip uses streamed writes
(gzwrite semantics) — never the reference's broken
``gzprintf(file, payload)`` which treats quality bytes as a format string
and truncates (SURVEY.md §2.4.6).

gzip is inherently serial to inflate — EXCEPT blocked gzip (BGZF, the
SAM-spec format emitted by bgzip/samtools and common for sequencing
data), whose per-block 'BC' size field lets both directions run one
block per core (io/_fastqio.cpp).  Inputs are header-sniffed: BGZF files
decode in parallel windows; anything else falls back to the serial zlib
stream.  ``-g`` output is written AS BGZF (still a perfectly valid .gz
for any consumer), so compression parallelizes and our own outputs
re-ingest in parallel.
"""

from __future__ import annotations

import gzip
import io
import os
import stat
import struct
import sys
import zlib
from typing import BinaryIO, Union

import numpy as np

from . import native

GZIP_MAGIC = b"\x1f\x8b"

PathLike = Union[str, os.PathLike]


def is_gzip(path: PathLike) -> bool:
    with open(path, "rb") as f:
        return f.read(2) == GZIP_MAGIC


def open_input(path: PathLike) -> BinaryIO:
    """Open a FASTQ file for reading, decompressing gzip transparently.

    BGZF-blocked gzip takes the parallel block decoder; other gzip takes
    the serial zlib stream; plain files are buffered raw.
    """
    if is_gzip(path):
        if native.available():
            r = BgzfReader.try_open(path)
            if r is not None:
                return r
        return gzip.open(path, "rb")
    return open(path, "rb", buffering=1 << 20)


class BgzfReader(io.RawIOBase):
    """Parallel windowed BGZF decoder.

    The whole file is block-indexed once by a header walk (no inflate),
    then ``read`` refills a window by inflating the next blocks one per
    core into a single buffer.  Runs on the engine's producer thread, so
    decompression overlaps device dispatch and output writing.
    """

    WINDOW_BLOCKS = 512  # 48 KiB uncompressed each -> ~24 MiB per refill

    def __init__(self, path: PathLike, offs, csizes, usizes, arr):
        self._arr = arr
        self._offs = offs
        self._csizes = csizes
        self._uoffs = np.zeros(usizes.size, np.int64)
        np.cumsum(usizes[:-1], out=self._uoffs[1:])
        self._usizes = usizes
        self._next_block = 0
        self._buf = memoryview(b"")
        self._buf_pos = 0
        self._out = np.empty(0, np.uint8)  # reused window (warm pages)

    @classmethod
    def try_open(cls, path: PathLike):
        """A reader if ``path`` is BGZF end to end, else None."""
        import ctypes

        lib = native.get_lib()
        try:
            arr = np.memmap(path, dtype=np.uint8, mode="r")
        except (OSError, ValueError):
            return None
        if arr.size < 28:
            return None
        max_blocks = arr.size // 28 + 2
        offs = np.empty(max_blocks, np.int64)
        csizes = np.empty(max_blocks, np.int64)
        usizes = np.empty(max_blocks, np.int64)
        k = int(lib.sk_bgzf_scan(
            native.ptr(arr, ctypes.c_uint8), arr.size,
            native.ptr(offs, ctypes.c_int64),
            native.ptr(csizes, ctypes.c_int64),
            native.ptr(usizes, ctypes.c_int64), max_blocks,
        ))
        if k < 0:
            return None
        return cls(path, offs[:k], csizes[:k], usizes[:k], arr)

    def _refill(self) -> bool:
        import ctypes

        lib = native.get_lib()
        lo = self._next_block
        hi = min(lo + self.WINDOW_BLOCKS, self._offs.size)
        if lo >= hi:
            return False
        base = int(self._uoffs[lo])
        total = int(self._uoffs[hi - 1] + self._usizes[hi - 1]) - base
        if self._out.size < total:
            self._out = np.empty(total, np.uint8)
        out = self._out
        uoffs = (self._uoffs[lo:hi] - base).copy()
        rc = int(lib.sk_bgzf_inflate(
            native.ptr(self._arr, ctypes.c_uint8),
            native.ptr(np.ascontiguousarray(self._offs[lo:hi]), ctypes.c_int64),
            native.ptr(np.ascontiguousarray(self._csizes[lo:hi]), ctypes.c_int64),
            native.ptr(uoffs, ctypes.c_int64),
            native.ptr(np.ascontiguousarray(self._usizes[lo:hi]), ctypes.c_int64),
            hi - lo, native.ptr(out, ctypes.c_uint8), native.N_THREADS,
        ))
        if rc:
            raise OSError(f"corrupt BGZF block {lo + rc - 1}")
        self._next_block = hi
        self._buf = out.data[:total]  # view over the refilled window
        self._buf_pos = 0
        return True

    def peek_window_bytes(self, max_blocks: Optional[int] = None) -> int:
        """Uncompressed size of the NEXT inflate window (0 at EOF), plus
        any undrained remainder of the current one."""
        rem = len(self._buf) - self._buf_pos
        lo = self._next_block
        hi = min(lo + (max_blocks or self.WINDOW_BLOCKS), self._offs.size)
        if lo >= hi:
            return rem
        return rem + int(self._uoffs[hi - 1] + self._usizes[hi - 1]
                         - self._uoffs[lo])

    def inflate_into(self, out: np.ndarray, offset: int,
                     max_blocks: Optional[int] = None) -> int:
        """Inflate the next window of blocks DIRECTLY into
        ``out[offset:]`` (parallel, one block per core) and return the
        byte count (0 at EOF).  This is the engine's zero-copy gzip
        producer path: decoded bytes land once in the pack source buffer
        — no bytes()/join round trips (compare the serial copy chain in
        ``read``).  Any undrained remainder of
        a previous ``read``/``seek`` window is copied out first (one
        bounded copy at a shard start).  Caller guarantees capacity
        (``peek_window_bytes``)."""
        import ctypes

        if self._buf_pos < len(self._buf):
            take = min(len(self._buf) - self._buf_pos, out.size - offset)
            out[offset : offset + take] = np.frombuffer(
                self._buf, np.uint8, count=take, offset=self._buf_pos)
            self._buf_pos += take
            return take
        lib = native.get_lib()
        lo = self._next_block
        hi = min(lo + (max_blocks or self.WINDOW_BLOCKS), self._offs.size)
        if lo >= hi:
            return 0
        base = int(self._uoffs[lo])
        # take as many whole blocks as fit the caller's capacity
        while hi > lo and (int(self._uoffs[hi - 1] + self._usizes[hi - 1])
                           - base) > out.size - offset:
            hi -= 1
        if hi == lo:
            raise ValueError("inflate_into: buffer too small for one block")
        total = int(self._uoffs[hi - 1] + self._usizes[hi - 1]) - base
        uoffs = (self._uoffs[lo:hi] - base + offset).copy()
        rc = int(lib.sk_bgzf_inflate(
            native.ptr(self._arr, ctypes.c_uint8),
            native.ptr(np.ascontiguousarray(self._offs[lo:hi]), ctypes.c_int64),
            native.ptr(np.ascontiguousarray(self._csizes[lo:hi]), ctypes.c_int64),
            native.ptr(uoffs, ctypes.c_int64),
            native.ptr(np.ascontiguousarray(self._usizes[lo:hi]), ctypes.c_int64),
            hi - lo, native.ptr(out, ctypes.c_uint8), native.N_THREADS,
        ))
        if rc:
            raise OSError(f"corrupt BGZF block {lo + rc - 1}")
        self._next_block = hi
        return total

    def read(self, n: int = -1) -> bytes:
        chunks = []
        want = None if n is None or n < 0 else n
        while want is None or want > 0:
            if self._buf_pos >= len(self._buf):
                if not self._refill():
                    break
            take = len(self._buf) - self._buf_pos
            if want is not None:
                take = min(take, want)
                want -= take
            chunks.append(bytes(self._buf[self._buf_pos : self._buf_pos + take]))
            self._buf_pos += take
        return b"".join(chunks)

    @property
    def usize(self) -> int:
        """Total UNCOMPRESSED size (sum of block isizes)."""
        if self._usizes.size == 0:
            return 0
        return int(self._uoffs[-1] + self._usizes[-1])

    def seek(self, pos: int, whence: int = 0) -> int:
        """Seek to an UNCOMPRESSED byte offset.

        The block index maps the offset to its containing block; the next
        refill starts there and the in-block remainder is skipped.  This
        is what makes BGZF inputs byte-splittable for --dist: a host's
        record-aligned (uoffset, ulength) shard costs one block-aligned
        decode, not an inflate of everything before it."""
        if whence != 0:
            raise io.UnsupportedOperation("BgzfReader.seek supports SEEK_SET only")
        self._buf = memoryview(b"")
        self._buf_pos = 0
        if pos <= 0 or self._usizes.size == 0:
            self._next_block = 0
            return max(pos, 0)
        blk = int(np.searchsorted(self._uoffs, pos, side="right")) - 1
        self._next_block = blk
        skip = pos - int(self._uoffs[blk])
        if skip and self._refill():
            # the refill window starts at blk, so the remainder is within it
            self._buf_pos = min(skip, len(self._buf))
        return pos

    def seekable(self) -> bool:
        return True

    def readable(self) -> bool:
        return True


class GzipChunkWriter(io.RawIOBase):
    """Streamed gzip writer using raw zlib for speed (level tuned for rate).

    Equivalent to gzwrite on a gzopen'd file; used for ``-g`` output.
    """

    def __init__(self, path: PathLike, level: int = 4):
        self._f = open(path, "wb", buffering=1 << 20)
        self._comp = zlib.compressobj(level, zlib.DEFLATED, -zlib.MAX_WBITS)
        self._crc = 0
        self._size = 0
        # gzip header: magic, deflate, no flags, mtime 0, XFL 0, OS unknown
        self._f.write(b"\x1f\x8b\x08\x00\x00\x00\x00\x00\x00\xff")

    def write(self, data) -> int:
        self._crc = zlib.crc32(data, self._crc)
        self._size += len(data)
        out = self._comp.compress(data)
        if out:
            self._f.write(out)
        return len(data)

    def writable(self) -> bool:
        return True

    def close(self) -> None:
        if self._f is None:
            return
        self._f.write(self._comp.flush())
        self._f.write(struct.pack("<II", self._crc & 0xFFFFFFFF, self._size & 0xFFFFFFFF))
        self._f.close()
        self._f = None
        super().close()


class BgzfWriter(io.RawIOBase):
    """Parallel BGZF compressor for ``-g`` output.

    Buffers assembled chunks and deflates them one 48 KiB block per core
    (io/_fastqio.cpp sk_bgzf_compress); the result is a standard .gz any
    consumer reads, plus block-parallel re-ingestion and bgzip/tabix
    compatibility.  Runs on the engine's writer thread, overlapping
    device dispatch and packing.
    """

    FLUSH_BYTES = 16 << 20

    def __init__(self, path: PathLike, level: int = 4, resumable: bool = False):
        """``resumable``: open read-write (create if missing) so a
        checkpointed run can truncate to a recorded size and append.
        Every ``flush()`` emits whole BGZF members, so any post-flush
        ``tell()`` is a valid truncation point — appending fresh members
        after it yields a standard multi-member gzip stream.  This is
        what makes ``-g`` output checkpoint/resume-safe (a byte offset
        inside a SERIAL gzip stream is never a member boundary)."""
        if resumable:
            try:
                self._f = open(path, "r+b", buffering=1 << 20)
            except FileNotFoundError:
                self._f = open(path, "w+b", buffering=1 << 20)
        else:
            self._f = open(path, "wb", buffering=1 << 20)
        self._level = level
        self._pending: list = []
        self._pending_bytes = 0

    def write(self, data) -> int:
        data = bytes(data) if not isinstance(data, (bytes, bytearray)) else data
        self._pending.append(data)
        self._pending_bytes += len(data)
        if self._pending_bytes >= self.FLUSH_BYTES:
            self._flush_blocks(final=False)
        return len(data)

    def flush(self) -> None:
        """Compress + write all buffered bytes as whole BGZF members."""
        if self._f is None:  # RawIOBase.close() flushes after our close
            return
        if self._pending_bytes:
            self._flush_blocks(final=False)
        self._f.flush()

    def tell(self) -> int:
        return self._f.tell()

    def seek(self, pos: int, whence: int = 0) -> int:
        return self._f.seek(pos, whence)

    def truncate(self, size=None) -> int:
        return self._f.truncate(size)

    def _flush_blocks(self, final: bool) -> None:
        import ctypes

        lib = native.get_lib()
        buf = b"".join(self._pending)
        self._pending = []
        self._pending_bytes = 0
        n = len(buf)
        arr = np.frombuffer(buf, np.uint8)
        stride = 48 * 1024 + 4096
        out = np.empty((n // (48 * 1024) + 1) * stride + 28, np.uint8)
        w = int(lib.sk_bgzf_compress(
            native.ptr(arr, ctypes.c_uint8) if n else
            native.ptr(out, ctypes.c_uint8),  # any valid pointer for n=0
            n, self._level, 1 if final else 0,
            native.ptr(out, ctypes.c_uint8), native.N_THREADS,
        ))
        if w < 0:
            raise OSError("BGZF compression failed")
        self._f.write(memoryview(out)[:w])

    def writable(self) -> bool:
        return True

    def close(self) -> None:
        if self._f is None:
            return
        self._flush_blocks(final=True)  # writes the BGZF EOF marker
        self._f.close()
        self._f = None
        super().close()


def open_output(path: PathLike, gzip_output: bool = False) -> BinaryIO:
    """Open an output stream; '-' or None means stdout (se ``-d`` teed copy
    is handled by the CLI layer)."""
    if path in (None, "-"):
        return sys.stdout.buffer
    if gzip_output:
        if native.available():
            return BgzfWriter(path)
        return GzipChunkWriter(path)
    if native.available() and not os.environ.get("SICKLE_TPU_NO_MMAP_OUT"):
        # zero-copy emission: the engine assembles records straight into
        # the output file's mapped pages (io.output.MmapWriter) — only
        # for regular files (mmap needs one; pipes/devices fall through)
        from .output import MmapWriter

        w = MmapWriter.open_regular(path, truncate=True)
        if w is not None:
            return w
    return open(path, "wb", buffering=1 << 20)
