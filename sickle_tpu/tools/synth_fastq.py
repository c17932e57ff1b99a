"""Seeded synthetic FASTQ generator: Illumina-like short reads.

Every test, benchmark and smoke run takes its input from here, so a run
needs nothing but the repository.  The model is deliberately simple but
shaped like a real run where the trimmer's behaviour depends on it:

* reads are ``read_len`` (150) bp; 90% are full length, a
  ``trimmed_frac`` of 10% are adapter-trimmed to a uniform length in
  ``[min_len, read_len - 1]``;
* quality decays along the read (~Q36 at the 5' end to ~Q25 at the 3'
  end) with a per-read shift and per-base noise; 15% of reads end in a
  low-quality tail and 3% start with a low-quality 5' stretch;
* ~0.1% of bases are ``N`` (quality 2, as instruments write them), and
  ``n_rich_frac`` (0.2%) of reads are N-rich (~20% N);
* ``binned`` maps qualities onto the four NovaSeq levels (Q 2/12/23/37);
* the quality characters use the sanger (+33) or illumina/solexa (+64)
  offset.

Generation is vectorized and block-wise: block ``k`` of mate ``m`` draws
from ``default_rng([seed, m, k])``, so a run is a pure function of its
arguments.

Usage:
    python -m sickle_tpu.tools.synth_fastq -n 1000000 --seed 1 -o r1.fastq \
        [-p r2.fastq] [-c pairs.fastq] [--binned] \
        [--qual-type sanger|illumina|solexa]
"""

from __future__ import annotations

import argparse
import sys
from typing import BinaryIO, Optional, Tuple

import numpy as np

BINNED_LEVELS = (2, 12, 23, 37)
QUAL_OFFSETS = {"sanger": 33, "illumina": 64, "solexa": 64}
BLOCK = 1 << 17

_BASES = np.frombuffer(b"ACGT", np.uint8)
_NAME_PREFIX = np.frombuffer(b"@syn.", np.uint8)
_NAME_DIGITS = 9


def _block(rng: np.random.Generator, n: int, read_len: int, min_len: int,
           trimmed_frac: float, n_rich_frac: float, binned: bool,
           offset: int):
    """One block of reads: (seq u8[n, read_len], qual u8[n, read_len]
    with zeros past each length, lengths i32[n])."""
    lengths = np.full(n, read_len, np.int32)
    short = rng.random(n) < trimmed_frac
    lengths[short] = rng.integers(min_len, max(read_len, min_len + 1),
                                  int(short.sum()), dtype=np.int32)

    pos = np.arange(read_len, dtype=np.float32) / max(read_len - 1, 1)
    curve = np.rint(36.0 - 11.0 * pos ** 1.5).astype(np.int16)
    q = (curve[None, :]
         + rng.integers(-3, 4, (n, 1), dtype=np.int16)
         + rng.integers(-4, 5, (n, read_len), dtype=np.int16))
    lane = np.arange(read_len, dtype=np.int32)[None, :]

    tail = rng.random(n) < 0.15
    t0 = (lengths * rng.uniform(0.6, 1.0, n)).astype(np.int32)
    low = rng.integers(2, 12, (n, read_len), dtype=np.int16)
    q = np.where(tail[:, None] & (lane >= t0[:, None]), low, q)
    head = rng.random(n) < 0.03
    h1 = rng.integers(3, 16, n, dtype=np.int32)
    q = np.where(head[:, None] & (lane < h1[:, None]), low, q)
    np.clip(q, 2, 41, out=q)

    seq = _BASES[rng.integers(0, 4, (n, read_len), dtype=np.uint8)]
    is_n = rng.random((n, read_len), dtype=np.float32) < 0.001
    rich = rng.random(n) < n_rich_frac
    is_n |= rich[:, None] & (rng.random((n, read_len), dtype=np.float32) < 0.2)
    seq[is_n] = ord("N")
    q[is_n] = 2

    if binned:
        q = np.select([q < 7, q < 18, q < 30], list(BINNED_LEVELS[:3]),
                      BINNED_LEVELS[3]).astype(np.int16)
    qual = (q + offset).astype(np.uint8)
    past = lane >= lengths[:, None]
    qual[past] = 0
    seq[past] = 0
    return seq, qual, lengths


def _blocks(n: int, seed: int, mate: int, read_len: int = 150,
            min_len: int = 30, trimmed_frac: float = 0.10,
            n_rich_frac: float = 0.002, binned: bool = False,
            qual_type: str = "sanger"):
    """Yield ``(first, seq, qual, lengths)`` blocks of at most BLOCK reads;
    block ``k`` draws from ``default_rng([seed, mate, k])``."""
    offset = QUAL_OFFSETS[qual_type]
    for k, first in enumerate(range(0, n, BLOCK)):
        rng = np.random.default_rng([seed, mate, k])
        yield (first,) + _block(rng, min(BLOCK, n - first), read_len,
                                min_len, trimmed_frac, n_rich_frac, binned,
                                offset)


def synth_reads(n: int, *, seed: int, mate: int = 1, **kw
                ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """``n`` reads as row matrices: ``(seq, qual, lengths)`` with
    ``uint8[n, read_len]`` bases and raw quality characters, zero past
    each read's length, and ``int32[n]`` lengths.  Keywords as
    :func:`_blocks`."""
    parts = [b[1:] for b in _blocks(n, seed, mate, **kw)]
    if not parts:
        L = kw.get("read_len", 150)
        return (np.zeros((0, L), np.uint8), np.zeros((0, L), np.uint8),
                np.zeros(0, np.int32))
    return tuple(np.concatenate(x) for x in zip(*parts))


def format_records(seq: np.ndarray, qual: np.ndarray, lengths: np.ndarray,
                   first: int = 0, mate: int = 1) -> bytes:
    """FASTQ bytes for row matrices: ``@syn.<index> <mate>:N:0:1``
    names, a bare ``+`` comment line."""
    n, L = seq.shape
    idx = np.arange(first, first + n, dtype=np.int64)[:, None]
    digits = (idx // 10 ** np.arange(_NAME_DIGITS - 1, -1, -1)) % 10 + 48
    suffix = np.frombuffer(b" %d:N:0:1\n" % mate, np.uint8)
    parts = [
        np.broadcast_to(_NAME_PREFIX, (n, _NAME_PREFIX.size)),
        digits.astype(np.uint8),
        np.broadcast_to(suffix, (n, suffix.size)),
        seq,
        np.broadcast_to(np.frombuffer(b"\n+\n", np.uint8), (n, 3)),
        qual,
        np.full((n, 1), 0x0A, np.uint8),
    ]
    rows = np.concatenate(parts, axis=1)
    keep = np.ones(rows.shape, bool)
    lane = np.arange(L)[None, :] >= lengths[:, None]
    s0 = _NAME_PREFIX.size + _NAME_DIGITS + suffix.size
    keep[:, s0:s0 + L] = ~lane
    keep[:, s0 + L + 3:s0 + 2 * L + 3] = ~lane
    return rows[keep].tobytes()


def write_fastq(out: BinaryIO, n: int, *, seed: int, mate: int = 1,
                **kw) -> int:
    """Write ``n`` reads of one mate to ``out``; returns bytes written."""
    total = 0
    for first, s, q, ln in _blocks(n, seed, mate, **kw):
        blob = format_records(s, q, ln, first=first, mate=mate)
        out.write(blob)
        total += len(blob)
    return total


def write_interleaved(out: BinaryIO, n: int, *, seed: int, **kw) -> int:
    """Write ``n`` pairs to ``out`` as one interleaved file (mate 1, then
    mate 2, per pair): the same reads as the two mate files."""
    total = 0
    for b1, b2 in zip(_blocks(n, seed, 1, **kw), _blocks(n, seed, 2, **kw)):
        l1, l2 = (format_records(*b[1:], first=b[0], mate=m).split(b"\n")
                  for m, b in ((1, b1), (2, b2)))
        blob = b"".join(b"\n".join(l1[i:i + 4] + l2[i:i + 4]) + b"\n"
                        for i in range(0, len(l1) - 1, 4))
        out.write(blob)
        total += len(blob)
    return total


def synth_fastq_bytes(n: int, *, seed: int, mate: int = 1, **kw) -> bytes:
    """``n`` reads of one mate as FASTQ bytes (small runs and tests)."""
    import io

    buf = io.BytesIO()
    write_fastq(buf, n, seed=seed, mate=mate, **kw)
    return buf.getvalue()


def main(argv: Optional[list] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("-n", "--reads", type=int, required=True,
                    help="reads (pairs with -p)")
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("-o", "--out", help="mate-1 / se output")
    ap.add_argument("-p", "--out2", help="mate-2 output (paired run)")
    ap.add_argument("-c", "--interleaved",
                    help="write both mates of -n pairs to this one file")
    ap.add_argument("--binned", action="store_true",
                    help="NovaSeq 4-level qualities (Q 2/12/23/37)")
    ap.add_argument("--qual-type", default="sanger", choices=QUAL_OFFSETS)
    ap.add_argument("--read-len", type=int, default=150)
    a = ap.parse_args(argv)
    kw = dict(binned=a.binned, qual_type=a.qual_type, read_len=a.read_len)
    if a.interleaved:
        with open(a.interleaved, "wb") as f:
            write_interleaved(f, a.reads, seed=a.seed, **kw)
    for mate, path in ((1, a.out), (2, a.out2)):
        if path is None:
            continue
        with open(path, "wb") as f:
            write_fastq(f, a.reads, seed=a.seed, mate=mate, **kw)
    return 0


if __name__ == "__main__":
    sys.exit(main())
