"""Batched sliding-window trimming — the device formulation.

This is the vectorized re-derivation of the reference's scalar, branchy
per-read loop (src/trim.cpp:3-116 of the reference, spec in SURVEY.md §2.3)
as masked data-parallel array ops over a padded batch ``[B, L]``:

* rolling window sums     -> cumulative-sum difference ``W[i] = C[i+w]-C[i]``
* sequential 5'/3' triggers -> masked first-index reductions with an
  ``i3 >= i5`` ordering constraint (exact: the 5' trigger window satisfies
  ``W >= t*w`` so the 3' trigger is strictly after it)
* within-window scans     -> masked first-index over positions ``>= trigger``
  (exact: an integer window sum ``>= t*w`` / ``< t*w`` guarantees a
  qualifying element inside that window, so the unbounded scan finds the
  same index the reference's window-bounded scan does)
* the double `window_avg >= q` comparison -> integer ``sum >= q*w``
  (exact: both sides integers, w > 0)
* `int(0.1*len)` window size -> ``len // 10`` (exact for all len < 1e16:
  IEEE double 0.1*L never crosses the next integer)

Everything is integer arithmetic; no data-dependent shapes, no scans — a
handful of elementwise passes + one cumsum + first-index reductions, which
XLA fuses into a few kernels.
"""

from __future__ import annotations

import dataclasses
import functools
import os
from typing import Optional

import jax
import jax.numpy as jnp

from ..constants import Compat, QUALITY_CONSTANTS, QualityType

BIG = 0x3FFFFFFF  # "no index" sentinel of the first-index reductions


@dataclasses.dataclass(frozen=True)
class TrimParams:
    """Static trimming configuration (hashable -> jit-static).

    Mirrors the reference CLI options (src/trim_single.cpp:90):
    -t/-q/-l/-x/-n plus the fork-vs-1.33 compat switch.
    """

    qualtype: QualityType = QualityType.SANGER
    qual_threshold: int = 20
    length_threshold: int = 20
    no_fiveprime: bool = False
    trunc_n: bool = False
    compat: Compat = Compat.V133
    # --strict: error on ANY out-of-range quality char.  Default matches
    # the reference exactly: only chars its scan touches error (it breaks
    # at the 3' cut, src/trim.cpp:66-73), decided host-side per flagged
    # row by a lazy scalar re-scan (engine._recheck_quality_row).
    strict: bool = False


def _first_index(mask: jnp.ndarray, axis: int = -1) -> jnp.ndarray:
    """Smallest index where mask is True, else BIG."""
    n = mask.shape[axis]
    iota = jax.lax.broadcasted_iota(jnp.int32, mask.shape, mask.ndim + axis if axis < 0 else axis)
    return jnp.min(jnp.where(mask, iota, BIG), axis=axis)


def decode_check(qual: jnp.ndarray, lengths: jnp.ndarray, qualtype: QualityType):
    """Decode raw ASCII qualities and locate range violations.

    Returns ``(q, first_bad)`` where ``q`` is ``int32[B, L]`` decoded
    quality (junk beyond ``lengths``) and ``first_bad`` is ``int32[B]``:
    the first 0-based position whose char is outside the encoding's
    [min, max] (reference src/trim.cpp:121-134), or BIG if none.

    The device check covers the WHOLE read — a conservative flag.  The
    host decides per flagged row whether the reference's scan would have
    touched the bad char (it breaks at the 3' cut, so junk past the scan
    extent trims fine in sickle 1.33) unless ``params.strict``; either
    way the exact error message is re-derived scalar host-side.  A bad
    char past the scan extent cannot change the cuts: every window the
    trigger reductions can select ends before the first untouched
    position, so the device's cuts for benign-flagged rows are valid.
    """
    offset, qmin, qmax = QUALITY_CONSTANTS[qualtype]
    raw = qual.astype(jnp.int32)
    lane = jax.lax.broadcasted_iota(jnp.int32, qual.shape, 1)
    in_read = lane < lengths[:, None]
    bad = in_read & ((raw < qmin) | (raw > qmax))
    return raw - offset, _first_index(bad)


def decode_fields(buf: jnp.ndarray, p: int, L: int) -> jnp.ndarray:
    """Inverse of io.fastq.qual_fields / qual_rank_fields, on device.

    ``buf`` is ``uint8[B, p*L//8]``: the biased value's binary
    decomposition into byte-aligned 4/2/1-bit subfields (layout contract
    in io.fastq.field_widths).  Returns ``v`` as ``uint8[B, L]``; padding
    packs to all-zero fields so ``v == 0`` marks padding exactly.

    Returns small unsigned ints in an implementation-chosen dtype
    (uint8 or int16) — callers widen/compare, never assume the dtype.

    One lane expansion (``jnp.repeat``) + shift + mask per FIELD (at
    most 3) instead of per BIT (up to 6 with bit-planes).  A bf16
    replication-matmul form of the expansion is exact too, but on the
    H100 it was no faster for the whole decode+cuts step (PERF.md,
    "Kernel decisions on the H100"), so this is the only form.
    """
    v = None
    for w, sh, colf in _field_widths(p):
        col = int(colf * L)
        per = 8 // w
        sub = buf[:, col:col + L * w // 8]
        rep = jnp.repeat(sub, per, axis=1)  # uint8 [B, L]
        lane = (jax.lax.broadcasted_iota(jnp.int32, rep.shape, 1) % per
                ).astype(jnp.uint8) * jnp.uint8(w)
        f = (rep >> lane) & jnp.uint8((1 << w) - 1)
        part = f << jnp.uint8(sh) if sh else f
        v = part if v is None else v | part
    return v


def _field_widths(p: int):
    # the single source of truth for the wire layout lives next to the
    # host packer; importing here is cycle-safe (io.fastq never imports
    # ops) and keeps decoder and packer from desynchronizing
    from ..io.fastq import field_widths

    return field_widths(p)


def apply_rank_lut(v: jnp.ndarray, lut: jnp.ndarray) -> jnp.ndarray:
    """Decode rank-wire values: ``q = lut[v]`` for v in [1, len(lut)),
    0 for padding (io.fastq.qual_rank_fields is the host-side inverse).
    The LUT is tiny and static-size (<= 8), so this expands to a fused
    select chain instead of a gather."""
    q = jnp.zeros_like(v)
    for k in range(1, lut.shape[0]):
        q = jnp.where(v == k, lut[k], q)
    return q


def compute_cuts(
    seq: jnp.ndarray,  # uint8[B, L] sequence bytes (only read when trunc_n)
    qual: jnp.ndarray,  # uint8[B, L] raw ASCII quality bytes
    lengths: jnp.ndarray,  # int32[B]; 0 marks padding rows
    params: TrimParams,
    formulation: str = "gather",
    uniform_len: Optional[int] = None,
):
    """Compute per-read cutsites.

    Returns ``(five, three, first_bad)`` int32[B] arrays; ``(-1, -1)``
    means discard (reference cutsites contract, src/sickle.h:93-96).
    Padding rows (length 0) are always discarded.

    ``formulation`` picks how the per-row dynamic shift ``D[i+w]`` is
    resolved: ``"gather"`` (one take_along_axis; the default, fastest on
    the H100 at 150 bp and 50 kbp) or ``"shift"`` (O(log L) static
    shifts, kept as an exact alternative).
    """
    lens = lengths.astype(jnp.int32)
    q, first_bad = decode_check(qual, lens, params.qualtype)
    five, three = compute_cuts_from_q(q, lens, params, seq, formulation,
                                      uniform_len)
    return five, three, first_bad


def compute_cuts_from_q(
    q: jnp.ndarray,  # int32[B, L] decoded qualities (junk beyond lengths)
    lengths: jnp.ndarray,  # int32[B]; 0 marks padding rows
    params: TrimParams,
    seq: Optional[jnp.ndarray] = None,  # only read when trunc_n
    formulation: str = "gather",
    uniform_len: Optional[int] = None,
):
    """Core cut computation on already-decoded qualities.

    Entry point for wire formats that decode on device (the field wire
    via ``decode_fields``, where ``q = v + bias`` is computed by the caller
    and range errors are excluded host-side).

    The sequential trigger structure is resolved with masked first-index
    reductions (XLA fuses them well).  ``uniform_len`` (static): every
    non-padding row has that
    length — the common Illumina case — so the window size is a
    compile-time constant and the per-row shift chain collapses to ONE
    static shift.
    """
    B, L = q.shape
    t = jnp.int32(params.qual_threshold)
    lthr = jnp.int32(params.length_threshold)
    lens = lengths.astype(jnp.int32)

    lane = jax.lax.broadcasted_iota(jnp.int32, (B, L), 1)
    in_read = lane < lens[:, None]

    # Narrow accumulator: the whole D-transform chain fits int16 when
    # every IN-RANGE decoded q keeps |C| and t*L under the i16 ceiling —
    # 4-8% faster than i32 per 65,536 x 152 batch on the H100 (PERF.md,
    # "Kernel decisions on the H100"); SICKLE_TPU_NO_I16 forces i32 for
    # that comparison.  Exactness: for rows whose touched extent holds
    # only in-range chars the sums are within bounds by the gate below;
    # an OUT-OF-RANGE char can only wrap prefix values at lanes AFTER
    # its position, and such
    # a row either (a) was touched => flagged => host re-derives scalar
    # cuts, or (b) untouched => every trigger/scan index the reductions
    # select lies before the wrap point (first-index minima cannot be
    # created by corrupt larger-index lanes), so its cuts are exact.
    offset_, _, qmax_ = QUALITY_CONSTANTS[params.qualtype]
    qcap = qmax_ - offset_
    use16 = (L <= 255 and params.qual_threshold * L < 30000
             and qcap * L < 30000 and params.qual_threshold >= 0
             and not os.environ.get("SICKLE_TPU_NO_I16"))
    acc = jnp.int16 if use16 else jnp.int32

    # Rolling sums via prefix-sum difference, expressed through the
    # transform D[j] = C[j] - t*j so that ``W[i] >= t*w <=> D[i+w] >= D[i]``
    # (C = exclusive prefix).
    qv = jnp.where(in_read, q, 0).astype(acc)
    csum = jnp.cumsum(qv, axis=1, dtype=acc)
    c_excl = csum - qv  # C[j] = sum q[0..j-1], j in [0, L)
    d = c_excl - t.astype(acc) * lane.astype(acc)  # D[j]
    d_last = (csum[:, L - 1] - jnp.array(L, acc) * t.astype(acc))[:, None]

    if uniform_len is not None:
        # static window size: int(0.1*len) == len // 10 (trim.cpp:8,30)
        ws = uniform_len // 10
        if ws == 0:
            ws = uniform_len
        w = jnp.where(lens > 0, ws, 0)
        d_last_row = jnp.broadcast_to(d_last, (B, L))
        dw = (jnp.concatenate([d[:, ws:], d_last_row[:, :ws]], axis=1)
              if ws < L else d_last_row)
    else:
        # window size: int(0.1*len) == len // 10; if 0, whole read
        w = lens // 10
        w = jnp.where(w == 0, lens, w)
        if formulation == "shift":
            # Binary decomposition of the per-row shift: compose
            # conditional STATIC shifts by powers of two, padding with
            # D[L], so dw[i] = D[min(i + w, L)] in O(log wmax) fused
            # elementwise passes — no gather, and no O(L/10) unrolled
            # select chain (compile explosion on long reads).  Exact:
            # each applied step adds 2^k to the accumulated shift and the
            # D[L] fill propagates through later steps unchanged.
            d_last_row = jnp.broadcast_to(d_last, (B, L))
            wmax = max(9, L // 10)
            w2d = w[:, None]
            dw = d
            for k in range(wmax.bit_length()):
                s = 1 << k
                shifted = (
                    jnp.concatenate([dw[:, s:], d_last_row[:, :s]], axis=1)
                    if s < L
                    else d_last_row
                )
                dw = jnp.where((w2d >> k) & 1 == 1, shifted, dw)
        else:
            # one gather of D[i+w]: compiles and runs faster than the
            # shift chain
            d_full = jnp.concatenate([d, d_last], axis=1)  # D[0..L]
            iw = jnp.minimum(lane + w[:, None], L)
            dw = jnp.take_along_axis(d_full, iw, axis=1)

    ii = lane  # window start i; D[i+w] vs D[i] defined for i <= len - w
    i_valid = ii <= (lens - w)[:, None]
    hi = i_valid & (dw >= d)
    lo = i_valid & (dw < d)

    i5 = _first_index(hi)
    found_five = (i5 < BIG) & (lens > 0)
    start3 = jnp.zeros_like(i5) if params.no_fiveprime else i5
    i3 = _first_index(lo & (ii >= start3[:, None]))
    three_trig = i3 < BIG
    five_mask = in_read & (q >= t) & (lane >= i5[:, None])
    three_mask = in_read & (q < t) & (lane >= i3[:, None])

    # 5' cut: first position >= i5 with q >= t (guaranteed inside the window)
    if params.no_fiveprime:
        five = jnp.zeros_like(lens)
    else:
        five = _first_index(five_mask)
        five = jnp.where(found_five, jnp.minimum(five, lens), 0)

    # 3' cut: first position >= i3 with q < t; stays len if never triggered
    three_hit = _first_index(three_mask)
    three = jnp.where(three_trig, jnp.minimum(three_hit, lens), lens)

    # -n: truncate to the base BEFORE the first N (upstream semantics;
    # the fork's npos bug is NOT reproduced — SURVEY.md §2.4.4)
    if params.trunc_n:
        up = _first_index(in_read & (seq == ord("N")))
        low = _first_index(in_read & (seq == ord("n")))
        if params.compat == Compat.V133:
            nidx = jnp.where(up < BIG, up, low)  # 'N' first, else 'n'
        else:
            nidx = jnp.where(low < BIG, low, up)  # fork order: 'n' first
        three = jnp.where(nidx < BIG, nidx - 1, three)

    keep = (lens >= lthr) & (three - five >= lthr)
    if not params.no_fiveprime:
        keep &= found_five
    keep &= lens > 0

    five = jnp.where(keep, five, -1)
    three = jnp.where(keep, three, -1)
    return five, three


@functools.partial(jax.jit,
                   static_argnames=("params", "formulation", "uniform_len"))
def compute_cuts_jit(seq, qual, lengths, params: TrimParams,
                     formulation: str = "gather",
                     uniform_len: Optional[int] = None):
    return compute_cuts(seq, qual, lengths, params, formulation, uniform_len)
