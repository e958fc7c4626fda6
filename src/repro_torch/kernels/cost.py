"""The work a kernel launch does, recorded by the wrappers' meta branches.

On the meta device (the dry run, ``launch/dryrun.py``) a kernel wrapper
runs neither its kernel nor its plain version: it returns outputs of the
right shapes and records here what the launch would do, by the formulas
of ``PERF.md`` section 6's bound column (``chip_smoke.py``'s): the bytes
each input read once and each output written once, and the operations of
the products it does.  Where the
work depends on the data (the pack's rows that land in a slot), a meta
tensor has none, and the record takes every slot filled.  A meta launch
adds nothing to the wrappers' ``launches`` counters, which count real
launches only: the dry run counts its launches from these records.
"""

from __future__ import annotations

import contextlib

_RECORDS: list | None = None


@contextlib.contextmanager
def recording():
    """Collect ``(kernel, flops, bytes)`` of every meta launch inside."""
    global _RECORDS
    outer, _RECORDS = _RECORDS, []
    try:
        yield _RECORDS
    finally:
        _RECORDS = outer


def record(kernel: str, flops: float, nbytes: float) -> None:
    if _RECORDS is not None:
        _RECORDS.append((kernel, float(flops), float(nbytes)))


def attended_pairs(sq: int, t: int, causal: bool, window) -> int:
    """(q, k) pairs a mask lets attend: q row i of ``sq`` (the last ``sq``
    of ``t`` positions) sees keys up to ``t - sq + i``, the last ``window``
    of them."""
    if not causal:
        return sq * t
    first = t - sq + 1                   # keys the first row sees
    if window is None:
        return sq * first + sq * (sq - 1) // 2
    below = max(0, min(sq, window - first + 1))
    return below * first + below * (below - 1) // 2 + (sq - below) * window
