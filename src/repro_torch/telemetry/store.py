"""Append-only calibration store: measured collective timings as JSONL.

The store is the persistence layer of the telemetry loop (probe ->
STORE -> fit -> monitor): every probe run appends one record per
(plan, payload) measurement, and the fitter reads the records back —
possibly in a different process, days later — keyed by

    (fabric fingerprint, op, payload bucket)

so measurements from one fabric never calibrate another (the planner
keys its own cache on the same ``Topology.fingerprint()``).

Records are schema-versioned plain dicts (see
:data:`SCHEMA_VERSION`); unknown *newer* schemas are skipped on read
(forward compatibility for rolling deployments), older ones pass
through an upgrade hook.  Files live under ``results/calibration_torch/`` by
default; ``path=":memory:"`` gives a process-local store for tests and
self-contained benchmarks.
"""

from __future__ import annotations

import hashlib
import itertools
import json
import os
from typing import Iterable, Optional

SCHEMA_VERSION = 1

_STORE_UIDS = itertools.count()

# required fields of a v1 record (probe.py emits these)
RECORD_FIELDS = ("fabric", "op", "plan", "payload_bytes", "bucket",
                 "predicted_s", "measured_s")

DEFAULT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                           "results", "calibration_torch")


def topo_key(topo) -> str:
    """Stable string identity of a fabric for record keying: the name
    plus a short hash of the full fingerprint (name alone would alias
    re-bandwidthed variants)."""
    fp = repr(topo.fingerprint()).encode()
    return f"{topo.name}:{hashlib.sha1(fp).hexdigest()[:12]}"


def _upgrade(rec: dict) -> Optional[dict]:
    """Schema migration hook.  Returns None for records this build cannot
    read (newer schema than SCHEMA_VERSION)."""
    v = int(rec.get("schema", 1))
    if v > SCHEMA_VERSION:
        return None
    # v1 is the only historical schema so far; future bumps migrate here.
    return rec


class CalibrationStore:
    """Append-only JSONL store of probe measurements.

    ``path`` may be a file path (created on first append, parents
    included), a directory (a ``calibration.jsonl`` inside it), or
    ``":memory:"`` for a non-persistent store.
    """

    def __init__(self, path: Optional[str] = None) -> None:
        if path is None:
            path = os.path.join(DEFAULT_DIR, "calibration.jsonl")
        if path != ":memory:" and (os.path.isdir(path)
                                   or path.endswith(os.sep)):
            path = os.path.join(path, "calibration.jsonl")
        self.path = path
        self._uid = next(_STORE_UIDS)
        self._records: list[dict] = []
        self._load()

    # -- persistence ---------------------------------------------------------
    @property
    def in_memory(self) -> bool:
        return self.path == ":memory:"

    def _load(self) -> None:
        if self.in_memory or not os.path.exists(self.path):
            return
        with open(self.path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = _upgrade(json.loads(line))
                except json.JSONDecodeError:
                    continue          # torn tail write: skip, keep reading
                if rec is not None:
                    self._records.append(rec)

    def append(self, record: dict) -> dict:
        missing = [k for k in RECORD_FIELDS if k not in record]
        if missing:
            raise ValueError(f"calibration record missing {missing}")
        rec = dict(record)
        rec.setdefault("schema", SCHEMA_VERSION)
        self._records.append(rec)
        if not self.in_memory:
            os.makedirs(os.path.dirname(os.path.abspath(self.path)),
                        exist_ok=True)
            with open(self.path, "a") as f:
                f.write(json.dumps(rec, sort_keys=True) + "\n")
        return rec

    def extend(self, records: Iterable[dict]) -> int:
        n = 0
        for r in records:
            self.append(r)
            n += 1
        return n

    # -- queries -------------------------------------------------------------
    def records(self, *, fabric: Optional[str] = None,
                op: Optional[str] = None, plan: Optional[str] = None,
                bucket: Optional[int] = None,
                source: Optional[str] = None) -> list[dict]:
        """Records in append order, filtered by any of the key fields."""
        out = []
        for r in self._records:
            if fabric is not None and r.get("fabric") != fabric:
                continue
            if op is not None and r.get("op") != op:
                continue
            if plan is not None and r.get("plan") != plan:
                continue
            if bucket is not None and r.get("bucket") != bucket:
                continue
            if source is not None and r.get("source") != source:
                continue
            out.append(r)
        return out

    def latest_by_key(self, **filters) -> dict[tuple, dict]:
        """Most recent record per (op, plan, bucket) — the fitter's view:
        a re-probed payload bucket supersedes its older measurements, so
        a degradation does not average against the healthy history.
        Directed "linkprobe" records additionally key on their direction
        (bottleneck role): the two directions of an ordered server pair
        are distinct measurements, not re-probes of each other."""
        out: dict[tuple, dict] = {}
        for r in self.records(**filters):
            key = (r["op"], r["plan"], r["bucket"])
            if r["op"] == "linkprobe":
                key += (r.get("bottleneck_role"),)
            out[key] = r
        return out

    def fabrics(self) -> list[str]:
        return sorted({r.get("fabric", "?") for r in self._records})

    def version(self) -> tuple:
        """Memoization token: unique per store INSTANCE (two ':memory:'
        stores never alias) and bumped by every append."""
        return (self._uid, len(self._records))

    def __len__(self) -> int:
        return len(self._records)

    def __repr__(self) -> str:
        return (f"CalibrationStore({self.path!r}, {len(self)} records, "
                f"schema<={SCHEMA_VERSION})")


def resolve_store(spec) -> CalibrationStore:
    """A CalibrationStore from a store, path string, or None (default
    location) — the ``--calibration`` / ``ParallelContext.calibration``
    resolution point."""
    if isinstance(spec, CalibrationStore):
        return spec
    return CalibrationStore(spec)
