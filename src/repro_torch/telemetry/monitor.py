"""Drift watchdog: predicted-vs-measured divergence drives re-fits.

The MONITOR closes the telemetry loop at runtime:

    probe (timed plans)  ->  store (JSONL)  ->  drift check
                                                    │ > threshold
                                                    ▼
    planner.refresh_hardware(hw')  <-  HardwareModel.recalibrated
         (LRU cache invalidated,          ▲
          decisions genuinely flip)       └─ fit (per-class alpha/beta)

Drift is the per-op MEDIAN relative error between the latency model's
predicted ledger times and the measured times, maximized over ops — a
degraded rail shows up even while the (unaffected) intra-server
AllGather keeps predicting perfectly.  When the worst op's divergence
exceeds ``threshold``, the monitor re-fits the store's latest records,
folds the fitted bandwidths into a fresh :class:`HardwareModel`, and
swaps it into the planner — whose cache invalidation makes the next
``choose`` re-sweep, so dispatch/combine decisions flip WITHOUT process
restart (the closed-loop acceptance property of tests/test_telemetry.py).
"""

from __future__ import annotations

import time
from collections import deque
from typing import Optional, Sequence

from repro_torch.core.latency_model import HardwareModel
from repro_torch.core.planner import Planner
from repro_torch.core.topology import Topology

from . import slo as _slo
from .fit import fit_measurements, fit_overlap_eff
from .metrics import default_registry
from .probe import DEFAULT_OPS, probe_link_directions, probe_sweep
from .store import CalibrationStore, topo_key


class DriftMonitor:
    """Watches predicted-vs-measured error; re-fits + recalibrates the
    planner when it diverges.

    ``threshold`` is the relative-error trip point (0.25 = re-fit once
    the worst op's median divergence passes 25%); ``window`` bounds the
    per-op observation deques; ``cooldown`` is the minimum number of
    ``check`` calls between recalibrations (a re-fit needs fresh probes
    to judge itself against before it may fire again).
    """

    def __init__(self, planner: Planner, store: CalibrationStore,
                 topo: Topology, *, threshold: float = 0.25,
                 window: int = 32, min_observations: int = 3,
                 cooldown: int = 1,
                 base_hw: Optional[HardwareModel] = None,
                 detector=None) -> None:
        self.planner = planner
        self.store = store
        # base_topo stays the healthy fabric; topo is the EFFECTIVE one
        # (base with the detector's declared failures applied)
        self.base_topo = topo
        self.topo = topo
        self.threshold = float(threshold)
        self.window = int(window)
        self.min_observations = int(min_observations)
        self.cooldown = int(cooldown)
        # fits always start from the pristine base so repeated
        # recalibrations replace (never compound) earlier overrides
        self.base_hw = base_hw or planner.hw
        self.detector = detector    # Optional[failover.FailureDetector]
        self._errs: dict[str, deque] = {}
        self.events: list[dict] = []
        self.checks = 0
        self._last_recal_check = -10 ** 9

    # -- observations --------------------------------------------------------
    def observe(self, record: dict) -> None:
        """Feed one probe record's (predicted, measured) pair."""
        reg = default_registry()
        reg["repro_probe_observations_total"].inc(
            op=str(record.get("op", "?")), fabric=self.topo.name)
        _slo.observe_record(record, registry=reg)
        p = float(record["predicted_s"])
        m = float(record["measured_s"])
        if p <= 0:
            return
        dq = self._errs.setdefault(
            record.get("op", "?"), deque(maxlen=self.window))
        dq.append(abs(m - p) / p)
        # close the planner's audit trail: if this probe timed the plan
        # of a logged (still-unmeasured) decision at the same payload
        # bucket AND the same knob configuration, fill its measured
        # side.  The knob match matters for pipelined rows: a default
        # G=1 probe timing must never land in a G>1 decision row —
        # fit_overlap_eff would misread the collective-only time as a
        # pipelined end-to-end time and inflate overlap_eff toward 1.
        rk = record.get("knobs")
        rt = record.get("fabric_name")
        for row in reversed(self.planner.decision_log):
            if (row["op"] == record.get("op")
                    and row["plan"] == record.get("plan")
                    and row["payload_bytes"] == record.get("bucket")
                    and (rk is None or dict(row.get("knobs", {})) == dict(rk))
                    and (rt is None or row.get("topo") in (None, rt))
                    and row["measured_s"] is None):
                row["measured_s"] = m
                break

    @staticmethod
    def _median(vals: Sequence[float]) -> float:
        s = sorted(vals)
        n = len(s)
        return s[n // 2] if n % 2 else 0.5 * (s[n // 2 - 1] + s[n // 2])

    def drift(self) -> float:
        """Worst-op median relative error over the observation window."""
        per_op = [self._median(dq) for dq in self._errs.values() if dq]
        return max(per_op, default=0.0)

    def drift_by_op(self) -> dict:
        return {op: self._median(dq)
                for op, dq in self._errs.items() if dq}

    def _n_observations(self) -> int:
        return sum(len(dq) for dq in self._errs.values())

    # -- the loop ------------------------------------------------------------
    def recalibrate(self, *, force: bool = False) -> Optional[dict]:
        """Fit the store's latest records for this fabric, swap the
        fitted model into the planner, and REPLAN every registered
        collective program under it — re-calibration operates on whole
        programs (the unit consumers bind), not just per-op cache
        entries: the event carries each program's fresh fingerprint and
        whether any jointly-planned decision moved.  Returns the event
        dict, or None when no class fit cleared the confidence floor."""
        t_start = time.perf_counter()
        reg = default_registry()
        records = list(
            self.store.latest_by_key(fabric=topo_key(self.topo)).values())
        measurements, fits = fit_measurements(records, self.topo)
        rejected = sum(1 for f in fits.values() if not f.trusted)
        if rejected:
            reg["repro_fit_rejected_total"].inc(rejected,
                                                fabric=self.topo.name)
        # overlap-efficiency hook: measured pipelined decisions in the
        # planner's log calibrate hw.overlap_eff alongside the link fits
        eta = fit_overlap_eff(self.planner.decision_log)
        if eta is not None:
            measurements = dict(measurements)
            measurements["overlap_eff"] = eta
        if not measurements and not force:
            return None
        new_hw = (self.base_hw.recalibrated(measurements, self.topo)
                  if measurements else self.base_hw)
        drift = self.drift()
        self.planner.refresh_hardware(new_hw)
        program_events = self.planner.replan_programs()
        event = {
            "kind": "recalibrated",
            "time": time.time(),
            "check": self.checks,
            "drift": drift,
            "drift_by_op": self.drift_by_op(),
            "fabric": topo_key(self.topo),
            "n_records": len(records),
            "fits": {cls: f.report() for cls, f in fits.items()},
            "measured_links": len(measurements.get("links", {})),
            "overlap_eff": measurements.get("overlap_eff"),
            "programs": [{"program": e["program"],
                          "fingerprint": e["fingerprint"],
                          "changed": e["changed"]}
                         for e in program_events],
        }
        self.events.append(event)
        self._last_recal_check = self.checks
        for dq in self._errs.values():
            dq.clear()            # judged against the new model from here
        reg["repro_recalibrations_total"].inc(fabric=self.topo.name)
        reg["repro_recalibration_seconds"].observe(
            time.perf_counter() - t_start, fabric=self.topo.name)
        return event

    def apply_failures(self, failures) -> Optional[dict]:
        """Recompute the effective topology from the healthy base plus
        ``failures`` (a :class:`~repro_torch.core.topology.FailureState`) and
        RETARGET every registered program onto it — the reaction half of
        the fault-tolerance arc.  Returns a ``failover``/``failback``
        event (with per-program replan results, including a typed
        ``NoFeasiblePlanError`` for unplannable programs), or None when
        the effective fabric is unchanged."""
        new_topo = self.base_topo.with_failures(failures)
        if new_topo.fingerprint() == self.topo.fingerprint():
            return None
        old_topo = self.topo
        self.topo = new_topo
        retargets = self.planner.retarget_programs(old_topo, new_topo)
        event = {
            "kind": "failover" if failures else "failback",
            "time": time.time(),
            "check": self.checks,
            "fabric": topo_key(new_topo),
            "dead_links": sorted(failures.dead_links),
            "dead_relays": sorted(failures.dead_relays),
            "lost_npus": sorted(failures.lost_npus),
            "programs": [{"program": e["program"],
                          "fingerprint": e["fingerprint"],
                          "changed": e["changed"],
                          "error": str(e["error"]) if e.get("error")
                          else None}
                         for e in retargets],
            "plans": {e["program"]: e["plan"] for e in retargets},
        }
        self.events.append(event)
        # predictions are judged against the new fabric from here on
        for dq in self._errs.values():
            dq.clear()
        return event

    def replanned(self, program_name: str):
        """Latest replanned ExecutionPlan for ``program_name`` (from the
        planner's program registry), or None — what a launch surface
        re-binds after a recalibration event reports ``changed``."""
        for ev in self.planner.replan_programs():
            if ev["program"] == program_name:
                return ev["plan"]
        return None

    def check(self) -> Optional[dict]:
        """Recalibrate iff drift exceeds the threshold (and the window
        holds enough observations, and the cooldown elapsed)."""
        self.checks += 1
        reg = default_registry()
        reg["repro_drift_checks_total"].inc(fabric=self.topo.name)
        for op, v in self.drift_by_op().items():
            reg["repro_drift_ratio"].set(v, op=op, fabric=self.topo.name)
        if self._n_observations() < self.min_observations:
            return None
        if self.checks - self._last_recal_check < self.cooldown:
            return None
        if self.drift() <= self.threshold:
            return None
        return self.recalibrate()

    def run_cycle(self, executor, *, ops: Sequence[str] = DEFAULT_OPS,
                  payloads=None, directions: bool = True,
                  **scenario_kw) -> Optional[dict]:
        """One full telemetry cycle: probe sweep + directed rail
        microbenchmarks (predicted under the planner's CURRENT model)
        -> store -> observe -> drift check.  Returns the recalibration
        event if one fired.  ``directions=False`` skips the per-direction
        p2p probes (they exist so never-bottlenecking rail directions —
        asymmetric forward rails — get fitted instead of staying
        nominal).  With a failure ``detector`` attached, every cycle
        starts with a rail scan against the HEALTHY base fabric (the
        only place a dead rail's recovery is visible) and a change in
        the declared fault set retargets all programs via
        :meth:`apply_failures` before the calibration probes run on the
        surviving capacity graph."""
        if self.detector is not None and self.detector.scan(executor):
            self.apply_failures(self.detector.failures())
        records = probe_sweep(self.topo, executor, ops=ops,
                              payloads=payloads, hw=self.planner.hw,
                              **scenario_kw)
        if directions:
            records += probe_link_directions(self.topo, executor,
                                             hw=self.planner.hw)
        self.store.extend(records)
        for r in records:
            self.observe(r)
        return self.check()

    # -- reporting (ServeEngine.plan_report / train logs) --------------------
    @property
    def last_recalibration(self) -> Optional[dict]:
        # events interleave recalibrations with failover/failback; the
        # last RECAL is the one carrying drift/fit fields
        for e in reversed(self.events):
            if "drift" in e:
                return e
        return None

    @property
    def last_failover(self) -> Optional[dict]:
        for e in reversed(self.events):
            if e.get("kind") in ("failover", "failback"):
                return e
        return None

    def staged_plan(self, program_name: str):
        """The most recent retargeted plan for ``program_name`` from a
        failover/failback event, if any — what a serving engine stages
        for hot re-bind when its bound plan goes stale."""
        for e in reversed(self.events):
            plan = e.get("plans", {}).get(program_name)
            if plan is not None:
                return plan
        return None

    def report(self) -> dict:
        last = self.last_recalibration
        fail = self.last_failover
        recals = sum(1 for e in self.events if "drift" in e)
        return {
            "drift_pct": round(100.0 * self.drift(), 2),
            "drift_by_op_pct": {op: round(100.0 * v, 2)
                                for op, v in self.drift_by_op().items()},
            "observations": self._n_observations(),
            "checks": self.checks,
            "threshold_pct": 100.0 * self.threshold,
            "recalibrations": recals,
            "last_recalibration": (
                None if last is None else
                {k: last[k] for k in ("check", "drift", "fits",
                                      "measured_links", "n_records")}),
            "last_failover": (
                None if fail is None else
                {k: fail[k] for k in ("kind", "check", "fabric",
                                      "dead_links", "dead_relays",
                                      "lost_npus")}),
            "store_records": len(self.store),
        }


class StepAttribution:
    """Feeds LIVE training-step wall times into the joint pipeline
    decision's measurement rows (``Planner.note_measurement``), closing
    the ROADMAP gap where only SimProbe/synthetic rows reached
    ``fit_overlap_eff``.

    A step's wall time is ``other + n_layers * t_pipe`` where ``t_pipe``
    is the per-layer MoE round-trip time the bound joint decision
    brackets with its (serial, ideal) endpoints.  The non-MoE remainder
    ``other`` is either supplied by the caller (``overhead_s`` — e.g. a
    roofline estimate, which makes the attribution unbiased) or, by
    default, MIN-ANCHORED: the fastest observed step is assumed to have
    achieved the predicted pipeline time, and later steps' attribution
    measures their EXCESS over it.  The min-anchored estimator is
    deliberately conservative — it cannot invent an efficiency better
    than predicted, only pull the fit down when steps run consistently
    slower — and the median inside ``fit_overlap_eff`` absorbs
    straggler-polluted steps.  Probe timings remain the calibration
    ground truth; these rows keep the eta fit fed between probe sweeps.
    """

    def __init__(self, planner: Planner, decision, *, n_layers: int = 1,
                 overhead_s: Optional[float] = None,
                 warmup: int = 3) -> None:
        self.planner = planner
        self.decision = decision
        self.n_layers = max(1, int(n_layers))
        self.overhead_s = overhead_s
        self.warmup = int(warmup)
        self._seen = 0
        self._min_wall = float("inf")      # running min: O(1) for
        #   million-step training loops
        self.fed = 0

    def observe_step(self, wall_s: float) -> Optional[dict]:
        """Attribute one completed step's wall time; returns the decision
        log row it landed in (or None during warmup / when the
        attribution is non-positive)."""
        self._seen += 1
        if self._seen <= self.warmup:      # compile/warmup steps excluded
            return None
        wall_s = float(wall_s)
        self._min_wall = min(self._min_wall, wall_s)
        overhead = self.overhead_s
        if overhead is None:
            overhead = (self._min_wall
                        - self.n_layers * self.decision.predicted_s)
        measured = (wall_s - overhead) / self.n_layers
        if measured <= 0:
            return None
        row = self.planner.note_measurement(self.decision, measured)
        self.fed += 1
        return row


def startup_calibration(topo: Topology, store_path=None, *,
                        planner: Optional[Planner] = None, probe=None,
                        threshold: float = 0.25):
    """Launcher-side startup (shared by train.py --calibrate and
    serve.py --calibrate): probe sweep + fit + recalibrate before step 0
    so planner decisions are scored under measured bandwidths from the
    first trace.  ``probe`` defaults to the simulated executor (no
    fabric to time on CPU hosts); live deployments pass a LiveProbe.
    Returns (store, monitor, event) — event carries the drift AT fit
    time (the monitor's window is cleared by the re-fit)."""
    from repro_torch.core.planner import default_planner

    from .probe import GroundTruth, SimProbe
    from .store import CalibrationStore

    planner = planner or default_planner()
    store = CalibrationStore(store_path)
    monitor = DriftMonitor(planner, store, topo, threshold=threshold)
    probe = probe or SimProbe(GroundTruth())
    event = monitor.run_cycle(probe) or monitor.recalibrate(force=True)
    return store, monitor, event
