"""Latency-model-driven plan selection (paper §5.2 dynamic workflow).

The paper makes scheme choice *dynamic*: "the split ratio is dynamically
calculated based on the measured bandwidth of both link types", and Fig 7
shows MultiWrite only wins past a ~2 MB crossover.  :class:`Planner`
reproduces that behaviour for any registered
:class:`~repro_torch.core.plan.CollectivePlan`:

    decision = Planner().choose("allgather", payload_bytes, topo)
    decision.plan               # "baseline" below ~2 MB, "multiwrite_*" above
    decision.shard_map_kwargs   # mode=/split= for the JAX layer

``choose`` sweeps every registered plan x its knob grid (grids are seeded
on :func:`repro_torch.core.schedules.optimal_split`), simulates each candidate
on the packet oracle, scores the ledger with the calibrated
:class:`~repro_torch.core.latency_model.HardwareModel`, and memoizes the
decision in an LRU cache keyed on
``(op, topology fingerprint, bucketed payload size, hw)`` — so the JAX
layer can consult the planner at every trace without re-simulating.
"""

from __future__ import annotations

import dataclasses
import itertools
import math
import time
from collections import OrderedDict
from typing import Optional

from . import plan as plan_ir
from . import schedules as _schedules  # noqa: F401  (registers the plans)
from .latency_model import (DEFAULT, HardwareModel, overlap_endpoints,
                            phase_breakdown, pipeline_overlap_endpoints,
                            score_ledger, score_phase, score_pipeline)
# bucketing lives next to the CollectiveSite keys it must agree with;
# re-exported here because this module defined it historically
from .plan import bucket_compute_s, bucket_payload  # noqa: F401
from .topology import TPU_ICI_LINK_BW, Topology, full_mesh, tpu_pods

_METRICS = None


def _metrics_registry():
    """The process metrics plane, resolved lazily: ``repro_torch.telemetry``
    imports this module (the monitor drives the planner), so the import
    must happen at call time, not module load."""
    global _METRICS
    if _METRICS is None:
        from repro_torch.telemetry import metrics as _m
        _METRICS = _m.default_registry()
    return _METRICS


# ---------------------------------------------------------------------------
# feasibility under failures
# ---------------------------------------------------------------------------

class NoFeasiblePlanError(RuntimeError):
    """Every candidate of an op was masked as infeasible under the
    topology's :class:`~repro_torch.core.topology.FailureState` — the fabric is
    effectively partitioned for this collective.  Raised instead of
    scoring garbage on links that cannot carry traffic; callers (serving
    tier, stress harness) treat it as "shed or hold traffic", never as a
    plan."""

    def __init__(self, op: str, fabric: str, masked: list[str]):
        self.op = op
        self.fabric = fabric
        self.masked = list(masked)
        detail = "; ".join(self.masked[:4])
        if len(self.masked) > 4:
            detail += f"; ... ({len(self.masked)} candidates)"
        super().__init__(
            f"no feasible {op!r} plan on {fabric}: every candidate was "
            f"masked by the fabric's failure state [{detail}]")


def ledger_infeasible(ledger, failures) -> Optional[str]:
    """Why a simulated ledger cannot execute under ``failures`` (None =
    feasible).  Two checks, straight from the failure model:

    - any charged link is dead (or touches a lost NPU) — no scheme can
      serialize bytes over a dark rail;
    - any *software forwarding engine* the plan relies on
      (``ledger.engine_serial`` — populated only by multiwrite/relayed
      schedules) sits on a dead relay.  Plain unicast store-and-forward
      charges ``relay_bytes`` but no engine, so it survives a relay-engine
      loss — the multiwrite → hierarchical → unicast degradation ladder.
    """
    for key in ledger.link_bytes:
        if failures.link_is_dead(key):
            return f"dead link {key[0]}->{key[1]}"
    for node in ledger.engine_serial:
        if failures.relay_is_dead(node):
            return f"dead relay engine on node {node}"
    return None


def plan_site_ledgers(eplan, topo: Topology) -> dict:
    """Re-simulate each site decision of ``eplan`` on ``topo`` and
    return ``role -> Ledger`` — the byte ledgers the bound plan actually
    executes.  This is the post-hoc feasibility audit surface: the
    stress harness asserts that no ledger of a serving plan charges a
    link the hidden ground truth has killed (the "never execute an
    infeasible plan" invariant, checked against TRUTH rather than
    against the detector's belief)."""
    out = {}
    for role in sorted(eplan.decisions):
        site = next((s for s in eplan.program.sites if s.role == role),
                    None)
        if site is None:
            continue
        d = eplan.decisions[role]
        scheme = plan_ir.get_plan(site.op, d.plan)
        scenario = Planner._scenario(site.op, site.topo or topo,
                                     site.scenario_args())
        out[role] = scheme.simulate(scenario, d.payload_bytes,
                                    **dict(d.knobs))
    return out


# ---------------------------------------------------------------------------
# cache keys
# ---------------------------------------------------------------------------

def topology_fingerprint(topo: Topology) -> tuple:
    """Hashable identity of a topology (delegates to
    :meth:`Topology.fingerprint`: name, shape, fabric meta and the exact
    per-link bandwidth assignment — asymmetric fabrics with identical
    bandwidth multisets stay distinct)."""
    return topo.fingerprint()


# ---------------------------------------------------------------------------
# decisions
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class PlanDecision:
    """The planner's verdict for one (op, topology, payload bucket)."""

    op: str
    plan: str                       # winning plan name
    knobs: tuple                    # sorted (knob, value) pairs
    predicted_s: float              # winner's modeled latency
    baseline_s: float               # the op's baseline plan latency
    payload_bytes: int              # bucketed payload the scores used
    shard_map_kwargs: dict          # what the JAX layer executes
    candidates: tuple               # ((plan, knobs, predicted_s), ...) sorted
    predicted_serial_s: float = 0.0  # winner scored at overlap_eff=0 (==
    #   predicted_s for non-pipelined winners)
    predicted_ideal_s: float = 0.0   # winner scored at overlap_eff=1; the
    #   (serial, ideal) endpoints bracket any measured time, which is how
    #   telemetry fits the achieved overlap efficiency (fit_overlap_eff)

    @property
    def delta_vs_baseline(self) -> float:
        """Predicted latency saved vs the baseline plan (seconds; >0 means
        the chosen plan is faster)."""
        return self.baseline_s - self.predicted_s

    @property
    def speedup_pct(self) -> float:
        if self.baseline_s <= 0:
            return 0.0
        return 100.0 * (1.0 - self.predicted_s / self.baseline_s)

    def knob(self, name: str, default=None):
        return dict(self.knobs).get(name, default)

    @property
    def microbatch(self) -> int:
        """Pipeline chunk count G of the winning plan (1 = unchunked)."""
        return int(self.knob("microbatch", 1))

    def summary(self) -> str:
        kn = ", ".join(f"{k}={v}" for k, v in self.knobs)
        return (f"{self.op}: plan={self.plan}({kn}) "
                f"predicted={self.predicted_s * 1e6:.1f}us "
                f"baseline={self.baseline_s * 1e6:.1f}us "
                f"({self.speedup_pct:+.1f}%)")

    def report(self) -> dict:
        """JSON-serializable view for dry-run cells / serve stats."""
        return {"plan": self.plan, "knobs": dict(self.knobs),
                "predicted_us": self.predicted_s * 1e6,
                "baseline_us": self.baseline_s * 1e6,
                "delta_vs_baseline_us": self.delta_vs_baseline * 1e6,
                "speedup_pct": self.speedup_pct}


# ---------------------------------------------------------------------------
# the planner
# ---------------------------------------------------------------------------

class Planner:
    """Sweeps registered plans + knob grids; scores with the latency model.

    One process-wide instance (:func:`default_planner`) backs the JAX
    layer; tests construct their own to control the cache.
    """

    # decision_log ring-buffer cap: long-lived servers append a row per
    # fresh decision AND per cache-served measurement forever — without a
    # cap a week-long serve leaks unboundedly.  10k rows keeps far more
    # history than fit_overlap_eff's median needs while bounding memory;
    # evictions are counted (decision_log_dropped /
    # repro_planner_decision_log_dropped_total).
    DECISION_LOG_MAX = 10_000

    PROGRAM_CACHE_SIZE = 64

    # largest per-phase candidate product the exhaustive oracle sweeps;
    # above it "auto" program planning switches to beam search (the
    # product grows multiplicatively with every op that joins a phase —
    # a 3-group tpu_2x16 train phase is already ~2000 combinations)
    EXHAUSTIVE_LIMIT = 512

    def __init__(self, hw: HardwareModel = DEFAULT,
                 cache_size: int = 256, *, beam_width: int = 6,
                 shortlist_k: int = 6, search: str = "auto",
                 decision_log_max: Optional[int] = None) -> None:
        if search not in ("auto", "beam", "exhaustive"):
            raise ValueError(f"unknown search mode {search!r}; expected "
                             f"'auto' | 'beam' | 'exhaustive'")
        self.hw = hw
        self.beam_width = int(beam_width)
        self.shortlist_k = int(shortlist_k)
        self.search = search
        self.cache_size = int(cache_size)
        self._cache: OrderedDict[tuple, PlanDecision] = OrderedDict()
        self.cache_hits = 0
        self.cache_misses = 0
        self.recalibrations = 0
        # (plan, predicted, measured) rows: one per fresh sweep (measured
        # None until telemetry fills it via note_measurement) — the audit
        # trail the drift monitor and serve reports read.  Ring-buffered
        # at decision_log_max; evictions counted in decision_log_dropped.
        self.decision_log: list[dict] = []
        self.decision_log_max = int(self.DECISION_LOG_MAX
                                    if decision_log_max is None
                                    else decision_log_max)
        self.decision_log_dropped = 0
        # last winning scheme per (op, fabric, bucket) cell — flips
        # (scheme changes after a recalibration) are an SLO-bearing
        # production event, counted in repro_planner_decision_flips_total
        self._last_scheme: dict[tuple, str] = {}
        # whole-program planning: memoized ExecutionPlans plus a registry
        # of every (program, topo) planned through this planner, so a
        # re-calibration can replan PROGRAMS (the unit consumers bind)
        # rather than just dropping per-op cache entries.
        self._program_cache: OrderedDict[tuple, object] = OrderedDict()
        self._programs: OrderedDict[tuple, tuple] = OrderedDict()

    # -- cache ---------------------------------------------------------------
    def cache_info(self) -> dict:
        return {"hits": self.cache_hits, "misses": self.cache_misses,
                "size": len(self._cache), "maxsize": self.cache_size}

    def cache_clear(self) -> None:
        self._cache.clear()
        self._program_cache.clear()
        self.cache_hits = self.cache_misses = 0

    # -- online re-calibration ----------------------------------------------
    def refresh_hardware(self, hw: HardwareModel) -> None:
        """Swap the hardware model (telemetry re-calibration) and drop
        every cached decision.  The cache key already carries
        ``hw.fingerprint()``, so stale entries could never be *served*
        under the new model — clearing just stops them squatting in the
        LRU."""
        self.hw = hw
        self._cache.clear()
        self._program_cache.clear()
        self.recalibrations += 1

    def _trim_decision_log(self) -> None:
        """Ring-buffer eviction for every decision_log append path (fresh
        decisions, program rows AND note_measurement's fallback append —
        the path that used to leak on long-lived servers)."""
        overflow = len(self.decision_log) - self.decision_log_max
        if overflow > 0:
            del self.decision_log[:overflow]
            self.decision_log_dropped += overflow
            _metrics_registry()[
                "repro_planner_decision_log_dropped_total"].inc(overflow)

    def _log_decision(self, decision: PlanDecision, topo_name: str) -> None:
        self.decision_log.append(
            {"op": decision.op, "plan": decision.plan,
             "knobs": dict(decision.knobs), "topo": topo_name,
             "payload_bytes": decision.payload_bytes,
             "predicted_s": decision.predicted_s,
             # overlap-interpolation endpoints of the winner: the rows
             # telemetry fits hw.overlap_eff against once measured_s
             # arrives (fit_overlap_eff skips rows where they coincide)
             "predicted_serial_s": decision.predicted_serial_s,
             "predicted_ideal_s": decision.predicted_ideal_s,
             "measured_s": None})
        self._trim_decision_log()
        reg = _metrics_registry()
        labels = dict(op=decision.op, fabric=topo_name,
                      payload_bucket=str(decision.payload_bytes))
        reg["repro_planner_decisions_total"].inc(scheme=decision.plan,
                                                 **labels)
        cell = (decision.op, topo_name, decision.payload_bytes)
        prev = self._last_scheme.get(cell)
        if prev is not None and prev != decision.plan:
            reg["repro_planner_decision_flips_total"].inc(**labels)
        self._last_scheme[cell] = decision.plan

    def note_measurement(self, decision: PlanDecision,
                         measured_s: float) -> dict:
        """Attach a measured execution time to the most recent logged row
        for this decision (telemetry closes the loop here); appends a
        fresh row if the decision was served from cache.  The knob AND
        predicted-score match matter: a G == 1 execution time written
        into a G > 1 row — or into the same plan's row for a DIFFERENT
        fabric/compute context (equal op/plan/payload, different
        endpoints) — would corrupt the overlap-efficiency fit.
        ``predicted_s`` is copied verbatim from the decision into its
        log row, so float equality identifies exactly its rows."""
        knobs = dict(decision.knobs)
        for row in reversed(self.decision_log):
            if (row["op"] == decision.op and row["plan"] == decision.plan
                    and row["payload_bytes"] == decision.payload_bytes
                    and row["predicted_s"] == decision.predicted_s
                    and dict(row.get("knobs", {})) == knobs
                    and row["measured_s"] is None):
                row["measured_s"] = float(measured_s)
                return row
        row = {"op": decision.op, "plan": decision.plan,
               "knobs": dict(decision.knobs), "topo": None,
               "payload_bytes": decision.payload_bytes,
               "predicted_s": decision.predicted_s,
               "predicted_serial_s": decision.predicted_serial_s,
               "predicted_ideal_s": decision.predicted_ideal_s,
               "measured_s": float(measured_s)}
        self.decision_log.append(row)
        self._trim_decision_log()
        return row

    # -- scenario construction ----------------------------------------------
    @staticmethod
    def _scenario(op: str, topo: Topology, scenario_kw: dict):
        if op == "allgather":
            num_domains = scenario_kw.get("num_domains", 2)
            return plan_ir.AllGatherScenario.split_tp(topo, num_domains)
        if op in ("dispatch", "combine"):
            cls = (plan_ir.DispatchScenario if op == "dispatch"
                   else plan_ir.CombineScenario)
            return cls(
                topo=topo,
                num_experts=scenario_kw.get("num_experts", 64),
                top_k=scenario_kw.get("top_k", 8),
                token_bytes=scenario_kw.get("token_bytes", 7168),
                skew=scenario_kw.get("skew", 0.0),
                compute_s=bucket_compute_s(
                    scenario_kw.get("compute_s", 0.0)))
        if op == "linkprobe":
            return plan_ir.LinkProbeScenario(
                topo, scenario_kw.get("src_server", 0),
                scenario_kw.get("dst_server",
                                1 if topo.meta.num_servers > 1 else 0))
        if op in ("allreduce", "reduce_scatter"):
            return plan_ir.ReduceScenario(
                topo=topo,
                compute_s=bucket_compute_s(
                    scenario_kw.get("compute_s", 0.0)))
        raise ValueError(f"unknown collective op {op!r}")

    # -- the decision --------------------------------------------------------
    def choose(self, op: str, payload_bytes: float, topo: Topology,
               hw: Optional[HardwareModel] = None, *,
               executable_only: bool = False, **scenario_kw) -> PlanDecision:
        """Pick the fastest registered plan for ``op`` at ``payload_bytes``.

        ``payload_bytes`` is the per-participant payload: the AllGather
        fragment size, or ``tokens_per_rank * token_bytes`` for dispatch.
        """
        hw = hw or self.hw
        bucket = bucket_payload(payload_bytes)
        scenario = self._scenario(op, topo, scenario_kw)
        # the hw FINGERPRINT (not the object) is part of the key: an
        # in-place ``planner.hw`` swap after recalibration can never
        # serve a decision scored under the old calibration, and two
        # value-equal models share entries.
        key = (op, topology_fingerprint(topo), bucket, hw.fingerprint(),
               executable_only, scenario.cache_key())
        hit = self._cache.get(key)
        if hit is not None:
            self.cache_hits += 1
            _metrics_registry()["repro_planner_cache_hits_total"].inc()
            self._cache.move_to_end(key)
            return hit
        self.cache_misses += 1
        _metrics_registry()["repro_planner_cache_misses_total"].inc()
        decision = self._sweep(op, scenario, bucket, hw, executable_only)
        self._cache[key] = decision
        self._log_decision(decision, topo.name)
        while len(self._cache) > self.cache_size:
            self._cache.popitem(last=False)
        return decision

    def _site_rows(self, op: str, scenario, bucket: int, hw: HardwareModel,
                   executable_only: bool) -> list[tuple]:
        """Every (plan, knobs) candidate of one uncoupled site, simulated
        and scored on its own ledger; sorted by (own score, registration
        order).  Rows are ``(t, order, plan, knobs, ledger)``."""
        plans = plan_ir.plans_for(op, executable_only=executable_only)
        if not plans:
            raise ValueError(f"no plans registered for op {op!r}")
        topo = scenario.topo
        failures = topo.failures if topo.failures else None
        scored: list[tuple] = []        # (t, order, plan, knobs, ledger)
        masked: list[str] = []
        for order, p in enumerate(plans):
            for knobs in p.knob_grid():
                try:
                    ledger = p.simulate(scenario, bucket, **knobs)
                    reason = (ledger_infeasible(ledger, failures)
                              if failures is not None else None)
                    if reason is None:
                        t = score_ledger(ledger, hw)
                except (ValueError, KeyError, RuntimeError) as e:
                    # on a degraded fabric a candidate may not even
                    # simulate (no route / missing link); that IS the
                    # feasibility verdict, not an error
                    if failures is None:
                        raise
                    reason = str(e)
                if reason is not None:
                    masked.append(f"{p.name}: {reason}")
                    continue
                scored.append((t, order, p, knobs, ledger))
        if masked:
            _metrics_registry()["repro_plan_infeasible_total"].inc(
                len(masked), op=op, fabric=topo.name)
        if not scored:
            raise NoFeasiblePlanError(op, topo.name, masked)
        scored.sort(key=lambda s: (s[0], s[1]))
        return scored

    def _site_decision(self, op: str, scored: list, chosen: tuple,
                       bucket: int, hw: HardwareModel) -> PlanDecision:
        """PlanDecision for ``chosen`` (any row of ``scored`` — the
        contention-aware program search may pick a non-first row)."""
        best_t, _, best, best_knobs, best_ledger = chosen
        base_name = plan_ir.BASELINE_PLAN[op]
        # the baseline reference is the SERIAL (G == 1) baseline cell —
        # what a fixed-policy baseline deployment actually executes —
        # so speedup_pct keeps its meaning now that the grid also holds
        # pipelined baseline candidates
        base_t = min((t for t, _, p, kn, _ in scored
                      if p.name == base_name
                      and kn.get("microbatch", 1) == 1),
                     default=best_t)
        serial_t, ideal_t = overlap_endpoints(best_ledger, hw)
        return PlanDecision(
            op=op, plan=best.name,
            knobs=tuple(sorted(best_knobs.items())),
            predicted_s=best_t, baseline_s=base_t, payload_bytes=bucket,
            shard_map_kwargs=best.shard_map_kwargs(**best_knobs),
            candidates=tuple((p.name, tuple(sorted(kn.items())), t)
                             for t, _, p, kn, _ in scored),
            predicted_serial_s=serial_t, predicted_ideal_s=ideal_t)

    def _sweep(self, op: str, scenario, bucket: int, hw: HardwareModel,
               executable_only: bool) -> PlanDecision:
        scored = self._site_rows(op, scenario, bucket, hw, executable_only)
        return self._site_decision(op, scored, scored[0], bucket, hw)

    # -- whole-program planning ----------------------------------------------
    def plan_program(self, program: "plan_ir.CollectiveProgram",
                     topo: Topology,
                     hw: Optional[HardwareModel] = None,
                     *, executable_only: bool = True
                     ) -> "plan_ir.ExecutionPlan":
        """Jointly plan every declared site of ``program`` and return the
        immutable, fingerprinted :class:`~repro_torch.core.plan.ExecutionPlan`.

        Uncoupled sites sweep exactly as :meth:`choose` does.  Coupled
        groups — the MoE (dispatch, combine) pair that executes inside
        ONE chunk pipeline — sweep the full (dispatch scheme) x (combine
        scheme) x (shared microbatch G) product under the
        shared-pipeline scorer (:func:`score_pipeline`), so a smaller
        dispatch G can win on the COMBINED score where the old
        dispatch-first resolution would have over-chunked (the joint
        pipeline pays dispatch + combine startup per chunk and its
        bottleneck stage is the max over three stages, not two).

        Groups CONCURRENT within one phase contend for shared links:
        each phase's candidate combinations are scored with
        :func:`~repro_torch.core.latency_model.score_phase` (per-link demand
        summed across the phase's sites, the summed bottleneck charged
        jointly), searched exhaustively when the candidate product is
        small (the oracle) and by beam search over per-group shortlists
        past :data:`EXHAUSTIVE_LIMIT`.  Phases carrying a latency budget
        (``program.phase_budgets``) are planned first and then constrain
        the remaining phases — a combination whose background traffic
        pushes a budgeted phase past its cap is rejected.

        Sites may carry their own fabric (``site.topo``); everything
        else is scored on ``topo``.  Plans are memoized on
        (program, topo, hw, search knobs) and the (program, topo) pair
        is registered so :meth:`replan_programs` can re-derive every
        known program after a re-calibration.
        """
        hw = hw or self.hw
        pkey = (program.cache_key(), topology_fingerprint(topo),
                executable_only)
        key = (*pkey, hw.fingerprint(), self.search, self.beam_width,
               self.shortlist_k)
        hit = self._program_cache.get(key)
        if hit is not None:
            self.cache_hits += 1
            _metrics_registry()["repro_planner_cache_hits_total"].inc()
            self._program_cache.move_to_end(key)
            return hit
        self.cache_misses += 1
        _metrics_registry()["repro_planner_cache_misses_total"].inc()
        t_start = time.perf_counter()
        decisions: dict = {}
        joint: dict = {}
        group_of: dict = {}
        budgets = dict(program.phase_budgets)
        # budgeted phases plan FIRST: their chosen ledgers then act as
        # the fixed background every later phase is constrained against
        phase_order = sorted(program.phases().items(),
                             key=lambda kv: kv[0] not in budgets)
        chosen_entries: dict[str, list] = {}   # phase -> [(score, ledgers)]
        phase_search: dict[str, dict] = {}
        for phase_name, groups in phase_order:
            bundles = [self._group_candidates(g, topo, hw, executable_only)
                       for g in groups]
            constraints = [(chosen_entries[ph], budgets[ph])
                           for ph in budgets
                           if ph != phase_name and ph in chosen_entries]
            combo, stats = self._search_phase(
                bundles, hw, budget=budgets.get(phase_name),
                constraints=constraints)
            phase_search[phase_name] = stats
            entries = []
            for bundle, j in zip(bundles, combo):
                cand = bundle["cands"][j]
                entries.append((cand["score_s"], cand["ledgers"]))
                row = cand["row"]
                if bundle["kind"] == "single":
                    site = bundle["site"]
                    dec = self._site_decision(
                        site.op, bundle["rows"], row, bundle["bucket"], hw)
                    decisions[site.role] = dec
                    self._log_decision(dec, bundle["topo"].name)
                else:
                    dsite, csite = bundle["sites"]
                    d_bucket, c_bucket = bundle["buckets"]
                    d_dec, c_dec, j_dec = self._moe_pair_decisions(
                        bundle["rows"], row, d_bucket, c_bucket, hw)
                    decisions[dsite.role] = d_dec
                    decisions[csite.role] = c_dec
                    joint[dsite.role] = j_dec
                    group_of[dsite.role] = dsite.role
                    group_of[csite.role] = dsite.role
                    self._log_decision(j_dec, bundle["topo"].name)
            chosen_entries[phase_name] = entries
        phase_report: dict[str, dict] = {}
        for phase_name, _ in phase_order:
            entries = chosen_entries[phase_name]
            rep = phase_breakdown(entries, hw)
            rep["groups"] = len(entries)
            rep["budget_s"] = budgets.get(phase_name)
            if phase_name in budgets:
                # the SLO verdict is checked under CONTENDED conditions:
                # every other phase's chosen traffic as background (the
                # continuous-batching regime the budget models)
                background = [led for ph, ents in chosen_entries.items()
                              if ph != phase_name
                              for _, ledgers in ents for led in ledgers]
                rep["contended_score_s"] = score_phase(
                    entries, hw, background=background)
                rep["budget_ok"] = (rep["contended_score_s"]
                                    <= budgets[phase_name])
            rep["search"] = phase_search[phase_name]
            phase_report[phase_name] = rep
        planner_stats = {
            "search": sorted({s["search"]
                              for s in phase_search.values()}),
            "phases": len(phase_search),
            "candidates": sum(s["candidates"]
                              for s in phase_search.values()),
            "product": sum(s["product"] for s in phase_search.values()),
            "combos_scored": sum(s["combos_scored"]
                                 for s in phase_search.values()),
            "combos_pruned": sum(s["combos_pruned"]
                                 for s in phase_search.values()),
            "beam_width": self.beam_width,
            "budget_violated": any(s.get("budget_violated")
                                   for s in phase_search.values()),
            "planning_wall_s": time.perf_counter() - t_start}
        reg = _metrics_registry()
        reg["repro_planner_planning_wall_seconds"].observe(
            planner_stats["planning_wall_s"], program=program.name)
        reg["repro_planner_search_combos_scored"].set(
            planner_stats["combos_scored"], program=program.name)
        reg["repro_planner_search_combos_pruned"].set(
            planner_stats["combos_pruned"], program=program.name)
        reg["repro_planner_search_product"].set(
            planner_stats["product"], program=program.name)
        eplan = plan_ir.ExecutionPlan(
            program=program,
            topo_fingerprint=topology_fingerprint(topo),
            hw_fingerprint=hw.fingerprint(),
            decisions=decisions, joint=joint, group_of=group_of,
            phase_report=phase_report, planner_stats=planner_stats)
        self._log_program(program, topo, eplan)
        self._program_cache[key] = eplan
        while len(self._program_cache) > self.PROGRAM_CACHE_SIZE:
            self._program_cache.popitem(last=False)
        self._programs[pkey] = (program, topo, eplan.fingerprint)
        while len(self._programs) > self.PROGRAM_CACHE_SIZE:
            self._programs.popitem(last=False)
        return eplan

    def _log_program(self, program, topo: Topology, eplan) -> None:
        """Program-level decision_log row: planner COST introspection
        (candidates, combinations, wall-time) rides the same audit trail
        the per-op rows use.  ``predicted_serial_s`` stays 0 so
        fit_overlap_eff never mistakes it for a measurable op row."""
        stats = dict(eplan.planner_stats)
        total = sum(rep.get("score_s", 0.0)
                    for rep in eplan.phase_report.values())
        self.decision_log.append(
            {"op": "program", "plan": program.name, "knobs": {},
             "topo": topo.name, "payload_bytes": 0,
             "predicted_s": total, "predicted_serial_s": 0.0,
             "predicted_ideal_s": 0.0, "measured_s": None,
             "planner": stats})
        self._trim_decision_log()

    def _group_candidates(self, group, topo: Topology, hw: HardwareModel,
                          executable_only: bool) -> dict:
        """Candidate bundle of one jointly-planned group: every scored
        row plus a uniform ``cands`` view ``{score_s, ledgers, row}``
        (sorted by own contention-free score) the phase search consumes."""
        if len(group) == 1:
            site = group[0]
            site_topo = site.topo or topo
            scenario = self._scenario(site.op, site_topo,
                                      site.scenario_args())
            bucket = bucket_payload(site.payload_bytes)
            rows = self._site_rows(site.op, scenario, bucket, hw,
                                   executable_only)
            cands = [{"score_s": r[0], "ledgers": (r[4],), "row": r}
                     for r in rows]
            return {"kind": "single", "site": site, "topo": site_topo,
                    "bucket": bucket, "rows": rows, "cands": cands}
        if (len(group) == 2 and group[0].op == "dispatch"
                and group[1].op == "combine"):
            dsite, csite = group
            pair_topo = dsite.topo or topo
            rows, d_bucket, c_bucket = self._moe_pair_rows(
                dsite, csite, pair_topo, hw,
                executable_only=executable_only)
            cands = [{"score_s": r[0], "ledgers": (r[4], r[7]), "row": r}
                     for r in rows]
            return {"kind": "pair", "sites": (dsite, csite),
                    "topo": pair_topo, "buckets": (d_bucket, c_bucket),
                    "rows": rows, "cands": cands}
        raise ValueError(
            f"unsupported coupled group "
            f"{[(s.role, s.op) for s in group]}: joint sweeps are "
            f"defined for a (dispatch, combine) pair")

    def _search_phase(self, bundles: list, hw: HardwareModel, *,
                      budget: Optional[float] = None,
                      constraints=()) -> tuple[tuple, dict]:
        """Pick one candidate per group minimizing the phase's
        contention-aware score (:func:`score_phase`).

        ``budget``       cap on this phase's own score (its SLO);
        ``constraints``  [(entries, budget_s), ...] of already-planned
                         budgeted phases: a combination is infeasible
                         when its ledgers as BACKGROUND push such a
                         phase past its cap.

        Search mode resolves from ``self.search``: the exhaustive
        oracle when the candidate product is within
        :data:`EXHAUSTIVE_LIMIT` (or forced), else beam search — per
        group the top ``shortlist_k`` candidates by own score, partial
        combinations re-scored jointly and pruned to ``beam_width``.
        The greedy all-own-best combination is always evaluated too, so
        beam search can never do worse than independent per-site
        planning.  Infeasible-everywhere falls back to the best
        unconstrained combination with ``budget_violated`` set.

        Ties break toward the lowest sum of own scores, then the
        lexicographically first combination — with zero contention (all
        groups on disjoint fabrics) that reproduces per-group
        independent planning exactly.
        """
        cand_lists = [b["cands"] for b in bundles]
        product = 1
        for cl in cand_lists:
            product *= len(cl)
        n_candidates = sum(len(cl) for cl in cand_lists)
        mode = self.search
        if mode == "auto":
            mode = ("exhaustive" if product <= self.EXHAUSTIVE_LIMIT
                    else "beam")
        stats = {"search": mode, "groups": len(cand_lists),
                 "candidates": n_candidates, "product": product,
                 "beam_width": (self.beam_width if mode == "beam"
                                else None),
                 "shortlist_k": (self.shortlist_k if mode == "beam"
                                 else None),
                 "budget_violated": False}
        constrained = budget is not None or bool(constraints)
        if len(cand_lists) == 1 and not constrained:
            # a lone group cannot contend with itself beyond what its
            # own scorer already charges: its own best is the optimum
            stats.update(combos_scored=0, combos_pruned=0)
            return (0,), stats

        def entries_of(combo):
            return [(cand_lists[i][j]["score_s"],
                     cand_lists[i][j]["ledgers"])
                    for i, j in enumerate(combo)]

        def feasible(combo, phase_s):
            if budget is not None and phase_s > budget:
                return False
            if constraints:
                bg = [led for _, ledgers in entries_of(combo)
                      for led in ledgers]
                for ents, cap in constraints:
                    if score_phase(ents, hw, background=bg) > cap:
                        return False
            return True

        def own_sum(combo):
            return sum(cand_lists[i][j]["score_s"]
                       for i, j in enumerate(combo))

        scored_count = 0
        finalists: list[tuple] = []     # (phase_s, own_sum, combo)
        if mode == "exhaustive":
            for combo in itertools.product(
                    *(range(len(cl)) for cl in cand_lists)):
                phase_s = score_phase(entries_of(combo), hw)
                scored_count += 1
                finalists.append((phase_s, own_sum(combo), combo))
        else:
            k = max(1, self.shortlist_k)
            width = max(1, self.beam_width)
            beams: list[tuple] = [((), 0.0, 0.0)]
            for cl in cand_lists:
                grown = []
                for combo, _, _ in beams:
                    for j in range(min(k, len(cl))):
                        c2 = combo + (j,)
                        phase_s = score_phase(entries_of(c2), hw)
                        scored_count += 1
                        grown.append((c2, phase_s, own_sum(c2)))
                grown.sort(key=lambda b: (b[1], b[2], b[0]))
                beams = grown[:width]
            finalists = [(s, o, c) for c, s, o in beams]
            greedy = tuple(0 for _ in cand_lists)
            if greedy not in {c for _, _, c in finalists}:
                phase_s = score_phase(entries_of(greedy), hw)
                scored_count += 1
                finalists.append((phase_s, own_sum(greedy), greedy))
        finalists.sort()
        best = finalists[0]
        if constrained:
            for cand in finalists:
                if feasible(cand[2], cand[0]):
                    best = cand
                    break
            else:
                stats["budget_violated"] = True
        stats["combos_scored"] = scored_count
        stats["combos_pruned"] = max(0, product - scored_count)
        return best[2], stats

    def plan_is_stale(self, eplan) -> Optional[bool]:
        """Whether a bound ExecutionPlan has been superseded by a replan
        of the same (program, fabric) under newer calibration — True
        (stale), False (current), or None (this planner has no record,
        e.g. a pinned plan or a foreign planner's product).  A program
        that was RETARGETED to a different topology (failover /
        failback via :meth:`retarget_programs`) makes any plan bound on
        the old fabric stale by construction."""
        program_seen = False
        for pkey, (_, _, fp) in self._programs.items():
            if pkey[0] != eplan.program.cache_key():
                continue
            if pkey[1] == eplan.topo_fingerprint:
                return fp != eplan.fingerprint
            program_seen = True
        if program_seen:
            return True
        return None

    def retarget_programs(self, old_topo: Topology,
                          new_topo: Topology) -> list[dict]:
        """Move every registered program from ``old_topo`` to
        ``new_topo`` and re-plan it there — the planner half of a
        failover (or failback): routing recomputes from the surviving
        capacity graph, and plans bound on the old fabric become stale
        (:meth:`plan_is_stale`) so the runtime re-binds.

        Returns one event per moved program, shaped like
        :meth:`replan_programs` events.  A program whose collectives are
        unplannable on the degraded fabric surfaces the typed
        :class:`NoFeasiblePlanError` in the event (``plan=None``) rather
        than silently keeping the old, infeasible plan registered.
        """
        old_fp = topology_fingerprint(old_topo)
        events = []
        reg = _metrics_registry()
        for pkey, (program, _, old_plan_fp) in list(self._programs.items()):
            if pkey[1] != old_fp:
                continue
            del self._programs[pkey]
            try:
                eplan = self.plan_program(program, new_topo,
                                          executable_only=pkey[-1])
            except NoFeasiblePlanError as e:
                events.append({"program": program.name, "fingerprint": None,
                               "changed": True, "plan": None, "error": e})
                continue
            changed = eplan.fingerprint != old_plan_fp
            reg["repro_plan_replan_total"].inc(
                program=program.name,
                changed="true" if changed else "false")
            events.append({"program": program.name,
                           "fingerprint": eplan.fingerprint,
                           "changed": changed,
                           "plan": eplan})
        return events

    def replan_programs(self) -> list[dict]:
        """Re-plan every registered (program, topo) under the CURRENT
        hardware model — the whole-program face of a re-calibration
        (DriftMonitor calls this after :meth:`refresh_hardware`).
        Returns one event per program: its fresh plan and whether any
        decision changed (fingerprint moved)."""
        events = []
        reg = _metrics_registry()
        for pkey, (program, topo, old_fp) in list(self._programs.items()):
            eplan = self.plan_program(program, topo,
                                      executable_only=pkey[-1])
            changed = eplan.fingerprint != old_fp
            reg["repro_plan_replan_total"].inc(
                program=program.name,
                changed="true" if changed else "false")
            events.append({"program": program.name,
                           "fingerprint": eplan.fingerprint,
                           "changed": changed,
                           "plan": eplan})
        return events

    def _moe_pair_rows(self, dsite, csite, topo: Topology,
                       hw: HardwareModel, *, executable_only: bool
                       ) -> tuple[list, int, int]:
        """Every executable (dispatch config) x (combine config) cell of
        the coupled MoE pair, scored with the shared-pipeline scorer;
        sorted by (joint score, registration order).  Rows are
        ``(t, (d_ord, c_ord), pd, kn_d, ld, pc, kn_c, lc)``."""
        d_scenario = self._scenario("dispatch", topo, dsite.scenario_args())
        c_scenario = self._scenario("combine", topo, csite.scenario_args())
        d_bucket = bucket_payload(dsite.payload_bytes)
        c_bucket = bucket_payload(csite.payload_bytes)
        d_plans = plan_ir.plans_for("dispatch",
                                    executable_only=executable_only)
        c_plans = plan_ir.plans_for("combine",
                                    executable_only=executable_only)
        if not d_plans or not c_plans:
            raise ValueError("no registered dispatch/combine plans")
        failures = topo.failures if topo.failures else None
        masked: list[str] = []

        def half_ledger(cache_key, plan, scenario, bucket, knobs):
            """Simulate one half of the pair; an infeasibility reason
            string (instead of a Ledger) poisons every pairing it joins."""
            if cache_key not in ledgers:
                try:
                    led = plan.simulate(scenario, bucket, **knobs)
                    reason = (ledger_infeasible(led, failures)
                              if failures is not None else None)
                except (ValueError, KeyError, RuntimeError) as e:
                    if failures is None:
                        raise
                    led, reason = None, str(e)
                if reason is not None:
                    masked.append(f"{plan.name}: {reason}")
                    led = None
                ledgers[cache_key] = led
            return ledgers[cache_key]

        scored = []      # (t, order, pd, kn_d, ld, pc, kn_c, lc)
        ledgers: dict = {}
        for d_ord, pd in enumerate(d_plans):
            d_scheme = pd.shard_map_kwargs()["moe_scheme"]
            for kn_d in pd.knob_grid():
                d_key = ("d", pd.name, tuple(sorted(kn_d.items())))
                ld = half_ledger(d_key, pd, d_scenario, d_bucket, kn_d)
                if ld is None:
                    continue
                for c_ord, pc in enumerate(c_plans):
                    c_scheme = pc.shard_map_kwargs()["moe_combine"]
                    # executable pairing: the baseline (unicast) dispatch
                    # has no relay stage, so only the unicast return path
                    # exists for it — mirror of moe_ffn's lowering table
                    if d_scheme == "baseline" and c_scheme != "baseline":
                        continue
                    for kn_c in pc.knob_grid():
                        if kn_c.get("microbatch", 1) != \
                                kn_d.get("microbatch", 1):
                            continue
                        c_key = ("c", pc.name,
                                 tuple(sorted(kn_c.items())))
                        lc = half_ledger(c_key, pc, c_scenario, c_bucket,
                                         kn_c)
                        if lc is None:
                            continue
                        t = score_pipeline((ld, lc), hw)
                        scored.append((t, (d_ord, c_ord), pd, kn_d, ld,
                                       pc, kn_c, lc))
        if masked:
            _metrics_registry()["repro_plan_infeasible_total"].inc(
                len(masked), op="dispatch+combine", fabric=topo.name)
        if not scored:
            raise NoFeasiblePlanError("dispatch+combine", topo.name, masked)
        scored.sort(key=lambda s: (s[0], s[1]))
        return scored, d_bucket, c_bucket

    def _joint_moe_sweep(self, dsite, csite, topo: Topology,
                         hw: HardwareModel, *, executable_only: bool):
        """The coupled (dispatch, combine) product sweep.

        Every (dispatch plan, dispatch knobs) x (combine plan, combine
        knobs) cell whose microbatch knobs AGREE (the executed pipeline
        chunks both halves at one shared G) and whose pair is executable
        (a unicast dispatch leaves no relay state for a relay-reduced
        combine to consume) is scored with :func:`score_pipeline`.
        Returns (dispatch decision, combine decision, joint decision):
        the per-site views carry marginal candidates (best joint score
        per own configuration) and their own-ledger predicted times so
        existing per-op reports keep their meaning; the joint view
        carries the combined score, merged execution kwargs and the
        joint serial/ideal endpoints telemetry fits overlap efficiency
        against."""
        scored, d_bucket, c_bucket = self._moe_pair_rows(
            dsite, csite, topo, hw, executable_only=executable_only)
        return self._moe_pair_decisions(scored, scored[0], d_bucket,
                                        c_bucket, hw)

    def _moe_pair_decisions(self, scored: list, chosen: tuple,
                            d_bucket: int, c_bucket: int,
                            hw: HardwareModel):
        """(dispatch, combine, joint) decisions for ``chosen`` (any row
        of ``scored`` — the program search may pick a non-first row when
        phase contention shifts the optimum)."""
        best_t, _, pd, kn_d, ld, pc, kn_c, lc = chosen
        g = kn_d.get("microbatch", 1)
        # joint baseline: what a fixed unicast/unicast serial deployment
        # pays for the whole round trip
        base_t = min((t for t, _, bpd, bkd, _, bpc, bkc, _ in scored
                      if bpd.name == plan_ir.BASELINE_PLAN["dispatch"]
                      and bpc.name == plan_ir.BASELINE_PLAN["combine"]
                      and bkd.get("microbatch", 1) == 1),
                     default=best_t)
        serial_t, ideal_t = pipeline_overlap_endpoints((ld, lc), hw)
        joint = PlanDecision(
            op="dispatch+combine",
            plan=f"{pd.name}+{pc.name}",
            knobs=(("microbatch", g),),
            predicted_s=best_t, baseline_s=base_t,
            payload_bytes=d_bucket,
            shard_map_kwargs={**pd.shard_map_kwargs(**kn_d),
                              **pc.shard_map_kwargs(**kn_c)},
            candidates=tuple(
                (f"{spd.name}+{spc.name}",
                 tuple(sorted({**skd, **skc}.items())), t)
                for t, _, spd, skd, _, spc, skc, _ in scored),
            predicted_serial_s=serial_t, predicted_ideal_s=ideal_t)
        d_dec = self._marginal_decision(
            "dispatch", pd, kn_d, ld, d_bucket, hw, scored,
            side=lambda s: (s[2], s[3]))
        c_dec = self._marginal_decision(
            "combine", pc, kn_c, lc, c_bucket, hw, scored,
            side=lambda s: (s[5], s[6]))
        return d_dec, c_dec, joint

    def _marginal_decision(self, op: str, best_plan, best_knobs, best_ledger,
                           bucket: int, hw: HardwareModel, scored,
                           side) -> PlanDecision:
        """Per-site view of a joint sweep: the site's own-ledger times at
        the jointly chosen configuration, with candidates carrying the
        best JOINT score reachable per (plan, knobs) of this side —
        reports built on candidates stay meaningful under coupling."""
        marginal: dict = {}
        for row in scored:
            p, kn = side(row)
            k = (p.name, tuple(sorted(kn.items())))
            if k not in marginal or row[0] < marginal[k]:
                marginal[k] = row[0]
        own_t = score_ledger(best_ledger, hw)
        base_name = plan_ir.BASELINE_PLAN[op]
        base_rows = [row for row in scored
                     if side(row)[0].name == base_name
                     and side(row)[1].get("microbatch", 1) == 1]
        base_t = (score_ledger(self._side_ledger(base_rows[0], side), hw)
                  if base_rows else own_t)
        serial_t, ideal_t = overlap_endpoints(best_ledger, hw)
        return PlanDecision(
            op=op, plan=best_plan.name,
            knobs=tuple(sorted(best_knobs.items())),
            predicted_s=own_t, baseline_s=base_t, payload_bytes=bucket,
            shard_map_kwargs=best_plan.shard_map_kwargs(**best_knobs),
            candidates=tuple((name, kn, t)
                             for (name, kn), t in sorted(
                                 marginal.items(),
                                 key=lambda kv: (kv[1], kv[0]))),
            predicted_serial_s=serial_t, predicted_ideal_s=ideal_t)

    @staticmethod
    def _side_ledger(row, side):
        """The ledger belonging to ``side`` of a joint-sweep row."""
        p, _ = side(row)
        # rows are (t, order, pd, kn_d, ld, pc, kn_c, lc)
        return row[4] if p is row[2] else row[7]


_DEFAULT: Optional[Planner] = None


def default_planner() -> Planner:
    """Process-wide planner the JAX layer consults at trace time."""
    global _DEFAULT
    if _DEFAULT is None:
        _DEFAULT = Planner()
    return _DEFAULT


# ---------------------------------------------------------------------------
# high-level helpers consumed by the JAX / launch / benchmark layers
# ---------------------------------------------------------------------------

def _ep_topology(num_pods: int, ep_per_pod: int,
                 topo: Optional[Topology] = None) -> Topology:
    """Topology an EP mesh slice is planned on: an explicit fabric when
    given (``--fabric`` / ``ParallelContext.fabric``), else the
    mesh-derived §3.2 shape — pod == server (slow DCN axis),
    chips-per-pod == NPUs-per-server (fast ICI axis).  A single-pod mesh
    has no slow axis: it is planned on the all-ICI full mesh it actually
    is (where unicast and MultiWrite ledgers coincide and the tie-break
    keeps the relay-free unicast plan)."""
    if topo is not None:
        return topo
    if num_pods > 1:
        return tpu_pods(chips_per_pod=max(2, ep_per_pod), num_pods=num_pods)
    return full_mesh(max(2, ep_per_pod), link_bw=TPU_ICI_LINK_BW,
                     name="ici_full_mesh")


def moe_dispatch_decision(*, num_pods: int, ep_per_pod: int,
                          num_experts: int, top_k: int,
                          tokens_per_rank: int, token_bytes: int,
                          hw: Optional[HardwareModel] = None,
                          planner: Optional[Planner] = None,
                          topo: Optional[Topology] = None,
                          skew: float = 0.0,
                          compute_s: float = 0.0) -> PlanDecision:
    """Plan the MoE dispatch for one EP mesh slice INDEPENDENTLY of its
    return path — the dispatch-first reference (what-if reports and
    ``bench_program``'s comparison baseline); executing consumers plan
    the (dispatch, combine) pair jointly via :meth:`Planner.plan_program`
    (see :func:`_ep_topology` for the fabric the payload is scored on).
    The payload is the per-rank token traffic of one dispatch.
    ``skew > 0`` prices hot-expert (non-uniform) routing.
    ``compute_s > 0`` (the expert-FFN time of the full batch, see
    :func:`repro_torch.core.latency_model.expert_compute_time_s`) enables the
    pipelined scoring mode — the ``microbatch`` knob can then win and
    the decision carries a G > 1 the MoE layer double-buffers."""
    planner = planner or default_planner()
    topo = _ep_topology(num_pods, ep_per_pod, topo)
    return planner.choose(
        "dispatch", float(tokens_per_rank) * token_bytes, topo, hw,
        num_experts=num_experts, top_k=top_k, token_bytes=token_bytes,
        skew=skew, compute_s=compute_s)


def moe_combine_decision(*, num_pods: int, ep_per_pod: int,
                         num_experts: int, top_k: int,
                         tokens_per_rank: int, token_bytes: int,
                         hw: Optional[HardwareModel] = None,
                         planner: Optional[Planner] = None,
                         topo: Optional[Topology] = None,
                         skew: float = 0.0,
                         compute_s: float = 0.0) -> PlanDecision:
    """Plan the MoE *combine* (return path) for one EP mesh slice —
    independent of the dispatch decision (the what-if reference; see
    :func:`moe_dispatch_decision`): the return path's redundancy is
    spread over the holders' rails (and may face asymmetric return
    bandwidth), so its crossover sits elsewhere.  ``compute_s`` is the
    overlap context (see :func:`moe_dispatch_decision`): the combine of
    chunk k-1 hides behind the expert FFN of chunk k."""
    planner = planner or default_planner()
    topo = _ep_topology(num_pods, ep_per_pod, topo)
    return planner.choose(
        "combine", float(tokens_per_rank) * token_bytes, topo, hw,
        num_experts=num_experts, top_k=top_k, token_bytes=token_bytes,
        skew=skew, compute_s=compute_s)


def emergent_crossover_bytes(topo: Topology,
                              hw: Optional[HardwareModel] = None,
                              lo: float = 64 * 2 ** 10,
                              hi: float = 64 * 2 ** 20,
                              planner: Optional[Planner] = None) -> float:
    """Smallest payload bucket where the planner stops choosing baseline
    (the emergent Fig 7 crossover).  Returns ``inf`` if baseline always
    wins in [lo, hi]."""
    planner = planner or default_planner()
    size = float(lo)
    while size <= hi:
        d = planner.choose("allgather", size, topo, hw)
        if d.plan != "baseline":
            return float(d.payload_bytes)
        size *= 2
    return math.inf


def emergent_flip_batch(op: str, topo: Topology,
                        token_bytes: int = 7168,
                        batches: tuple = (16, 32, 64, 128, 256, 512,
                                          1024, 2048, 4096),
                        hw: Optional[HardwareModel] = None,
                        planner: Optional[Planner] = None,
                        **scenario_kw) -> float:
    """Smallest per-rank token batch where the planner stops choosing the
    baseline plan for ``op`` ("dispatch"/"combine") — the Fig 8 flip
    point as an emergent quantity.  ``inf`` if the baseline always wins
    over ``batches`` (e.g. on a full mesh with no slow axis)."""
    planner = planner or default_planner()
    base = plan_ir.BASELINE_PLAN[op]
    for batch in batches:
        d = planner.choose(op, float(batch) * token_bytes, topo, hw,
                           token_bytes=token_bytes, **scenario_kw)
        if d.plan != base:
            return float(batch)
    return math.inf


def serve_flip_batches(topo: Topology, token_bytes: int = 7168,
                       hw: Optional[HardwareModel] = None,
                       planner: Optional[Planner] = None,
                       **scenario_kw) -> dict:
    """Decode-phase scheme-crossover batches per MoE op — what the
    serving tier's AdmissionController consults before growing the
    decode batch across a bucket boundary (``inf``: that op's baseline
    never flips, growth is scheme-neutral)."""
    return {op: emergent_flip_batch(op, topo, token_bytes=token_bytes,
                                    hw=hw, planner=planner, **scenario_kw)
            for op in ("dispatch", "combine")}
