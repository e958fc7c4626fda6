"""Timed execution of registered collective plans (the telemetry PROBE).

Port of ``src/repro/telemetry/probe.py``.  Two executors behind one
``measure`` protocol:

* :class:`LiveProbe` — times the port's own lowerings of every executable
  plan (allgather / dispatch / combine, and the directed ``linkprobe``)
  over a :class:`~repro_torch.parallel.mesh.RankMesh`, every rank of the
  mesh timing the same call, with the slowest rank's wall of each repeat
  agreed through ``torch.distributed``.  This is what a deployment points
  the monitor at.
* :class:`SimProbe` — a pure-simulation fallback: "executes" a plan by
  scoring its ledger under a hidden :class:`GroundTruth` (true per-link
  bandwidths + true overhead constants, optionally noisy).  The truth is
  injectable and degradable, which makes the whole
  probe -> store -> fit -> re-plan loop testable on CPU: degrade the
  truth's inter-server links 4x and the fitted model must move.

:func:`probe_sweep` runs every registered plan for an op over a payload
sweep and emits schema-versioned records for the
:class:`~repro_torch.telemetry.store.CalibrationStore` — each record carries
the predicted time under the CURRENT planner calibration next to the
measured time, plus the per-link-class bottleneck bytes the fitter
regresses against.

Everything but the module docstring and :class:`LiveProbe` is the
reference's text with ``repro.`` read as ``repro_torch.``.
"""

from __future__ import annotations

import dataclasses
import itertools
import time
from typing import Mapping, Optional, Sequence

import numpy as np

from repro_torch.core import plan as plan_ir
from repro_torch.core.latency_model import DEFAULT, HardwareModel, score_ledger
from repro_torch.core.planner import Planner, bucket_payload
from repro_torch.core.topology import Topology

from .store import SCHEMA_VERSION, topo_key

# default payload sweeps: wide enough to pin both the alpha intercept
# (small payloads) and the 1/bw slope (large payloads)
ALLGATHER_SWEEP = (256 << 10, 1 << 20, 4 << 20, 16 << 20, 64 << 20)
DISPATCH_BATCH_SWEEP = (32, 128, 512, 2048)
DEFAULT_OPS = ("allgather", "dispatch", "combine")


class ProbeTimeout(RuntimeError):
    """A probe attempt exceeded its deadline (live) or targeted a link
    the ground truth has blacked out (sim) — the fabric-side signal the
    failure detector turns into dead-link declarations."""


@dataclasses.dataclass(frozen=True)
class ProbePolicy:
    """Bounded-retry policy for one probe attempt.

    A probe that times out (or crashes) is retried up to ``retries``
    times with exponential backoff — ``backoff_s * backoff_mult**k``,
    jittered by ±``jitter`` fraction so a fleet of probers never
    synchronizes its retry storms.  ``timeout_s`` is the per-attempt
    soft deadline enforced by :class:`LiveProbe` wall clocks (``None``
    disables it; :class:`SimProbe` timeouts are truth-driven instead).
    ``sleep`` is injectable so tests and the sim harness never actually
    wait.
    """

    timeout_s: Optional[float] = None
    retries: int = 2
    backoff_s: float = 0.02
    backoff_mult: float = 2.0
    jitter: float = 0.25
    sleep: object = time.sleep

    def delays(self):
        rng = np.random.default_rng()
        for k in range(max(0, self.retries)):
            d = self.backoff_s * self.backoff_mult ** k
            if self.jitter:
                d *= 1.0 + self.jitter * float(rng.uniform(-1.0, 1.0))
            yield d

    def run(self, fn):
        """``fn()`` with bounded retry; re-raises the final failure."""
        last = None
        for delay in itertools.chain(self.delays(), (None,)):
            try:
                return fn()
            except Exception as e:           # noqa: BLE001 — policy layer
                last = e
                if delay is None:
                    raise
                self.sleep(delay)
        raise last  # pragma: no cover — unreachable


DEFAULT_POLICY = ProbePolicy()


def measure_safely(executor, op: str, plan_name: str, payload_bytes: float,
                   topo: Topology, *, policy: ProbePolicy = DEFAULT_POLICY,
                   **measure_kw) -> Optional[float]:
    """One probe measurement under the retry policy; ``None`` (plus a
    ``repro_probe_failures_total{reason}`` increment) when every attempt
    failed, so a dark rail or a crashing lowering skips ONE record
    instead of killing the whole calibration cycle."""
    try:
        return policy.run(lambda: executor.measure(
            op, plan_name, payload_bytes, topo, **measure_kw))
    except ProbeTimeout:
        reason = "timeout"
    except Exception:                        # noqa: BLE001 — harden the cycle
        reason = "error"
    from . import metrics as _metrics
    _metrics.default_registry()["repro_probe_failures_total"].inc(
        reason=reason, fabric=topo.name)
    return None


def default_payloads(op: str, token_bytes: int = 7168) -> tuple:
    if op == "allgather":
        return ALLGATHER_SWEEP
    return tuple(b * token_bytes for b in DISPATCH_BATCH_SWEEP)


def link_class(topo: Topology, src: int, dst: int) -> str:
    """Fit class of one link: ``intra`` (same server / all of a full
    mesh) or ``inter`` (rail)."""
    return ("intra" if topo.server_of(src) == topo.server_of(dst)
            else "inter")


def link_role(topo: Topology, src: int, dst: int) -> str:
    """Directed fit ROLE of one link: ``intra``, or one role per ordered
    server pair for rails (``inter:0>1`` vs ``inter:1>0``).  Roles are
    the per-link refinement of :func:`link_class`: on an asymmetric
    fabric like ``2x8asym`` the two rail directions carry different
    bandwidths, and a class-level fit would collapse both onto one
    "inter" line — per-role regression keeps each direction's slope."""
    sa, sb = topo.server_of(src), topo.server_of(dst)
    if sa == sb:
        return "intra"
    return f"inter:{sa}>{sb}"


def _ledger_group_bytes(ledger: plan_ir.Ledger, group_fn) -> dict:
    out: dict = {}
    for (a, b), v in ledger.link_bytes.items():
        g = group_fn(ledger.topo, a, b)
        out[g] = max(out.get(g, 0.0), float(v))
    return out


def ledger_class_bytes(ledger: plan_ir.Ledger) -> dict:
    """Max per-link bytes per link class — the regressors the fitter
    uses (the bottleneck-link term of the latency model is a max, so the
    heaviest link of each class is the right x value)."""
    out = {"intra": 0.0, "inter": 0.0}
    out.update(_ledger_group_bytes(ledger, link_class))
    return out


def ledger_role_bytes(ledger: plan_ir.Ledger) -> dict:
    """Max per-link bytes per directed link ROLE (see :func:`link_role`)
    — the per-direction regressors that keep asymmetric fabrics'
    forward/return rails on separate fit lines."""
    return _ledger_group_bytes(ledger, link_role)


# ---------------------------------------------------------------------------
# simulated execution backend (injectable ground truth)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class GroundTruth:
    """What the fabric ACTUALLY delivers, hidden from the planner.

    ``link_bw`` overrides true per-link bandwidths (sorted tuple, like
    ``HardwareModel.link_bw``); ``noise`` is a lognormal sigma applied to
    every measurement (run-to-run jitter); ``dead_links`` are directed
    links that are ACTUALLY dark — any probe whose ledger charges one
    times out (:class:`ProbeTimeout`) instead of returning a number,
    exactly what a blacked-out rail does to a live prober.  The planner
    never sees this object — only the probe's measured times.
    """

    hw: HardwareModel = DEFAULT
    link_bw: tuple = ()
    noise: float = 0.0
    seed: int = 0
    dead_links: tuple = ()

    def true_hw(self) -> HardwareModel:
        if not self.link_bw:
            return self.hw
        return self.hw.recalibrated({"links": dict(self.link_bw)})

    def with_links(self, links: Mapping) -> "GroundTruth":
        merged = dict(self.link_bw)
        merged.update({tuple(k): float(v) for k, v in dict(links).items()})
        return dataclasses.replace(self,
                                   link_bw=tuple(sorted(merged.items())))

    def degraded(self, topo: Topology, factor: float,
                 which: str = "inter") -> "GroundTruth":
        """Truth with every ``which``-class link of ``topo`` delivering
        ``factor``x less bandwidth than it currently does — the long-term
        stress-test scenario (§6: deployed links drift off datasheet)."""
        cur = dict(self.link_bw)
        links = {}
        for key, ln in topo.links.items():
            if link_class(topo, *key) == which:
                links[key] = cur.get(key, ln.bw) / float(factor)
        return self.with_links(links)

    def with_dead(self, links) -> "GroundTruth":
        """Truth with ``links`` (directed ``(src, dst)`` pairs) fully
        dark — the scripted rail blackout of the failure-events soak."""
        dead = set(self.dead_links)
        dead.update((int(a), int(b)) for a, b in links)
        return dataclasses.replace(self, dead_links=tuple(sorted(dead)))


class SimProbe:
    """Simulation executor: scores the plan's ledger under the ground
    truth (+ lognormal noise).  Same ``measure`` protocol as LiveProbe,
    so the monitor is executor-agnostic."""

    source = "sim"

    def __init__(self, truth: GroundTruth = GroundTruth()) -> None:
        self.truth = truth
        self._rng = np.random.default_rng(truth.seed)

    def measure(self, op: str, plan_name: str, payload_bytes: float,
                topo: Topology, *, ledger: Optional[plan_ir.Ledger] = None,
                knobs: Optional[dict] = None, **scenario_kw) -> float:
        if ledger is None:
            plan = plan_ir.get_plan(op, plan_name)
            scenario = Planner._scenario(op, topo, scenario_kw)
            ledger = plan.simulate(scenario, payload_bytes, **(knobs or {}))
        if self.truth.dead_links:
            dead = set(self.truth.dead_links)
            for key in ledger.link_bytes:
                if key in dead:
                    raise ProbeTimeout(
                        f"{op}/{plan_name} probe crossed dark link "
                        f"{key[0]}->{key[1]}")
        t = score_ledger(ledger, self.truth.true_hw())
        if self.truth.noise:
            t *= float(np.exp(self._rng.normal(0.0, self.truth.noise)))
        return float(t)


# ---------------------------------------------------------------------------
# live execution backend (times the real lowerings on the mesh)
# ---------------------------------------------------------------------------

class LiveProbe:
    """Times the executable lowerings of registered plans on a live rank
    mesh.

    ``mesh`` is a :class:`~repro_torch.parallel.mesh.RankMesh`;
    ``axis_name`` carries the AllGather, ``ep_axis`` (and the optional
    ``pod_axis``) the MoE dispatch/combine and the directed link probe.
    ``device`` is where the probe's tensors live (None: CUDA, raising
    without one; pass "cpu" for gloo ranks on the host).

    Every rank of the mesh calls :meth:`measure` with the same arguments
    and returns the same float: each repeat starts after an agreement
    step over the whole mesh (an ``all_reduce`` of a failure flag, which
    is also the barrier) and a device synchronisation, the walls of all
    calls are reduced to the slowest rank's in one ``all_reduce(MAX)``,
    and the result is the min over ``repeats`` of those, after
    ``warmup`` calls (at least one: it pays the kernels' build and the
    allocator).  A call that raises on any rank, or runs past
    ``timeout_s`` at the slowest rank, raises on every rank together
    (:class:`ProbeTimeout` for the deadline), so the retry policy and
    ``measure_safely`` take the same path everywhere and no rank is left
    waiting in a collective.

    The MoE probe sends the bytes its ledger charges: ``token_bytes`` a
    token as bf16 rows of ``token_bytes // 2`` columns (on CUDA tensors
    each pack is the ``dispatch_pack`` kernel).
    """

    source = "live"

    def __init__(self, mesh, *, axis_name: str = "model",
                 ep_axis: str = "data", pod_axis: Optional[str] = None,
                 repeats: int = 3, warmup: int = 1,
                 timeout_s: Optional[float] = None, device=None) -> None:
        from repro_torch.device import resolve_device
        self.mesh = mesh
        self.axis_name = axis_name
        self.ep_axis = ep_axis
        self.pod_axis = pod_axis
        self.repeats = int(repeats)
        self.warmup = int(warmup)
        self.timeout_s = timeout_s
        self.device = resolve_device(device)

    def _sync(self) -> None:
        import torch
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _max(self, values):
        """``values`` (float64) at their max over every rank of the mesh;
        the reduction rides on the device nccl needs, on the host over
        gloo."""
        import torch
        import torch.distributed as dist
        if not dist.is_initialized():
            return values
        dev = (self.device if dist.get_backend() == "nccl"
               else torch.device("cpu"))
        t = values.to(dev)
        dist.all_reduce(t, op=dist.ReduceOp.MAX)
        return t.cpu()

    def _time(self, build) -> float:
        """``build()`` makes the inputs and returns the call to time; the
        min over repeats of the slowest rank's blocked wall, under the
        soft per-probe deadline (see the class docstring)."""
        import torch
        calls = max(1, self.warmup) + max(1, self.repeats)
        walls = torch.full((calls,), float("inf"), dtype=torch.float64)
        failed = None
        try:
            with torch.inference_mode():
                fn = build()
        except Exception as e:              # noqa: BLE001 — agreed below
            failed = e
        for i in range(calls):
            flag = torch.tensor([float(failed is not None)],
                                dtype=torch.float64)
            if self._max(flag).item():
                break
            self._sync()
            try:
                t0 = time.perf_counter()
                with torch.inference_mode():
                    fn()
                self._sync()
                walls[i] = time.perf_counter() - t0
            except Exception as e:          # noqa: BLE001 — agreed below
                failed = e
        agreed = self._max(torch.cat([
            walls, torch.tensor([float(failed is not None)],
                                dtype=torch.float64)]))
        if agreed[-1].item():
            if failed is not None:
                raise failed
            raise RuntimeError("probe failed on another rank of the mesh")
        worst = float(agreed[:-1].max())
        if self.timeout_s is not None and worst > self.timeout_s:
            raise ProbeTimeout(
                f"probe took {worst:.3f}s > deadline {self.timeout_s:.3f}s")
        return float(agreed[max(1, self.warmup):-1].min())

    def measure(self, op: str, plan_name: str, payload_bytes: float,
                topo: Topology, *, ledger=None,
                knobs: Optional[dict] = None, **scenario_kw) -> float:
        if op == "allgather":
            return self._measure_allgather(plan_name, payload_bytes,
                                           knobs or {})
        if op == "linkprobe":
            return self._measure_linkprobe(payload_bytes, scenario_kw)
        return self._measure_moe(op, plan_name, payload_bytes, scenario_kw)

    def _measure_linkprobe(self, payload_bytes: float,
                           scenario_kw: dict) -> float:
        """Directed point-to-point transfer: every rank of the source
        server block sends its buffer to the same-index rank of the
        destination block — one direction's rails carry traffic, nothing
        else does.  Server blocks come from the mesh: the pod axis when
        present, else the ep axis split into two halves."""
        import torch
        src = int(scenario_kw.get("src_server", 0))
        dst = int(scenario_kw.get("dst_server", 1))
        if self.pod_axis:
            axis = self.pod_axis
            n_servers = self.mesh.axis_size(self.pod_axis)
            per = 1
        else:
            axis, n_servers = self.ep_axis, 2
            per = self.mesh.axis_size(self.ep_axis) // 2
        src %= n_servers
        dst %= n_servers
        if per < 1 or src == dst and n_servers > 1:
            dst = (src + 1) % n_servers
        perm = [(src * per + i, dst * per + i) for i in range(max(1, per))]
        if "src_node" in scenario_kw and "dst_node" in scenario_kw:
            # single-rail probe (the failure detector's granularity):
            # exactly one ordered rank pair carries traffic
            total = n_servers * max(1, per)
            perm = [(int(scenario_kw["src_node"]) % total,
                     int(scenario_kw["dst_node"]) % total)]
        feat = 64
        rows = max(1, int(payload_bytes) // (4 * feat))

        def build():
            x = torch.zeros((rows, feat), dtype=torch.float32,
                            device=self.device)
            return lambda: self.mesh.ppermute(x, axis, perm)
        return self._time(build)

    def _measure_allgather(self, plan_name: str, payload_bytes: float,
                           knobs: dict) -> float:
        import torch

        from repro_torch.core import collectives as cl

        plan = plan_ir.get_plan("allgather", plan_name)
        if not plan.executable:
            raise ValueError(f"plan {plan_name!r} has no lowering to time")
        kw = plan.shard_map_kwargs(**{**plan.default_knobs(), **knobs})
        feat = 64
        rows = max(1, int(payload_bytes) // (4 * feat))

        def build():
            x = torch.zeros((rows, feat), dtype=torch.float32,
                            device=self.device)
            if kw.get("mode") is None:
                return lambda: cl.allgather_reference(x, self.mesh,
                                                      self.axis_name)
            return lambda: cl.multiwrite_allgather(
                x, self.mesh, self.axis_name, mode=kw["mode"],
                split=kw["split"])
        return self._time(build)

    def _measure_moe(self, op: str, plan_name: str, payload_bytes: float,
                     scenario_kw: dict) -> float:
        import torch

        from repro_torch.core import collectives as cl

        plan = plan_ir.get_plan(op, plan_name)
        kw = plan.shard_map_kwargs()
        scheme = kw.get("moe_scheme") or kw.get("moe_combine") or "baseline"
        p = self.mesh.axis_size(self.pod_axis) if self.pod_axis else 1
        d = self.mesh.axis_size(self.ep_axis)
        ranks = p * d
        top_k = int(scenario_kw.get("top_k", 8))
        per_rank = max(1, int(scenario_kw.get("num_experts", 64)) // ranks)
        num_experts = per_rank * ranks
        top_k = min(top_k, num_experts)
        token_bytes = int(scenario_kw.get("token_bytes", 7168))
        # the ledger charges token_bytes a token: bf16 rows of that size
        h = max(8, token_bytes // 2)
        n_per_rank = max(1, int(payload_bytes) // token_bytes)
        epmesh = cl.EPMesh(pod_axis=self.pod_axis if p > 1 else None,
                           ep_axis=self.ep_axis, num_pods=p, ep_per_pod=d,
                           ranks=self.mesh)
        dcfg = cl.DispatchConfig(num_experts=num_experts, top_k=top_k,
                                 pod_capacity=min(1.0, 2.0 * top_k / p),
                                 ep_capacity=min(1.0, 2.0 * (top_k / p) / d),
                                 expert_capacity=1.0)
        axes = ((self.pod_axis, self.ep_axis) if epmesh.pod_axis
                else (self.ep_axis,))
        time_combine = op == "combine"

        def build():
            gen = torch.Generator(device=self.device)
            gen.manual_seed(self.mesh.axis_index(*axes))
            tok = torch.randn((n_per_rank, h), generator=gen,
                              device=self.device).to(torch.bfloat16)
            lg = torch.randn((n_per_rank, num_experts), generator=gen,
                             device=self.device)

            def body():
                gates, ids = cl.route_topk(lg, top_k)
                if scheme == "hierarchical":
                    exp_tok, exp_gate, st = cl.hierarchical_dispatch(
                        tok, ids, gates, dcfg, epmesh)
                    if time_combine:
                        return cl.hierarchical_combine(exp_tok, exp_gate, st)
                else:
                    exp_tok, exp_gate, st = cl.baseline_dispatch(
                        tok, ids, gates, dcfg, epmesh)
                    if time_combine:
                        return cl.baseline_combine(exp_tok, exp_gate, st)
                return exp_tok
            return body
        return self._time(build)


# ---------------------------------------------------------------------------
# the sweep
# ---------------------------------------------------------------------------

def attributed_bottleneck(ledger: plan_ir.Ledger,
                          hw: Optional[HardwareModel]) -> tuple[int, int]:
    """Bottleneck link of a ledger under the MEASURED per-link
    bandwidths (``hw.link_bw``), falling back to the topology's nominal
    ones where no measurement exists.

    This is the per-role fit-attribution fix (ROADMAP): under a
    single-direction degradation the nominal-bandwidth argmax ties
    between the two rail directions and can attribute a slow-direction
    record to the healthy reverse role, dragging BOTH role fits down and
    re-tripping drift every cycle.  Attributing under the fitted model
    (available from the first recalibration on) pins the record to the
    direction that actually bottlenecked it, so the churn stops after
    one recalibration.  Ties break toward the smaller link key for
    determinism."""
    measured = dict(hw.link_bw) if hw is not None and hw.link_bw else {}
    best_key, best_t = None, -1.0
    for key, nbytes in sorted(ledger.link_bytes.items()):
        bw = measured.get(key, ledger.topo.link(*key).bw)
        t = nbytes / bw
        if t > best_t:
            best_key, best_t = key, t
    return best_key


def probe_record(op: str, plan: plan_ir.CollectivePlan, payload_bytes: float,
                 topo: Topology, measured_s: float, predicted_s: float,
                 ledger: plan_ir.Ledger, source: str,
                 knobs: Optional[dict] = None,
                 hw: Optional[HardwareModel] = None) -> dict:
    """One schema-versioned store record for a timed plan execution.
    Pass the planner's current ``hw`` so the bottleneck class/role is
    attributed under measured link bandwidths (see
    :func:`attributed_bottleneck`); without it attribution falls back to
    the topology's nominal bandwidths."""
    cls_bytes = ledger_class_bytes(ledger)
    bsrc, bdst = attributed_bottleneck(ledger, hw)
    return {
        "schema": SCHEMA_VERSION,
        "ts": time.time(),
        "fabric": topo_key(topo),
        "fabric_name": topo.name,
        "op": op,
        "plan": plan.name,
        "knobs": dict(knobs or plan.default_knobs()),
        "payload_bytes": float(payload_bytes),
        "bucket": bucket_payload(payload_bytes),
        "predicted_s": float(predicted_s),
        "measured_s": float(measured_s),
        "bottleneck_link": [int(bsrc), int(bdst)],
        "bottleneck_class": link_class(topo, bsrc, bdst),
        "bottleneck_role": link_role(topo, bsrc, bdst),
        "class_bytes": cls_bytes,
        "role_bytes": ledger_role_bytes(ledger),
        "stages": int(ledger.stages),
        "relayed": bool(ledger.relayed),
        "source": source,
    }


def probe_sweep(topo: Topology, executor, *,
                ops: Sequence[str] = DEFAULT_OPS,
                plans: Optional[Sequence[str]] = None,
                payloads: Optional[Mapping[str, Sequence[float]]] = None,
                hw: HardwareModel = DEFAULT,
                token_bytes: int = 7168,
                policy: ProbePolicy = DEFAULT_POLICY,
                **scenario_kw) -> list[dict]:
    """Time every registered plan of every op over a payload sweep.

    ``hw`` is the calibration the PREDICTED times are scored under (pass
    the planner's current model so record drift reflects model error);
    the executor supplies the measured side.  Probes run under
    ``policy`` (bounded retry + backoff): a probe that still fails is
    counted and SKIPPED — no record — so a dark rail never crashes the
    cycle or poisons the store.  Returns store-ready records.
    """
    records: list[dict] = []
    kw = dict(scenario_kw)
    kw.setdefault("token_bytes", token_bytes)
    for op in ops:
        sweep = (payloads or {}).get(op) if payloads else None
        if sweep is None:
            sweep = default_payloads(op, token_bytes)
        live = getattr(executor, "source", "") == "live"
        for plan in plan_ir.plans_for(op, executable_only=live):
            if plans is not None and plan.name not in plans:
                continue
            scenario = Planner._scenario(op, topo, kw)
            knobs = plan.default_knobs()
            for payload in sweep:
                ledger = plan.simulate(scenario, payload, **knobs)
                predicted = score_ledger(ledger, hw)
                measured = measure_safely(
                    executor, op, plan.name, payload, topo, policy=policy,
                    ledger=ledger, knobs=knobs, **kw)
                if measured is None:
                    continue
                records.append(probe_record(
                    op, plan, payload, topo, measured, predicted, ledger,
                    getattr(executor, "source", "unknown"), knobs, hw=hw))
    return records


# payload sweep of the directed rail microbenchmark: enough distinct
# points to clear the fitter's confidence floor per direction
DIRECTION_SWEEP = (256 << 10, 1 << 20, 4 << 20, 16 << 20)


def probe_link_directions(topo: Topology, executor, *,
                          payloads: Sequence[float] = DIRECTION_SWEEP,
                          hw: HardwareModel = DEFAULT,
                          policy: ProbePolicy = DEFAULT_POLICY) -> list[dict]:
    """Directed point-to-point microbenchmark of every ordered server
    pair that has rails (the "linkprobe"/"p2p" plan).

    The collective probe sweeps only ever regress a direction that
    BOTTLENECKS some plan — on an asymmetric fabric the fast forward
    rails never do, so they stayed nominal forever (ROADMAP debt).
    These records bottleneck on exactly one direction by construction,
    so ``fit_link_roles`` gets a payload sweep for every direction and
    the fitted model covers both sides of an asymmetric fabric."""
    plan = plan_ir.get_plan("linkprobe", "p2p")
    pairs = sorted({(topo.server_of(a), topo.server_of(b))
                    for (a, b) in topo.links
                    if topo.server_of(a) != topo.server_of(b)})
    records: list[dict] = []
    for sa, sb in pairs:
        scenario = plan_ir.LinkProbeScenario(topo, sa, sb)
        for payload in payloads:
            ledger = plan.simulate(scenario, payload)
            predicted = score_ledger(ledger, hw)
            measured = measure_safely(
                executor, "linkprobe", "p2p", payload, topo, policy=policy,
                ledger=ledger, knobs={}, src_server=sa, dst_server=sb)
            if measured is None:
                continue
            records.append(probe_record(
                "linkprobe", plan, payload, topo, measured, predicted,
                ledger, getattr(executor, "source", "unknown"), {}, hw=hw))
    return records
