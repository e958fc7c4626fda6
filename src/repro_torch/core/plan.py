"""Collective-plan IR: one uniform description of a collective scheme.

Before this module the repo had three disconnected descriptions of the
same collective — free-function simulator schedules (schedules.py),
closed-form latency entries (latency_model.ALLGATHER_LINK_LOAD) and
hard-coded shard_map kwargs at every JAX call site.  A
:class:`CollectivePlan` unifies them:

  * ``name`` / ``op``      — identity in the plan registry;
  * ``knobs``              — the declared tunables (``split``, ``mode``,
                             ``microbatch``) with candidate grids, seeded
                             by the §5.2 analytic optimum
                             (:func:`repro_torch.core.schedules.optimal_split`);
  * ``simulate(scenario, payload_bytes, **knobs) -> Ledger``
                           — drives the :class:`MultiWriteSimulator`
                             packet oracle at a small probe size and
                             scales the per-link byte ledger to the real
                             payload (the ledger is linear in payload
                             bytes for every scheme in the paper);
  * ``shard_map_kwargs(**knobs)``
                           — what the JAX layer needs to execute the
                             winning plan (``mode=``/``split=`` for the
                             §3.1 AllGather, ``moe_scheme`` for §3.2
                             dispatch).

The registry is the extension point: a new topology or scheme in a later
PR is ONE ``register_plan`` call — the planner, the benchmarks and the
JAX layer pick it up without edits (the TACCL-style "synthesis from a
cost model" architecture, arXiv 2305.13479).

:class:`~repro_torch.core.planner.Planner` sweeps registered plans x knob
grids and scores each ledger with the calibrated latency model.
"""

from __future__ import annotations

import dataclasses
import hashlib
import itertools
import math
from typing import Callable, Iterator, Mapping, Optional, Sequence

from .multiwrite import MultiWriteSimulator
from .topology import Topology


# ---------------------------------------------------------------------------
# bucketing helpers (shared by the planner's LRU keys and the declarative
# CollectiveSite keys, so a bound ExecutionPlan and a trace-time lookup
# can never disagree about which cell a payload falls into)
# ---------------------------------------------------------------------------

def bucket_payload(payload_bytes: float) -> int:
    """Power-of-two payload bucket: plan choice is scored at the bucket
    size, so nearby payloads share one cache entry."""
    if payload_bytes <= 1:
        return 1
    return 1 << int(math.ceil(math.log2(float(payload_bytes))))


def batch_bucket(batch: int) -> int:
    """Power-of-two decode-batch bucket — the serving tier's admission
    granularity.  Batch-bucket plans are planned and prefetched at these
    sizes, so growing the decode batch WITHIN a bucket never re-plans
    and growing it ACROSS a bucket boundary is a staged
    ``PlanBinder`` pointer flip rather than a cold retrace."""
    if batch <= 1:
        return 1
    return 1 << int(math.ceil(math.log2(float(batch))))


def bucket_compute_s(compute_s: float) -> float:
    """Power-of-two bucket (in nanoseconds) for the overlap-context
    compute time, mirroring :func:`bucket_payload`: nearby compute
    estimates share one scenario cache entry instead of fragmenting the
    LRU per traced dtype/shape.  Rounded to the NEAREST power of two in
    log space (not up): the bucketed value is baked into the decision's
    serial/ideal endpoints that fit_overlap_eff measures against, and a
    systematically inflated compute stage would bias the fitted
    efficiency upward."""
    if compute_s <= 0:
        return 0.0
    return float(2.0 ** round(math.log2(compute_s * 1e9))) / 1e9


# ---------------------------------------------------------------------------
# Ledger: the scored artifact of a simulated plan
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Ledger:
    """Per-link / per-relay byte accounting for one executed plan.

    ``link_bytes``   (src, dst) -> bytes carried (incl. §4.1 metadata).
    ``relay_bytes``  node -> rx+tx bytes moved as a relay (§6.4 AICPU
                     copy/forward cost).
    ``flow_counts``  (src, dst) -> distinct concurrent flows (drives the
                     unicast-multipath interference derate).
    ``stages``       schedule chunks (microbatching = ``stages`` chunks),
                     each paying the operator startup alpha.
    ``overlap``      chunks are SOFTWARE-PIPELINED (dispatch of chunk k+1
                     overlaps compute of chunk k and combine of chunk
                     k-1): scoring pays ``max(stage) + (G-1)*bottleneck``
                     derated by the calibrated overlap efficiency instead
                     of the serial ``G*sum`` — the Fig 8 relay-pipeline
                     idea applied across whole chunks.  False = the
                     chunks serialize (the pre-pipeline ``lax.map`` loop).
    ``compute_s``    per-full-payload compute time (expert FFN) the
                     pipelined network chunks hide behind — the stage
                     BETWEEN dispatch and combine.  Charged to serial
                     scores too so G==1 and G>1 compare apples-to-apples.
    ``relayed``      whether any relay stage exists (pays ``alpha_hop``).
    ``alpha_extra_s``  schedule-specific fixed setup beyond the generic
                     alphas (the Fig 8 relay pipeline establishment).
    ``engine_serial``  node -> egress bytes that serialize through ONE
                     forwarding engine (§6.4 AICPU software relay).
                     Populated only by plans whose relays forward in
                     software (MoE dispatch); hardware-parallel relays
                     (§3.1 paired relaying over distinct links) leave it
                     empty.  Scored at the node's fastest egress link.
    """

    topo: Topology
    link_bytes: Mapping[tuple[int, int], float]
    relay_bytes: Mapping[int, float]
    flow_counts: Mapping[tuple[int, int], int]
    stages: int = 1
    overlap: bool = False
    compute_s: float = 0.0
    relayed: bool = False
    alpha_extra_s: float = 0.0
    engine_serial: Mapping[int, float] = dataclasses.field(
        default_factory=dict)

    @classmethod
    def from_sim(cls, sim: MultiWriteSimulator, stages: int = 1,
                 alpha_extra_s: float = 0.0) -> "Ledger":
        flows: dict[tuple[int, int], set[int]] = {}
        for rec in sim.trace:
            flows.setdefault((rec.src, rec.dst), set()).add(rec.dest_bitmap)
        return cls(topo=sim.topo,
                   link_bytes=dict(sim.link_bytes),
                   relay_bytes=dict(sim.relay_bytes),
                   flow_counts={k: len(v) for k, v in flows.items()},
                   stages=stages,
                   relayed=bool(sim.relay_bytes),
                   alpha_extra_s=alpha_extra_s)

    def scaled(self, factor: float) -> "Ledger":
        """Ledger for a payload ``factor`` x larger (bytes are linear in
        payload size; flow structure is size-independent)."""
        if factor == 1.0:
            return self
        return dataclasses.replace(
            self,
            link_bytes={k: v * factor for k, v in self.link_bytes.items()},
            relay_bytes={k: v * factor for k, v in self.relay_bytes.items()},
            engine_serial={k: v * factor
                           for k, v in self.engine_serial.items()})

    @property
    def bottleneck_link(self) -> tuple[tuple[int, int], float]:
        key = max(self.link_bytes,
                  key=lambda k: self.link_bytes[k] / self.topo.link(*k).bw)
        return key, self.link_bytes[key]

    def total_bytes(self) -> float:
        return float(sum(self.link_bytes.values()))


# ---------------------------------------------------------------------------
# Scenarios: the static context a plan runs against
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class AllGatherScenario:
    """§3.1 split-TP AllGather: ``domains`` partition ``topo``'s nodes."""

    topo: Topology
    domains: tuple[tuple[int, ...], ...]

    @classmethod
    def split_tp(cls, topo: Topology,
                 num_domains: int = 2) -> "AllGatherScenario":
        n = topo.num_nodes
        tp = n // num_domains
        doms = tuple(tuple(range(i, i + tp)) for i in range(0, n, tp))
        return cls(topo=topo, domains=doms)

    def cache_key(self):
        return ("allgather", self.domains)


@dataclasses.dataclass(frozen=True)
class DispatchScenario:
    """§3.2 MoE AlltoAll dispatch over an oversubscribed cluster.

    ``skew`` prices non-uniform (hot-expert) routing: 0 = balanced
    (paper §6.1 "expert load balancing is enabled"); larger values draw
    expert choices from a Zipf-like popularity law, concentrating
    traffic on the hot experts' owners — the imbalanced-MoE regime the
    planner must price for production routers.

    ``compute_s`` is the overlap context: the expert-FFN time (for the
    FULL payload) a chunked dispatch can hide behind.  0 = score the
    dispatch in isolation (the pre-overlap model — ``microbatch > 1``
    can then never win and the planner keeps G == 1)."""

    topo: Topology
    num_experts: int = 64
    top_k: int = 8
    token_bytes: int = 7168
    seed: int = 0
    skew: float = 0.0
    compute_s: float = 0.0

    def cache_key(self):
        return ("dispatch", self.num_experts, self.top_k, self.token_bytes,
                self.skew, self.compute_s)


@dataclasses.dataclass(frozen=True)
class CombineScenario:
    """Return path of the MoE AlltoAll: expert partials travel back to the
    token owners (the dual of :class:`DispatchScenario`).  The paper plans
    only the dispatch half; combine is a first-class op here because the
    return path hits the same physical bottleneck — or, on asymmetric
    fabrics, a *different* one."""

    topo: Topology
    num_experts: int = 64
    top_k: int = 8
    token_bytes: int = 7168
    seed: int = 0
    skew: float = 0.0          # hot-expert routing skew (see DispatchScenario)
    compute_s: float = 0.0     # overlap context (see DispatchScenario)

    def cache_key(self):
        return ("combine", self.num_experts, self.top_k, self.token_bytes,
                self.skew, self.compute_s)


@dataclasses.dataclass(frozen=True)
class LinkProbeScenario:
    """Directed point-to-point microbenchmark: every rail link from
    ``src_server`` to ``dst_server`` carries the payload simultaneously
    (the telemetry probe that fits a direction which NEVER bottlenecks
    any real collective — 2x8asym forward rails — instead of leaving it
    nominal).  ``src_server == dst_server`` probes the server's intra
    full mesh."""

    topo: Topology
    src_server: int = 0
    dst_server: int = 1

    def cache_key(self):
        return ("linkprobe", self.src_server, self.dst_server)


@dataclasses.dataclass(frozen=True)
class ReduceScenario:
    """Gradient synchronization over the data-parallel replicas: every
    node holds a full gradient of ``payload_bytes`` and the collective
    produces the elementwise sum — on every node for ``allreduce``, as
    1/R shards for ``reduce_scatter``.

    ``compute_s`` is the overlap context: the BACKWARD-pass compute time
    remaining when gradient sync of this payload can start.  Gradient
    buckets become ready back-to-front as the backward pass proceeds, so
    a chunked (microbatch > 1) sync overlaps earlier chunks' wire time
    with later layers' backward compute — the same pipelined scoring
    mode the MoE dispatch path uses.  0 = score the sync in isolation
    (G == 1 always wins then: per-chunk alpha with nothing to hide
    behind)."""

    topo: Topology
    compute_s: float = 0.0

    def cache_key(self):
        return ("reduce", self.compute_s)


def default_scenarios(topo: Topology) -> dict:
    """One representative scenario per op for ``topo`` — the grid the CI
    fabric smoke iterates (every registered plan must simulate on every
    registered fabric without raising)."""
    return {"allgather": AllGatherScenario.split_tp(topo, 2),
            "dispatch": DispatchScenario(topo=topo),
            "combine": CombineScenario(topo=topo),
            "linkprobe": LinkProbeScenario(
                topo, 0, 1 if topo.meta.num_servers > 1 else 0),
            "allreduce": ReduceScenario(topo=topo),
            "reduce_scatter": ReduceScenario(topo=topo)}


# ---------------------------------------------------------------------------
# The plan IR
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class CollectivePlan:
    """One registered collective scheme with declared knobs.

    ``simulate_fn(scenario, payload_bytes, **knobs) -> Ledger`` is the
    semantic oracle; ``kwargs_fn(**knobs)`` produces the JAX-layer kwargs
    of the winning configuration.  ``executable`` marks plans that have a
    shard_map lowering (unicast multipath exists only as a paper
    comparison point, so the planner excludes it when asked for an
    executable choice).
    """

    name: str
    op: str                            # "allgather" | "dispatch" | "combine"
    knobs: Mapping[str, tuple]                # knob -> candidate grid
    simulate_fn: Callable[..., Ledger]
    kwargs_fn: Callable[..., dict] = lambda **kw: dict(kw)
    executable: bool = True

    def knob_grid(self) -> Iterator[dict]:
        if not self.knobs:
            yield {}
            return
        names = sorted(self.knobs)
        for combo in itertools.product(*(self.knobs[k] for k in names)):
            yield dict(zip(names, combo))

    def default_knobs(self) -> dict:
        return {k: v[0] for k, v in self.knobs.items()}

    def simulate(self, scenario, payload_bytes: float, **knobs) -> Ledger:
        kn = {**self.default_knobs(), **knobs}
        return self.simulate_fn(scenario, float(payload_bytes), **kn)

    def shard_map_kwargs(self, **knobs) -> dict:
        kn = {**self.default_knobs(), **knobs}
        return self.kwargs_fn(**kn)


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

PLAN_REGISTRY: dict[tuple[str, str], CollectivePlan] = {}
BASELINE_PLAN = {"allgather": "baseline", "dispatch": "unicast",
                 "combine": "unicast",
                 # directed point-to-point link microbenchmark (telemetry):
                 # pure serialization, so its records feed the alpha/beta
                 # regression like the real baselines do
                 "linkprobe": "p2p",
                 # gradient sync: the flat bandwidth-optimal ring is what
                 # GSPMD lowers an unannotated psum to — the thing the
                 # smarter schemes must beat
                 "allreduce": "ring",
                 "reduce_scatter": "ring"}


def register_plan(plan: CollectivePlan) -> CollectivePlan:
    key = (plan.op, plan.name)
    PLAN_REGISTRY[key] = plan
    return plan


def get_plan(op: str, name: str) -> CollectivePlan:
    try:
        return PLAN_REGISTRY[(op, name)]
    except KeyError:
        raise KeyError(
            f"no plan {name!r} registered for op {op!r}; have "
            f"{sorted(n for o, n in PLAN_REGISTRY if o == op)}") from None


def plans_for(op: str, executable_only: bool = False
              ) -> list[CollectivePlan]:
    """Registered plans for ``op`` in registration order."""
    out = [p for (o, _), p in PLAN_REGISTRY.items() if o == op]
    if executable_only:
        out = [p for p in out if p.executable]
    return out


# ---------------------------------------------------------------------------
# Declarative collective programs (the bindable planning surface)
# ---------------------------------------------------------------------------
#
# A model's collectives used to be planned one call site at a time: every
# consumer asked ``ParallelContext.resolve_*`` for its own op at trace
# time, so coupled sites (the MoE dispatch and its return-path combine,
# which execute inside ONE chunk pipeline) could never be optimized
# together.  The declarative surface inverts that: callers REGISTER their
# sites up-front as a :class:`CollectiveProgram`, one
# ``Planner.plan_program`` sweep decides every site (coupled groups
# jointly, under the shared-pipeline scorer), and the resulting immutable
# :class:`ExecutionPlan` is bound into the ``ParallelContext`` — trace
# time is pure lookup.

@dataclasses.dataclass(frozen=True)
class CollectiveSite:
    """One declared collective call site of a model.

    ``op``        planner op ("allgather" | "dispatch" | "combine");
    ``role``      unique name within the program ("train/moe_dispatch");
    ``payload_bytes``  per-participant payload of the site;
    ``scenario_kw``    sorted (key, value) pairs completing the planner
                  scenario (num_experts / top_k / token_bytes /
                  num_domains);
    ``compute_ctx``    overlap context: the modeled compute time (expert
                  FFN) chunked transfers of this site hide behind;
    ``skew``      hot-expert routing skew the site is priced under;
    ``coupled_with``   role of the site sharing this site's chunk
                  pipeline (the MoE combine declares
                  ``coupled_with="…/moe_dispatch"``) — coupled groups are
                  swept jointly over one shared microbatch G;
    ``topo``      optional site-specific fabric (the split-TP AllGather
                  runs on the §3.1 full-mesh fixture, not the EP fabric).
    """

    op: str
    role: str
    payload_bytes: float
    scenario_kw: tuple = ()
    compute_ctx: float = 0.0
    skew: float = 0.0
    coupled_with: Optional[str] = None
    topo: Optional[Topology] = None

    @property
    def phase(self) -> str:
        """Phase prefix of the role ("train/grad_sync" -> "train"); sites
        sharing a phase execute concurrently and contend for links."""
        return self.role.partition("/")[0]

    def scenario_args(self) -> dict:
        """kwargs for ``Planner._scenario`` (skew/compute folded in)."""
        return {**dict(self.scenario_kw), "skew": self.skew,
                "compute_s": self.compute_ctx}

    def key(self) -> tuple:
        """Workload identity of the site — what a trace-time lookup can
        reconstruct from live shapes.  Deliberately excludes ``role``,
        ``coupled_with`` and ``topo``: the consumer inside ``shard_map``
        knows its op, payload and scenario, nothing else."""
        return (self.op, bucket_payload(self.payload_bytes),
                tuple(sorted(dict(self.scenario_kw).items())),
                float(self.skew), bucket_compute_s(self.compute_ctx))


def site_key(op: str, payload_bytes: float, *, skew: float = 0.0,
             compute_s: float = 0.0, **scenario_kw) -> tuple:
    """The :meth:`CollectiveSite.key` a trace-time consumer derives from
    its live quantities (one shared construction, so bind-time and
    trace-time keys cannot drift)."""
    return (op, bucket_payload(payload_bytes),
            tuple(sorted(scenario_kw.items())),
            float(skew), bucket_compute_s(compute_s))


def moe_sites(phase: str, *, num_experts: int, top_k: int,
              tokens_per_rank: int, token_bytes: int,
              skew: float = 0.0, compute_s: float = 0.0,
              topo: Optional[Topology] = None
              ) -> tuple[CollectiveSite, CollectiveSite]:
    """The canonical coupled (dispatch, combine) site pair of one MoE
    phase — both halves of the token round trip, declared as ONE group
    so the planner sweeps (dispatch scheme, combine scheme, shared G)
    jointly under the shared-pipeline scorer."""
    kw = (("num_experts", int(num_experts)), ("top_k", int(top_k)),
          ("token_bytes", int(token_bytes)))
    payload = float(tokens_per_rank) * token_bytes
    dispatch = CollectiveSite(
        op="dispatch", role=f"{phase}/moe_dispatch", payload_bytes=payload,
        scenario_kw=kw, compute_ctx=compute_s, skew=skew, topo=topo)
    combine = CollectiveSite(
        op="combine", role=f"{phase}/moe_combine", payload_bytes=payload,
        scenario_kw=kw, compute_ctx=compute_s, skew=skew,
        coupled_with=dispatch.role, topo=topo)
    return dispatch, combine


def allgather_site(phase: str, *, frag_bytes: float, num_domains: int = 2,
                   topo: Optional[Topology] = None) -> CollectiveSite:
    """The §3.1 split-TP AllGather site of one phase."""
    return CollectiveSite(
        op="allgather", role=f"{phase}/split_tp_gather",
        payload_bytes=float(frag_bytes),
        scenario_kw=(("num_domains", int(num_domains)),), topo=topo)


def grad_sync_site(phase: str, *, payload_bytes: float,
                   compute_s: float = 0.0,
                   topo: Optional[Topology] = None) -> CollectiveSite:
    """The per-step gradient AllReduce site of one training phase.

    Uncoupled: gradient sync shares no chunk pipeline with the MoE round
    trip (it runs after the backward pass produces each bucket), so
    ``plan_program`` sweeps it alone — but under the same pipelined
    scorer, with the tail of the backward pass as overlap context."""
    return CollectiveSite(
        op="allreduce", role=f"{phase}/grad_sync",
        payload_bytes=float(payload_bytes), compute_ctx=float(compute_s),
        topo=topo)


@dataclasses.dataclass(frozen=True)
class CollectiveProgram:
    """Every collective site a workload will issue, declared up-front.

    ``name`` identifies the launch surface ("train", "serve", "dryrun");
    sites carry their phase in the role prefix ("prefill/moe_dispatch").
    Roles must be unique; ``coupled_with`` references must resolve and
    must not chain (a group is one pipeline).

    ``phase_budgets`` optionally caps a phase's contention-aware latency
    (phase name -> seconds): a decode SLO declared here constrains the
    OTHER phases' plans during the joint sweep — their candidate
    combinations are rejected when their background traffic would push
    the budgeted phase past its cap (see ``Planner.plan_program``).
    """

    name: str
    sites: tuple[CollectiveSite, ...]
    phase_budgets: Mapping[str, float] = dataclasses.field(
        default_factory=dict)

    def __post_init__(self):
        phases = {s.phase for s in self.sites}
        for ph, budget in self.phase_budgets.items():
            if ph not in phases:
                raise ValueError(
                    f"budget for unknown phase {ph!r} in program "
                    f"{self.name!r}; have {sorted(phases)}")
            if not budget > 0:
                raise ValueError(
                    f"phase budget must be positive: {ph!r} -> {budget!r}")
        roles = [s.role for s in self.sites]
        if len(set(roles)) != len(roles):
            dup = sorted({r for r in roles if roles.count(r) > 1})
            raise ValueError(f"duplicate site roles in program "
                             f"{self.name!r}: {dup}")
        by_role = {s.role: s for s in self.sites}
        for s in self.sites:
            if s.coupled_with is None:
                continue
            anchor = by_role.get(s.coupled_with)
            if anchor is None:
                raise ValueError(
                    f"site {s.role!r} couples to unknown role "
                    f"{s.coupled_with!r}")
            if anchor.coupled_with is not None:
                raise ValueError(
                    f"coupling chains are not a pipeline: {s.role!r} -> "
                    f"{s.coupled_with!r} -> {anchor.coupled_with!r}")

    def site(self, role: str) -> CollectiveSite:
        for s in self.sites:
            if s.role == role:
                return s
        raise KeyError(f"no site {role!r} in program {self.name!r}; have "
                       f"{[s.role for s in self.sites]}")

    def groups(self) -> list[tuple[CollectiveSite, ...]]:
        """Sites partitioned into jointly-planned groups: each coupled
        pair (anchor, satellite) is one group, everything else plans
        alone.  Declaration order is preserved."""
        by_anchor: dict[str, list[CollectiveSite]] = {}
        for s in self.sites:
            if s.coupled_with is not None:
                by_anchor.setdefault(s.coupled_with, []).append(s)
        out: list[tuple[CollectiveSite, ...]] = []
        for s in self.sites:
            if s.coupled_with is not None:
                continue
            out.append((s, *by_anchor.get(s.role, [])))
        return out

    def phases(self) -> dict[str, list[tuple[CollectiveSite, ...]]]:
        """Jointly-planned groups partitioned by phase (declaration
        order preserved): groups within one phase execute concurrently
        and are scored under the merged phase ledger; distinct phases
        never overlap (except through an explicit budget constraint)."""
        out: dict[str, list[tuple[CollectiveSite, ...]]] = {}
        for group in self.groups():
            out.setdefault(group[0].phase, []).append(group)
        return out

    def cache_key(self) -> tuple:
        return (self.name,
                tuple(sorted(self.phase_budgets.items())),
                tuple((s.role, s.key(), s.coupled_with,
                       None if s.topo is None else s.topo.fingerprint())
                      for s in self.sites))


@dataclasses.dataclass(frozen=True)
class ExecutionPlan:
    """The planner's immutable verdict for one whole program.

    ``decisions``   role -> per-site PlanDecision (marginal view: the
                    site's own predicted/baseline times at the jointly
                    chosen configuration);
    ``joint``       group anchor role -> combined PlanDecision of the
                    coupled pipeline (op "dispatch+combine", merged
                    shard_map kwargs, joint serial/ideal endpoints — the
                    row step-time telemetry measures against);
    ``group_of``    role -> anchor role of its coupled group (anchors
                    map to themselves; uncoupled sites are absent).
    ``phase_report``  phase -> contention breakdown of the chosen
                    combination (solo/merged-wire/contention seconds,
                    budget verdict, per-phase search statistics).
    ``planner_stats``  whole-program sweep statistics (candidates
                    enumerated, combinations scored vs the exhaustive
                    product, search mode, planning wall-time).

    Bound into a :class:`~repro_torch.parallel.context.ParallelContext` via
    ``pctx.bind(plan)``; consumers resolve their site by
    :func:`site_key` lookup and execute the stored kwargs verbatim.
    """

    program: CollectiveProgram
    topo_fingerprint: tuple
    hw_fingerprint: tuple
    decisions: Mapping[str, object]
    joint: Mapping[str, object] = dataclasses.field(default_factory=dict)
    group_of: Mapping[str, str] = dataclasses.field(default_factory=dict)
    phase_report: Mapping[str, dict] = dataclasses.field(
        default_factory=dict)
    planner_stats: Mapping[str, object] = dataclasses.field(
        default_factory=dict)

    # -- identity ------------------------------------------------------------
    @property
    def fingerprint(self) -> str:
        """Stable content hash: program sites + fabrics + calibration +
        every chosen (plan, knobs).  Two plans with the same fingerprint
        execute identically; a re-plan that changes any decision changes
        the fingerprint (what launch surfaces log across recalibrations)."""
        parts = [repr(self.program.cache_key()),
                 repr(self.topo_fingerprint), repr(self.hw_fingerprint)]
        for role in sorted(self.decisions):
            d = self.decisions[role]
            parts.append(f"{role}={d.plan}{sorted(dict(d.knobs).items())}")
        return hashlib.sha1("|".join(parts).encode()).hexdigest()[:16]

    # -- lookup --------------------------------------------------------------
    def decision(self, role: str):
        try:
            return self.decisions[role]
        except KeyError:
            raise KeyError(
                f"no decision for role {role!r}; have "
                f"{sorted(self.decisions)}") from None

    def find_role(self, op: str, payload_bytes: float, *,
                  skew: float = 0.0, compute_s: float = 0.0,
                  **scenario_kw) -> Optional[str]:
        """Role of the site matching a trace-time workload, or None (the
        traced shape was not declared — consumers fall back to their
        policy default)."""
        key = site_key(op, payload_bytes, skew=skew, compute_s=compute_s,
                       **scenario_kw)
        for s in self.program.sites:
            if s.key() == key:
                return s.role
        return None

    def site_kwargs(self, role: str) -> dict:
        """The kwargs the consumer of ``role`` executes: the coupled
        group's merged kwargs when the site is part of one (dispatch
        scheme + combine scheme + the SHARED microbatch G), else the
        site's own decision kwargs."""
        anchor = self.group_of.get(role)
        if anchor is not None and anchor in self.joint:
            return dict(self.joint[anchor].shard_map_kwargs)
        return dict(self.decision(role).shard_map_kwargs)

    # -- reporting -----------------------------------------------------------
    def report(self) -> dict:
        out = {"program": self.program.name,
               "fingerprint": self.fingerprint,
               "sites": {}, "joint": {}}
        for role in sorted(self.decisions):
            out["sites"][role] = self.decisions[role].report()
        for anchor in sorted(self.joint):
            out["joint"][anchor] = self.joint[anchor].report()
        if self.phase_report:
            out["phases"] = {ph: dict(rep)
                             for ph, rep in self.phase_report.items()}
        if self.planner_stats:
            out["planner"] = dict(self.planner_stats)
        return out

    def summary(self) -> str:
        lines = [f"program {self.program.name} [{self.fingerprint}]"]
        done = set()
        for anchor, d in self.joint.items():
            lines.append(f"  {anchor} (+coupled): {d.summary()}")
            done.update(r for r, a in self.group_of.items() if a == anchor)
        for role in sorted(self.decisions):
            if role not in done:
                lines.append(f"  {role}: {self.decisions[role].summary()}")
        for ph, rep in self.phase_report.items():
            if rep.get("contention_s", 0.0) > 0 or rep.get("budget_s"):
                line = (f"  phase {ph}: {rep['score_s'] * 1e6:.0f}us"
                        f" (contention +{rep['contention_s'] * 1e6:.0f}us)")
                if rep.get("budget_s"):
                    verdict = "ok" if rep.get("budget_ok") else "VIOLATED"
                    line += (f", budget {rep['budget_s'] * 1e6:.0f}us"
                             f" {verdict}")
                lines.append(line)
        return "\n".join(lines)


@dataclasses.dataclass(frozen=True)
class PinnedDecision:
    """A hand-pinned site decision (no sweep behind it): what
    :func:`pinned_execution_plan` installs.  Mirrors the PlanDecision
    surface ExecutionPlan consumers touch (kwargs, knobs, report)."""

    op: str
    plan: str
    knobs: tuple
    shard_map_kwargs: Mapping
    predicted_s: float = 0.0
    baseline_s: float = 0.0
    predicted_serial_s: float = 0.0
    predicted_ideal_s: float = 0.0

    @property
    def microbatch(self) -> int:
        return int(dict(self.knobs).get("microbatch", 1))

    def report(self) -> dict:
        # same key schema as PlanDecision.report so report consumers
        # (serve.py's stats printout, dryrun tables) never branch on
        # whether a decision was swept or pinned
        return {"plan": self.plan, "knobs": dict(self.knobs),
                "pinned": True, "predicted_us": self.predicted_s * 1e6,
                "baseline_us": self.baseline_s * 1e6,
                "delta_vs_baseline_us":
                    (self.baseline_s - self.predicted_s) * 1e6,
                "speedup_pct": 0.0}

    def summary(self) -> str:
        kn = ", ".join(f"{k}={v}" for k, v in self.knobs)
        return f"{self.op}: pinned {self.plan}({kn})"


def pinned_execution_plan(program: CollectiveProgram,
                          kwargs_by_role: Mapping[str, Mapping]
                          ) -> ExecutionPlan:
    """An :class:`ExecutionPlan` with hand-pinned per-group kwargs — the
    operational override path (force a known-good configuration without
    a sweep) and the test fixture for bound-plan execution.

    ``kwargs_by_role`` maps each group ANCHOR role to the execution
    kwargs its consumers should get verbatim (for a coupled MoE pair:
    ``{"moe_scheme", "moe_combine", "microbatch"}``)."""
    decisions: dict = {}
    joint: dict = {}
    group_of: dict = {}
    for group in program.groups():
        anchor = group[0]
        kw = dict(kwargs_by_role[anchor.role])
        g = int(kw.get("microbatch", 1))
        if len(group) == 1:
            decisions[anchor.role] = PinnedDecision(
                op=anchor.op, plan="pinned",
                knobs=tuple(sorted(kw.items())), shard_map_kwargs=kw)
            continue
        joint[anchor.role] = PinnedDecision(
            op="+".join(s.op for s in group), plan="pinned",
            knobs=(("microbatch", g),), shard_map_kwargs=kw)
        for s in group:
            group_of[s.role] = anchor.role
            decisions[s.role] = PinnedDecision(
                op=s.op, plan="pinned", knobs=(("microbatch", g),),
                shard_map_kwargs=kw)
    return ExecutionPlan(program=program, topo_fingerprint=("pinned",),
                         hw_fingerprint=("pinned",), decisions=decisions,
                         joint=joint, group_of=group_of)


# ---------------------------------------------------------------------------
# probe-size helpers shared by plan implementations
# ---------------------------------------------------------------------------

PROBE_FRAG_BYTES = 1 << 14        # AllGather probe fragment (16 KiB)
PROBE_TOKEN_BYTES = 128           # dispatch probe token payload
PROBE_BATCH = 32                  # dispatch probe tokens per NPU


def probe_scale(payload_bytes: float, probe_bytes: float) -> float:
    return float(payload_bytes) / float(probe_bytes) if probe_bytes else 1.0
