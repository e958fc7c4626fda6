"""Parallelism context: the port of ``src/repro/parallel/context.py``'s
``ParallelContext`` and ``build_collective_program``.

A :class:`ParallelContext` travels with a model.  ``pctx=None`` means one
rank.  Axis roles over a :class:`~repro_torch.parallel.mesh.RankMesh`:

  pod    slow axis: data parallel, and the outer level of the MultiWrite
         hierarchical EP dispatch;
  data   fast axis: data parallel, and EP for MoE layers;
  model  tensor parallel (Megatron column/row over the heads and the FFN
         width, TP inside the experts), sequence parallel between blocks,
         the decode KV length; optionally divided into ``tp_subgroups``
         split-TP domains for the §3.1 MultiWrite AllGather.

The MoE round trip (dispatch scheme, return-path scheme and the pipeline
chunk count G) resolves as the reference resolves it: a bound
:class:`~repro_torch.core.plan.ExecutionPlan` first, then the planner under
``plan_policy="auto"``, then the declared knobs.  The planner scores on the
explicit ``fabric`` or, without one, on the reference's mesh-derived
topology, so that both packages give the same plans for the same inputs;
with a ``calibration`` store, under the store's fitted hardware model for
that topology instead of the datasheet constants.

:class:`PlanBinder` is a verbatim copy of the reference's (``repro.`` read
as ``repro_torch.``): the serving engine's double-buffered plan binding,
whose artifacts are the port's lowerings (``runtime/server.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.core.h100 import H100_BF16_PEAK_FLOPS, moe_compute_s
from repro_torch.parallel.mesh import RankMesh


@dataclasses.dataclass(frozen=True)
class ParallelContext:
    mesh: RankMesh
    pod_axis: Optional[str] = None    # None on a single-pod mesh
    data_axis: str = "data"
    model_axis: str = "model"
    plan_policy: str = "fixed"        # "auto": the planner picks the MoE
    #   round trip per workload; "fixed": the knobs below, verbatim
    moe_scheme: str = "hierarchical"  # hierarchical (MultiWrite) | baseline
    moe_combine: Optional[str] = None  # hierarchical | baseline | None =
    #                                    follow moe_scheme
    fabric: Optional[object] = None   # core.topology.Topology the planner
    #   scores on (--fabric); None = derived from the mesh shape.  It
    #   changes which plan wins, not where the exchanges run.
    calibration: Optional[object] = None  # telemetry CalibrationStore (or
    #   path): the planner scores on the store's fitted model for the
    #   planning topology instead of the datasheet (--calibrate)
    moe_skew: float = 0.0             # hot-expert routing skew the planner
    #                                   prices dispatch/combine under
    tp_subgroups: int = 1             # §3.1 split-TP domains on model axis
    seq_shard_decode: bool = True     # shard decode KV length over model
    seq_parallel: bool = True         # the residual's seq dim sharded over
    #                                   model between blocks
    moe_deferred_tp_reduce: bool = False  # one all_reduce over model after
    #   the combine instead of one per expert FFN
    moe_microbatch: int = 1           # dispatch chunks G under "fixed"
    fsdp: bool = True                 # shard weights over data (ZeRO-3)
    #   when training over more than one data rank
    #   (``parallel.sharding.shard_fsdp``); serving never does
    remat: str = "none"               # none | selective | full: recompute
    #   each block's activations in the backward (training); the reference
    #   defaults to "full", the port to none (the state of a full-width
    #   rank fits beside its activations)
    execution_plan: Optional[object] = None  # a bound
    #   core.plan.ExecutionPlan (install with ``pctx.bind(plan)``)
    _resolved: dict = dataclasses.field(default_factory=dict, init=False,
                                        repr=False, compare=False)

    def __post_init__(self):
        if self.plan_policy not in ("fixed", "auto"):
            raise ValueError(f"plan_policy {self.plan_policy!r}")
        if int(self.moe_microbatch) < 1:
            raise ValueError(f"moe_microbatch {self.moe_microbatch}")
        if int(self.tp_subgroups) < 1:
            raise ValueError(f"tp_subgroups {self.tp_subgroups}")
        if self.moe_scheme not in ("hierarchical", "baseline"):
            raise ValueError(f"moe_scheme {self.moe_scheme!r}")
        if self.moe_combine not in (None, "hierarchical", "baseline"):
            raise ValueError(f"moe_combine {self.moe_combine!r}")
        if self.pod_axis is None and self.mesh.axis_size("pod") != 1:
            raise ValueError("a mesh with pods needs pod_axis='pod'")
        if self.remat not in ("none", "selective", "full"):
            raise ValueError(f"remat {self.remat!r}")

    # -- derived -------------------------------------------------------------
    @property
    def dp_axes(self) -> tuple[str, ...]:
        return ((self.pod_axis, self.data_axis) if self.pod_axis
                else (self.data_axis,))

    @property
    def num_pods(self) -> int:
        return self.mesh.axis_size(self.pod_axis) if self.pod_axis else 1

    @property
    def data_size(self) -> int:
        return self.mesh.axis_size(self.data_axis)

    @property
    def model_size(self) -> int:
        return self.mesh.axis_size(self.model_axis)

    @property
    def dp_size(self) -> int:
        return self.mesh.axis_size(*self.dp_axes)

    @property
    def dp_index(self) -> int:
        """Which data-parallel rows are this rank's: pod * data + d."""
        return self.mesh.axis_index(*self.dp_axes)

    @property
    def dp_topology(self):
        """The data-parallel fabric the gradient sync is planned on (the
        ``grad_sync`` site's): the explicit ``fabric``, else the
        mesh-derived shape."""
        from repro_torch.core.planner import _ep_topology
        return _ep_topology(self.num_pods, self.data_size, self.fabric)

    @property
    def num_servers(self) -> int:
        """Server groups of the data-parallel ranks on :attr:`dp_topology`
        (what ``planned_psum``'s two-level schedules group by)."""
        return int(self.dp_topology.meta.num_servers)

    def ep_ranks(self, num_experts: int) -> tuple[bool, int]:
        """(use_pod_axis, total EP ranks) for an MoE layer: EP spans the pod
        axis only when there are enough experts (the paper's large-EP
        regime); otherwise EP = data axis and pod stays pure DP."""
        if self.pod_axis and num_experts >= self.num_pods * self.data_size:
            return True, self.num_pods * self.data_size
        return False, self.data_size

    # -- planner consumption -------------------------------------------------
    def _plan_topo_hw(self, num_experts: int):
        """(topology, hardware model) the EP planner ops score against: the
        explicit ``fabric`` (or the reference's mesh-derived shape), and
        with a ``calibration`` store the store's fitted model for that
        topology (None: the planner's own, the datasheet)."""
        from repro_torch.core.planner import _ep_topology
        use_pod, _ = self.ep_ranks(num_experts)
        topo = _ep_topology(self.num_pods if use_pod else 1,
                            self.data_size, self.fabric)
        hw = None
        if self.calibration is not None:
            from repro_torch.telemetry import calibrated_hw, resolve_store
            hw = calibrated_hw(resolve_store(self.calibration), topo)
        return topo, hw

    # -- declarative collective programs -------------------------------------
    def bind(self, plan) -> "ParallelContext":
        """Install a jointly planned ExecutionPlan (returns the bound
        context: the dataclass is frozen).  A plan fingerprinted on a
        foreign fabric raises; failure variants of this context's fabric
        are accepted, as are pinned plans."""
        if (plan is not None and self.fabric is not None
                and plan.topo_fingerprint != ("pinned",)):
            from repro_torch.core.topology import same_fabric_fingerprint
            fp = self.fabric.fingerprint()
            if not same_fabric_fingerprint(plan.topo_fingerprint, fp):
                raise ValueError(
                    f"ExecutionPlan {plan.fingerprint} was planned on "
                    f"{plan.topo_fingerprint[0]!r}, but this context's "
                    f"fabric is {fp[0]!r} — replan the program for the "
                    f"active fabric before binding")
        if plan is not None:
            from repro_torch.telemetry import metrics as _m
            _m.default_registry()["repro_plan_bind_total"].inc(
                program=plan.program.name, fingerprint=plan.fingerprint)
        return dataclasses.replace(self, execution_plan=plan)

    def moe_sites(self, phase: str, *, num_experts: int, top_k: int,
                  tokens_per_rank: int, token_bytes: int,
                  compute_s: float = 0.0) -> tuple:
        """This context's coupled MoE (dispatch, combine) site pair for one
        phase, priced under the declared ``moe_skew``."""
        from repro_torch.core import plan as plan_ir
        return plan_ir.moe_sites(
            phase, num_experts=num_experts, top_k=top_k,
            tokens_per_rank=tokens_per_rank, token_bytes=token_bytes,
            skew=self.moe_skew, compute_s=compute_s)

    def split_tp_gather_site(self, phase: str, *, global_batch: int,
                             seq_len: int, d_model: int, itemsize: int = 2):
        """The §3.1 split-TP AllGather site this context's transformer
        blocks issue for one phase (the SP -> TP boundary gather of
        ``transformer._split_tp_seq_gather``), or None when the geometry
        emits no split-TP gather: the same guards."""
        m, nd = self.model_size, self.tp_subgroups
        dp = self.num_pods * self.data_size
        if (nd != 2 or not self.seq_parallel or m % nd or seq_len % m
                or global_batch % dp):
            return None
        from repro_torch.core import plan as plan_ir
        from repro_torch.core.topology import split_tp_full_mesh
        frag = (global_batch // dp) * (seq_len // m) * d_model * itemsize
        topo, _ = split_tp_full_mesh(m, tp=m // nd)
        return plan_ir.allgather_site(phase, frag_bytes=frag,
                                      num_domains=nd, topo=topo)

    def grad_sync_site(self, phase: str, *, num_params: int,
                       tokens_per_rank: int,
                       peak_flops: float = H100_BF16_PEAK_FLOPS):
        """The per-step gradient AllReduce site of one training phase, or
        None without data-parallel replicas.  Payload: fp32 gradients;
        overlap context: the modelled backward pass at ``peak_flops``;
        fabric: the full DP span, pods included."""
        dp = self.num_pods * self.data_size
        if dp <= 1:
            return None
        from repro_torch.core import plan as plan_ir
        from repro_torch.core.latency_model import backward_compute_s
        payload = float(num_params) * 4.0 / max(1, self.model_size)
        compute = backward_compute_s(num_params, tokens_per_rank,
                                     tp=self.model_size,
                                     peak_flops=peak_flops)
        return plan_ir.grad_sync_site(phase, payload_bytes=payload,
                                      compute_s=compute,
                                      topo=self.dp_topology)

    def grad_sync_plan(self, *, num_params: int, tokens_per_rank: int,
                       phase: str = "train",
                       peak_flops: float = H100_BF16_PEAK_FLOPS):
        """The gradient AllReduce decision of one training step, or None
        without data-parallel replicas: the bound plan's site of this
        workload, looked up by role as :meth:`moe_pipeline_kwargs` looks up
        its own; then the planner under ``plan_policy="auto"``; None under
        "fixed" (the flat ring)."""
        site = self.grad_sync_site(phase, num_params=num_params,
                                   tokens_per_rank=tokens_per_rank,
                                   peak_flops=peak_flops)
        if site is None:
            return None
        if self.execution_plan is not None:
            role = self.execution_plan.find_role(
                "allreduce", site.payload_bytes, compute_s=site.compute_ctx)
            if role is not None:
                return self.execution_plan.decision(role)
        if self.plan_policy != "auto":
            return None
        from repro_torch.core import plan as plan_ir
        eplan = self.plan_collectives(
            plan_ir.CollectiveProgram(f"{phase}/grad_sync", (site,)))
        return eplan.decision(site.role)

    def plan_collectives(self, program):
        """Jointly plan a declared program on this context's fabric and
        calibration (``pctx = pctx.bind(pctx.plan_collectives(program))``)."""
        from repro_torch.core.planner import default_planner
        num_experts = max((dict(s.scenario_kw).get("num_experts", 0)
                           for s in program.sites), default=0)
        topo, hw = self._plan_topo_hw(num_experts)
        return default_planner().plan_program(program, topo, hw)

    def bound_plan_stale(self, planner=None) -> Optional[bool]:
        """Whether the bound plan was superseded by a replan (True), is
        current (False), or cannot be judged (None)."""
        if self.execution_plan is None:
            return None
        if planner is None:
            from repro_torch.core.planner import default_planner
            planner = default_planner()
        return planner.plan_is_stale(self.execution_plan)

    # -- site resolution -----------------------------------------------------
    def moe_pipeline_kwargs(self, num_experts: int, top_k: int,
                            tokens_per_rank: int, token_bytes: int,
                            compute_s: float = 0.0,
                            microbatch: Optional[int] = None) -> dict:
        """The MoE round trip one layer executes: ``{"moe_scheme",
        "moe_combine", "microbatch"}``, decided together.

        Resolution order: (1) a bound ExecutionPlan whose declared dispatch
        site matches this workload; (2) under ``plan_policy="auto"``, an
        ad-hoc single-phase program through the planner; (3) the declared
        knobs.  A unicast dispatch always returns by the unicast path.
        ``microbatch`` constrains the result to the chunk count the layer
        actually runs (the best joint candidate at that G).

        Eager torch asks at every MoE call, where the reference asks once
        at trace time; the first answer for one set of arguments is kept
        on the context, as a jitted layer keeps its trace-time answer: a
        recalibration reaches a layer through a re-bind, which makes a new
        context."""
        key = (num_experts, top_k, tokens_per_rank, token_bytes,
               float(compute_s), microbatch)
        kw = self._resolved.get(key)
        if kw is None:
            kw = self._resolved[key] = self._resolve_pipeline_kwargs(
                num_experts, top_k, tokens_per_rank, token_bytes,
                compute_s, microbatch)
        return dict(kw)

    def _resolve_pipeline_kwargs(self, num_experts, top_k, tokens_per_rank,
                                 token_bytes, compute_s, microbatch) -> dict:
        payload = float(tokens_per_rank) * token_bytes
        scen = dict(num_experts=num_experts, top_k=top_k,
                    token_bytes=token_bytes)
        decision = None
        if self.execution_plan is not None:
            role = self.execution_plan.find_role(
                "dispatch", payload, skew=self.moe_skew,
                compute_s=compute_s, **scen)
            if role is not None:
                anchor = self.execution_plan.group_of.get(role)
                decision = (self.execution_plan.joint.get(anchor)
                            if anchor is not None else None)
                if decision is None:
                    kw = self.execution_plan.site_kwargs(role)
                    return self._norm_moe_kwargs(
                        self._kwargs_at_g(None, kw, microbatch))
        if decision is None:
            if self.plan_policy != "auto":
                return self._norm_moe_kwargs(self._kwargs_at_g(
                    None, {"moe_scheme": self.moe_scheme,
                           "moe_combine": self.moe_combine,
                           "microbatch": max(1, int(self.moe_microbatch))},
                    microbatch))
            from repro_torch.core import plan as plan_ir
            sites = self.moe_sites(
                "auto", num_experts=num_experts, top_k=top_k,
                tokens_per_rank=tokens_per_rank, token_bytes=token_bytes,
                compute_s=compute_s)
            eplan = self.plan_collectives(
                plan_ir.CollectiveProgram("moe/auto", sites))
            decision = eplan.joint.get(sites[0].role)
            if decision is None:
                return self._norm_moe_kwargs(self._kwargs_at_g(
                    None, eplan.site_kwargs(sites[0].role), microbatch))
        return self._norm_moe_kwargs(self._kwargs_at_g(
            decision, dict(decision.shard_map_kwargs), microbatch))

    @staticmethod
    def _kwargs_at_g(decision, kwargs: dict,
                     microbatch: Optional[int]) -> dict:
        """Constrain a resolved configuration to an executed chunk count:
        the best joint candidate at that G when the decision carries a
        candidate sweep, else the same kwargs with G overridden."""
        if microbatch is None or \
                int(microbatch) == int(kwargs.get("microbatch", 1)):
            return kwargs
        g = max(1, int(microbatch))
        for name, kn, _ in sorted(
                getattr(decision, "candidates", None) or (),
                key=lambda c: c[2]):
            if dict(kn).get("microbatch", 1) != g or "+" not in name:
                continue
            from repro_torch.core import plan as plan_ir
            d_name, _, c_name = name.partition("+")
            kw = plan_ir.get_plan("dispatch", d_name).shard_map_kwargs(
                microbatch=g)
            kw.update(plan_ir.get_plan("combine", c_name).shard_map_kwargs(
                microbatch=g))
            return kw
        return {**kwargs, "microbatch": g}

    @staticmethod
    def _norm_moe_kwargs(kw: dict) -> dict:
        """The combine follows the dispatch scheme unless set, and the
        baseline (unicast) dispatch forces the unicast return path (no
        relay state exists for a relay-reduced combine)."""
        scheme = kw.get("moe_scheme", "hierarchical")
        combine = kw.get("moe_combine") or scheme
        if scheme == "baseline":
            combine = "baseline"
        return {"moe_scheme": scheme, "moe_combine": combine,
                "microbatch": max(1, int(kw.get("microbatch", 1)))}

    def allgather_plan(self, frag_bytes: float, num_domains: int = 2):
        """Decision for the split-TP AllGather at one fragment size:
        bound-plan lookup first, then the planner under "auto", None under
        "fixed"."""
        if self.execution_plan is not None:
            role = self.execution_plan.find_role(
                "allgather", frag_bytes, num_domains=num_domains)
            if role is not None:
                return self.execution_plan.decision(role)
        if self.plan_policy != "auto":
            return None
        from repro_torch.core.planner import default_planner
        from repro_torch.core.topology import split_tp_full_mesh
        n = self.model_size
        topo, _ = split_tp_full_mesh(n, tp=max(1, n // num_domains))
        return default_planner().choose(
            "allgather", float(frag_bytes), topo, executable_only=True,
            num_domains=num_domains)


def seq_sharded(pctx: Optional[ParallelContext], seq_len: int) -> bool:
    """Whether the residual stream of ``seq_len`` positions lies sharded
    over the model axis between blocks (the reference's
    ``shard_residual`` rule: sequence parallelism on, and the length
    divides over the model axis)."""
    return (pctx is not None and pctx.model_size > 1 and pctx.seq_parallel
            and seq_len % pctx.model_size == 0)


def shard_residual(x, pctx: Optional[ParallelContext]):
    """The between-block residual [B, S, D] as this rank holds it: its
    block of S over the model axis when :func:`seq_sharded`, else all of
    it (the reference's ``shard_residual`` constraint, on tensors)."""
    if not seq_sharded(pctx, x.shape[1]):
        return x
    part = x.shape[1] // pctx.model_size
    at = pctx.mesh.axis_index(pctx.model_axis) * part
    return x[:, at:at + part]


def build_collective_program(cfg, pctx: ParallelContext, name: str,
                             phases: dict, *, itemsize: int = 2,
                             phase_budgets: Optional[dict] = None,
                             peak_flops: float = H100_BF16_PEAK_FLOPS):
    """The declared collective program of one launch surface.

    ``phases`` maps a phase name ("train" | "prefill" | "decode") to its
    ``(global_batch, seq_len)`` workload.  Per phase this declares the
    coupled MoE (dispatch, combine) pair of an MoE arch, and for "train"
    the gradient AllReduce: exactly the sites ``moe_ffn`` looks up, from
    the same shard math.  ``itemsize`` must match the activation dtype the
    model runs in (site keys embed the payload bucket).  The overlap
    contexts are priced at ``peak_flops``, the H100's bf16 peak, as
    ``moe_ffn`` prices them; the reference's ``TPU_PEAK_FLOPS`` gives the
    reference's program.  ``phase_budgets`` (phase -> seconds) caps a
    phase's latency in the planner's contention-aware sweep."""
    from repro_torch.core import plan as plan_ir
    sites = []
    for phase, (global_batch, seq_len) in phases.items():
        dp = pctx.num_pods * pctx.data_size
        n_rank = max(1, (global_batch * seq_len) // dp)
        if getattr(cfg, "is_moe", False):
            d_ff = getattr(cfg, "expert_d_ff", cfg.d_model)
            compute_s = moe_compute_s(n_rank, cfg.top_k, cfg.d_model, d_ff,
                                      tp=pctx.model_size,
                                      peak_flops=peak_flops)
            sites.extend(pctx.moe_sites(
                phase, num_experts=cfg.num_experts, top_k=cfg.top_k,
                tokens_per_rank=n_rank, token_bytes=cfg.d_model * itemsize,
                compute_s=compute_s))
        if seq_len > 1:
            ag = pctx.split_tp_gather_site(
                phase, global_batch=global_batch, seq_len=seq_len,
                d_model=cfg.d_model, itemsize=itemsize)
            if ag is not None:
                sites.append(ag)
        if phase == "train":
            from repro_torch.models.api import param_count_shape_only
            gs = pctx.grad_sync_site(phase,
                                     num_params=param_count_shape_only(cfg),
                                     tokens_per_rank=n_rank,
                                     peak_flops=peak_flops)
            if gs is not None:
                sites.append(gs)
    return plan_ir.CollectiveProgram(name, tuple(sites),
                                     phase_budgets=dict(phase_budgets or {}))


class PlanBinder:
    """Double-buffered :class:`~repro_torch.core.plan.ExecutionPlan` binding
    with a traced-lowering cache keyed on plan fingerprint — the hot
    re-bind mechanic that turns plan churn into a runtime non-event
    (ROADMAP: millions-of-users path).

    ``trace_fn(plan)`` builds the traced/lowered artifact that executes
    under ``plan`` (e.g. jitted prefill/decode closures over the bound
    context).  The binder keeps two buffers:

    - the **active** (plan, artifact) pair the step loop executes;
    - a **pending** plan staged by :meth:`stage` — its artifact is built
      (or found in the cache) at stage time, OFF the step path.

    :meth:`swap_if_pending` is called at step boundaries and is a pure
    pointer swap when the staged lowering is cached (the invariant the
    stress soak asserts: zero cold retraces).  A swap whose artifact is
    missing — evicted, or staged around the cache — builds it AT the
    swap point and counts it as a cold retrace, so regressions are
    observable rather than silent.  Re-binding to a previously-seen
    fingerprint (recovery flipping back to the pre-failure plan) is a
    cache hit: no retrace at all.
    """

    def __init__(self, trace_fn, plan=None, *, cache_size: int = 8) -> None:
        import collections
        self._trace_fn = trace_fn
        self._cache: "collections.OrderedDict" = collections.OrderedDict()
        self.cache_size = max(1, int(cache_size))
        self.swaps = 0
        self.cold_retraces = 0
        self.cache_hits = 0
        self.cache_misses = 0
        self._pending = None          # staged plan awaiting a boundary
        self._active = (None, None)   # (plan, artifact)
        if plan is not None or trace_fn is not None:
            # the initial bind traces at construction (startup, not a
            # swap): the step loop starts with a warm active buffer
            self._active = (plan, self._build(plan))

    @staticmethod
    def _key(plan):
        return plan.fingerprint if plan is not None else None

    @staticmethod
    def _program(plan) -> str:
        return plan.program.name if plan is not None else "none"

    def _metrics(self):
        from repro_torch.telemetry import metrics as _m
        return _m.default_registry()

    def _build(self, plan):
        """Artifact for ``plan`` through the fingerprint-keyed cache."""
        key = self._key(plan)
        if key in self._cache:
            self._cache.move_to_end(key)
            self.cache_hits += 1
            self._metrics()["repro_lowering_cache_hits_total"].inc(
                program=self._program(plan))
            return self._cache[key]
        self.cache_misses += 1
        self._metrics()["repro_lowering_cache_misses_total"].inc(
            program=self._program(plan))
        art = self._trace_fn(plan)
        self._cache[key] = art
        while len(self._cache) > self.cache_size:
            self._cache.popitem(last=False)
        return art

    @property
    def plan(self):
        return self._active[0]

    @property
    def artifact(self):
        return self._active[1]

    @property
    def pending(self) -> bool:
        return self._pending is not None

    def stage(self, plan) -> bool:
        """Stage ``plan`` for the next step boundary, building its
        lowering NOW (double-buffered: the active plan keeps serving
        while the replacement traces).  Returns False when ``plan`` is
        already active with nothing pending — there is nothing to swap."""
        if self._pending is None and self._key(plan) == \
                self._key(self._active[0]):
            return False
        self._build(plan)
        self._pending = plan
        return True

    def prefetch(self, plan) -> bool:
        """Warm the traced-lowering cache for ``plan`` WITHOUT staging a
        swap — the serving tier's batch-bucket prefetch.  The
        neighboring bucket's lowering is built here, off the step path,
        so a later :meth:`stage` + :meth:`swap_if_pending` when the
        decode batch grows across the bucket boundary is a pure pointer
        flip (mirroring the failover swap).  Returns True when this
        call built the artifact; False when it was already cached (or
        already active)."""
        key = self._key(plan)
        if key == self._key(self._active[0]) or key in self._cache:
            return False
        self._build(plan)
        self._metrics()["repro_plan_prefetch_total"].inc(
            program=self._program(plan))
        return True

    def swap_if_pending(self) -> bool:
        """Make the staged plan active (call between steps).  A pure
        pointer swap when the staged lowering is cached; a cache miss
        here IS the cold retrace the double-buffering exists to avoid,
        and is counted as such."""
        if self._pending is None:
            return False
        plan = self._pending
        self._pending = None
        key = self._key(plan)
        if key in self._cache:
            self._cache.move_to_end(key)
            art = self._cache[key]
        else:
            self.cold_retraces += 1
            self._metrics()["repro_rebind_cold_retrace_total"].inc(
                program=self._program(plan))
            art = self._build(plan)
        self._active = (plan, art)
        self.swaps += 1
        self._metrics()["repro_plan_rebind_total"].inc(
            program=self._program(plan),
            fingerprint=(plan.fingerprint if plan is not None else "none"))
        return True
