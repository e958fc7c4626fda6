"""Batched serving engine: prefill + KV-cache decode, bound to a plan.

Port of ``src/repro/runtime/server.py``.  Requests are padded into batch
slots, prefilled once, then decoded step by step; greedy or temperature
sampling through a seeded ``torch.Generator``.

The reference runs each bound ExecutionPlan as a jitted prefill and a
jitted, cache-donating decode, cached per plan fingerprint by
``PlanBinder``.  The port keeps the binder and the plan-bound methods
(plan reports, hot re-bind, batch-bucket prefetch, the admission probe);
its lowering of a plan is the model built against the bound context and a
:class:`~repro_torch.runtime.graphs.DecodeGraphs`, which captures a cohort's
decode step as a CUDA graph once per (cohort rows, cache length) and
replays it every round (eager on the CPU and over gloo:
``stats["decode_graph"]`` says which, and why).

Over ranks (``pctx``), the engine keeps the reference's API: every rank is
given the GLOBAL prompts and returns the GLOBAL tokens, as the reference's
GSPMD engine does.  Every rank runs the same scheduler over all B requests;
the model step computes only the rank's data-parallel rows (dp index = pod
* data_size + data), and the sampled tokens are gathered over the dp ranks
before the scheduler sees them.  The model ranks of one data-parallel
group take the same rows and compute the same logits (their row-parallel
sums are ``all_reduce`` results, the same bits on every rank), so they
sample the same tokens.  The phase walls are the slowest rank's of the
whole mesh, so every rank's scheduler clock, and so every admission
decision, agrees: no rank skips a collective the others wait in, and every
rank captures and replays its graphs in the same rounds.  ``generate`` is a thin client of
the continuous-batching scheduler: the whole batch arrives at t=0 and
drains as one cohort through :meth:`ServeEngine.start_cohort` /
:meth:`ServeEngine.step_cohort`, the loop the serving tier interleaves.
"""

from __future__ import annotations

import dataclasses
import time
import weakref
from typing import Callable, Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.device import resolve_device
from repro_torch.parallel.context import PlanBinder
from repro_torch.runtime.graphs import DecodeGraphs, Slot, decode_mode
from repro_torch.serving.admission import AdmissionController
from repro_torch.serving.queue import Request, RequestQueue
from repro_torch.serving.scheduler import BatchScheduler


def _metrics():
    from repro_torch.telemetry import metrics as _m
    return _m.default_registry()


@dataclasses.dataclass
class ServeConfig:
    max_new_tokens: int = 32
    temperature: float = 0.0          # 0 = greedy
    eos_id: Optional[int] = None
    cache_dtype: torch.dtype = torch.bfloat16


@dataclasses.dataclass
class _ServeLowering:
    """The lowering of one ExecutionPlan: the model built against the
    context bound to it, its prefill, and the decode runner whose graphs
    run exactly that plan's MoE round trips."""
    pctx: object
    model: object
    prefill: Callable
    decode: DecodeGraphs


@dataclasses.dataclass
class CohortState:
    """In-flight decode state of one cohort (one prefill's worth of
    requests, position-aligned): its decode slot (the cache), the last
    logits, the sampling generator, and the decode runner that holds the
    slot."""
    slot: Slot
    logits: torch.Tensor
    generator: torch.Generator
    batch: int
    decoder: DecodeGraphs


class ServeEngine:
    def __init__(self, model, params, cfg: ServeConfig = ServeConfig(),
                 device=None, pctx=None, fabric=None, calibration=None,
                 monitor=None, model_builder=None):
        """``device=None`` means CUDA (raises without one); the model must
        have been built for the same device and the same ``pctx``.
        ``fabric``: a fabric name or spec (``core.topology.get_fabric``)
        or Topology the planner scores on instead of the context's.
        ``model_builder``: ``pctx -> Model`` for a re-bound context
        (default: ``models.api.build_model`` of the same config, device
        and dtype) — what :meth:`rebind` builds when a new plan swaps
        in; the same ``params`` serve every plan, since a re-bound context
        keeps its mesh and expert shard.  ``calibration``: a telemetry
        CalibrationStore (or path) whose fitted hardware model the planner
        scores on.  ``monitor``: a telemetry DriftMonitor whose
        predicted-vs-measured state ``plan_report`` carries, and whose
        retargeted plans a stale bound plan is re-staged from."""
        self.device = resolve_device(device)
        if model.device != self.device:
            raise ValueError(f"model built for {model.device}, engine on "
                             f"{self.device}")
        if model.pctx is not pctx:
            raise ValueError("the model was built for another ParallelContext")
        if pctx is not None and (fabric is not None
                                 or calibration is not None):
            from repro_torch.core.topology import get_fabric
            repl = {}
            if fabric is not None:
                repl["fabric"] = (get_fabric(fabric)
                                  if isinstance(fabric, str) else fabric)
            if calibration is not None:
                repl["calibration"] = calibration
            pctx = dataclasses.replace(pctx, **repl)
        self.pctx = pctx
        self.monitor = monitor
        self.model = model
        self.params = params
        self.cfg = cfg
        self._model_builder = model_builder
        mode, reason = decode_mode(self.device, pctx)
        self.stats = {"prefill_s": 0.0, "decode_s": 0.0, "tokens": 0,
                      "nonfinite_logits": 0,
                      "decode_graph": {"captures": 0, "replays": 0,
                                       "eager_rounds": 0, "capture_s": 0.0,
                                       "mode": mode, "reason": reason}}
        self._stale_warned = False
        # (batch, prompt_len)-keyed memos: per-step scheduler queries
        # (plan_report, admission probes) never re-derive the program or
        # re-plan
        self._programs: dict = {}
        self._plan_cache: dict = {}
        self._probe = None
        # the decode runners of the lowerings alive (the binder's LRU and
        # in-flight cohorts hold them)
        self._decoders = weakref.WeakSet()
        initial = pctx.execution_plan if pctx is not None else None
        self._binder = PlanBinder(self._trace_plan, plan=initial)

    # -- hot plan re-bind -----------------------------------------------------
    def _trace_plan(self, plan) -> _ServeLowering:
        """PlanBinder trace_fn: the lowering of ``plan``.  The initial bind
        reuses the engine's model (the launcher binds the plan before
        building it); a re-bind builds a model against the newly bound
        context, and a decode runner of its own, whose graphs are captured
        under the new decisions."""
        base_plan = self.pctx.execution_plan if self.pctx is not None \
            else None
        if plan is base_plan or self.pctx is None:
            pctx, model = self.pctx, self.model
        else:
            pctx = self.pctx.bind(plan)
            if self._model_builder is not None:
                model = self._model_builder(pctx)
            else:
                from repro_torch.models.api import build_model
                model = build_model(self.model.cfg, device=self.device,
                                    dtype=self.model.dtype, pctx=pctx)
        decode = DecodeGraphs(model, self.params,
                              mode=self.stats["decode_graph"]["mode"],
                              stats=self.stats["decode_graph"])
        self._decoders.add(decode)
        return _ServeLowering(pctx=pctx, model=model, prefill=model.prefill,
                              decode=decode)

    def rebind(self, plan) -> bool:
        """Stage ``plan`` for hot re-bind: its lowering is built NOW, off
        the request path, and swapped in at the next step boundary.
        Returns True when a swap is pending."""
        self.invalidate_plan_cache()
        return self._binder.stage(plan)

    @property
    def plan_binder(self):
        return self._binder

    def serving_program(self, batch: int, prompt_len: int):
        """The declared collective program of this serving shape: both
        phases' coupled MoE (dispatch, combine) pairs — prefill at
        batch*prompt_len tokens, decode at batch tokens.  Sites assume
        bf16 activations (the production serving dtype; fp32 smoke
        launchers bind their own program with the right itemsize before
        building the model).  Memoized on ``(batch, prompt_len)``."""
        key = (int(batch), int(prompt_len))
        program = self._programs.get(key)
        if program is None:
            from repro_torch.parallel.context import build_collective_program
            program = build_collective_program(
                self.model.cfg, self.pctx, "serve",
                {"prefill": (batch, prompt_len), "decode": (batch, 1)})
            self._programs[key] = program
        return program

    def invalidate_plan_cache(self) -> None:
        """Drop memoized fresh plans (a re-bind may have changed what
        planning would choose; the declared programs are shape-only and
        stay)."""
        self._plan_cache.clear()

    def _fresh_plan(self, batch: int, prompt_len: int):
        """Fresh jointly-planned ExecutionPlan for this serving shape,
        memoized on ``(batch, prompt_len)``."""
        key = (int(batch), int(prompt_len))
        if key in self._plan_cache:
            return self._plan_cache[key]
        program = self.serving_program(batch, prompt_len)
        plan = None
        if program.sites and self.pctx.plan_policy == "auto":
            plan = self.pctx.plan_collectives(program)
        self._plan_cache[key] = plan
        return plan

    def execution_plan(self, batch: int, prompt_len: int):
        """The binder's active plan (post-swap), else the context's bound
        plan, else a fresh plan of this serving shape on the context's
        fabric."""
        if self.pctx is None:
            return None
        bound = self._binder.plan or self.pctx.execution_plan
        if bound is not None:
            return bound
        return self._fresh_plan(batch, prompt_len)

    # -- batch-bucket plan prefetch (the serving tier's admission seam) ------
    def bucket_plan(self, batch: int, prompt_len: int):
        """ExecutionPlan for the BUCKETED serving shape — what the
        admission controller stages ahead of growing the decode batch
        across a bucket boundary.  None when the context cannot plan."""
        if self.pctx is None or self.pctx.plan_policy != "auto":
            return None
        from repro_torch.core.plan import batch_bucket
        return self._fresh_plan(batch_bucket(max(1, batch)), prompt_len)

    def prefetch_bucket(self, batch: int, prompt_len: int) -> bool:
        """Build the lowering of the bucketed serving shape's plan off the
        step path (``PlanBinder.prefetch``), so a later admission across
        the bucket boundary swaps on a pointer flip.  Returns True when a
        lowering was built."""
        plan = self.bucket_plan(batch, prompt_len)
        if plan is None:
            return False
        return self._binder.prefetch(plan)

    def plan_probe(self, itemsize: int = 2):
        """PlannerProbe over this engine's fabric and calibration — the
        admission controller's latency oracle.  ``itemsize`` must match the
        activation dtype (2 = bf16, 4 = fp32 smoke).  None without a
        parallel context."""
        if self._probe is not None:
            return self._probe
        if self.pctx is None:
            return None
        from repro_torch.serving.admission import PlannerProbe
        cfg = self.model.cfg
        topo, hw = self.pctx._plan_topo_hw(
            getattr(cfg, "num_experts", 0) or 0)
        self._probe = PlannerProbe(
            topo, token_bytes=cfg.d_model * itemsize,
            num_experts=getattr(cfg, "num_experts", 0) or 64,
            top_k=getattr(cfg, "top_k", 0) or 8, hw=hw,
            d_model=cfg.d_model, tp=self.pctx.model_size)
        return self._probe

    def plan_report(self, batch: int, prompt_len: int) -> dict:
        """Per-phase view of the jointly planned serving program: each
        phase's dispatch and combine decisions plus the JOINT pipeline
        verdict, resolved against the plan the MoE layers execute, and
        with a ``monitor`` its drift report (``calibration``).  A bound
        plan that a replan would change is reported (``stale``): when the
        monitor retargeted its program (failover or failback) the
        replacement is staged for a hot re-bind (``restaged``), else it is
        warned about once."""
        out = {}
        if self.monitor is not None:
            out["calibration"] = self.monitor.report()
        eplan = self.execution_plan(batch, prompt_len)
        if eplan is None:
            return out
        out["execution_plan"] = eplan.fingerprint
        if self.pctx.execution_plan is eplan:
            stale = self.pctx.bound_plan_stale()
            if stale is not None:
                out["stale"] = stale
                staged = None
                if stale and self.monitor is not None:
                    staged = self.monitor.staged_plan(eplan.program.name)
                if staged is not None:
                    out["restaged"] = self.rebind(staged)
                elif stale and not self._stale_warned:
                    self._stale_warned = True
                    _metrics()["repro_plan_stale_total"].inc(
                        program=eplan.program.name,
                        fingerprint=eplan.fingerprint)
                    print(f"WARNING: bound ExecutionPlan "
                          f"{eplan.fingerprint} is stale — a replan chose "
                          f"different decisions for this program; serving "
                          f"continues on the old plan until re-bind")
        if eplan.phase_report:
            out["phases"] = {ph: dict(rep)
                             for ph, rep in eplan.phase_report.items()}
            reg = _metrics()
            for ph, rep in eplan.phase_report.items():
                score = rep.get("contended_score_s", rep.get("score_s"))
                if score is not None:
                    reg["repro_phase_predicted_seconds"].set(
                        score, phase=ph, fingerprint=eplan.fingerprint)
                if rep.get("budget_s") is not None:
                    reg["repro_phase_budget_ok"].set(
                        1.0 if rep.get("budget_ok") else 0.0,
                        phase=ph, fingerprint=eplan.fingerprint)
        if eplan.planner_stats:
            out["planner"] = dict(eplan.planner_stats)
        for site in eplan.program.sites:
            phase, _, kind = site.role.partition("/")
            if kind == "moe_dispatch":
                cell = out.setdefault(phase, {})
                cell["dispatch"] = eplan.decision(site.role).report()
                joint = eplan.joint.get(site.role)
                if joint is not None:
                    cell["joint"] = joint.report()
            elif kind == "moe_combine":
                out.setdefault(phase, {})["combine"] = \
                    eplan.decision(site.role).report()
            elif kind == "split_tp_gather":
                out.setdefault(phase, {})["split_tp_gather"] = \
                    eplan.decision(site.role).report()
        return out

    # -- the step-level cohort API (what the BatchScheduler drives) ----------
    @torch.inference_mode()
    def start_cohort(self, prompts: np.ndarray,
                     max_new: Optional[int] = None, seed: int = 0):
        """Prefill one cohort of requests ([b, s] int32, already padded to
        one shared prompt_len) into a decode slot and sample its first
        tokens.  Returns ``(state, tokens, wall_s)``."""
        b, s = prompts.shape
        max_new = max_new or self.cfg.max_new_tokens
        lowering = self._binder.artifact
        t0 = time.monotonic()
        rows = self._my_rows(prompts)
        slot = lowering.decode.start(len(rows), s + max_new,
                                     self.cfg.cache_dtype)
        if "valid" in slot.cache:       # padding rows take no expert slot
            slot.cache["valid"].copy_(torch.from_numpy(self._my_valid(b)))
        tokens = torch.from_numpy(np.ascontiguousarray(rows, np.int32))
        logits, _ = lowering.prefill(
            self.params, {"tokens": tokens.to(self.device)}, slot.cache)
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed)
        state = CohortState(slot=slot, logits=logits, generator=gen,
                            batch=b, decoder=lowering.decode)
        tokens = self._sample(state)
        return state, tokens, self._wall(t0)

    @torch.inference_mode()
    def step_cohort(self, state: CohortState, tokens: np.ndarray):
        """One decode round (a graph replay once the cohort's slot has
        one): consume the cohort's last sampled tokens, sample the next.
        A cohort admitted under an earlier plan moves to the active
        plan's decoder.  Returns ``(state, tokens, wall_s)``."""
        t0 = time.monotonic()
        decoder = self._binder.artifact.decode
        if state.decoder is not decoder:
            state.decoder = decoder
            decoder.adopt(state.slot)
        state.logits = decoder(state.slot,
                               self._my_rows(np.asarray(tokens, np.int32)))
        tokens = self._sample(state)
        return state, tokens, self._wall(t0)

    def end_cohort(self, state: CohortState) -> None:
        """The cohort retired: its slot (cache and graph) waits for the
        next cohort of its shape."""
        state.decoder.release(state.slot)

    def close(self) -> None:
        """Free every decode slot kept for later cohorts, graphs included
        (over nccl: before the process group is destroyed)."""
        for decode in self._decoders:
            decode.close()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # -- data-parallel rows over ranks -------------------------------------------
    def _my_rows(self, rows):
        """This rank's block of the global batch rows (a numpy array or a
        tensor).  A batch that does not divide over the data-parallel ranks
        is padded with zero rows to the next multiple first: every rank
        gets ``ceil(B / dp)`` rows (the reference refuses such a batch).
        The padded rows' tokens are routed as invalid (``_my_valid``), so
        they take no expert capacity, and their samples are dropped."""
        if self.pctx is None:
            return rows
        dp = self.pctx.dp_size
        per = -(-len(rows) // dp)
        pad = per * dp - len(rows)
        if pad:
            if isinstance(rows, torch.Tensor):
                rows = torch.cat([rows, rows.new_zeros((pad,) + tuple(
                    rows.shape[1:]))])
            else:
                rows = np.concatenate([rows, np.zeros(
                    (pad,) + rows.shape[1:], rows.dtype)])
        return rows[self.pctx.dp_index * per:(self.pctx.dp_index + 1) * per]

    def _my_valid(self, batch: int) -> np.ndarray:
        """[this rank's rows] bool: the rows of :meth:`_my_rows` that are
        requests, not padding (which comes as False)."""
        return self._my_rows(np.ones(batch, dtype=bool))

    def _dp_group(self):
        return self.pctx.mesh.group(*self.pctx.dp_axes)

    def _wall(self, t0: float) -> float:
        """The phase wall since ``t0``: the slowest rank's of the mesh."""
        wall = time.monotonic() - t0
        if self.pctx is None or self.pctx.mesh.axis_size(
                "pod", "data", "model") == 1:
            return wall
        t = torch.tensor([wall], dtype=torch.float64, device=self.device)
        dist.all_reduce(t, op=dist.ReduceOp.MAX)
        return float(t.item())

    def _sample(self, state: CohortState) -> np.ndarray:
        logits = state.logits
        self.stats["nonfinite_logits"] += int(
            (~torch.isfinite(logits)).any().item())
        if self.cfg.temperature > 0:
            # inverse-CDF draws from one uniform per GLOBAL row, of which
            # this rank takes its rows' share: every row draws its own
            # number, the same one on any count of ranks
            u = self._my_rows(torch.rand(state.batch, dtype=torch.float64,
                                         generator=state.generator,
                                         device=self.device))
            cdf = torch.softmax(logits.double() / self.cfg.temperature,
                                dim=-1).cumsum(dim=-1)
            nxt = torch.searchsorted(cdf, (u * cdf[:, -1])[:, None],
                                     right=True)[:, 0]
            nxt = nxt.clamp(max=logits.shape[-1] - 1)
        else:
            nxt = torch.argmax(logits, dim=-1)
        nxt = nxt.to(torch.int32)
        if self.pctx is not None and self.pctx.dp_size > 1:
            parts = [torch.empty_like(nxt) for _ in range(self.pctx.dp_size)]
            dist.all_gather(parts, nxt, group=self._dp_group())
            nxt = torch.cat(parts)[:state.batch]     # the padding dropped
        return nxt.cpu().numpy()

    def generate(self, prompts: np.ndarray, max_new: Optional[int] = None,
                 seed: int = 0) -> np.ndarray:
        """prompts: [B, S] int32 (already padded).  Returns [B, max_new].

        The whole batch arrives at t=0 and drains as one cohort through
        the scheduler: one code path with continuous batching, bit-exact
        either way under greedy decoding.  Over ranks every rank passes
        the global prompts and gets the global tokens."""
        b, s = prompts.shape
        max_new = max_new or self.cfg.max_new_tokens
        # step boundary: a staged re-bind lands here, never mid-decode
        self._binder.swap_if_pending()
        plans = self.plan_report(b, s)
        if plans:
            self.stats["plans"] = plans
        queue = RequestQueue()
        for i in range(b):
            queue.push(Request(rid=i, arrival_s=0.0,
                               prompt=np.asarray(prompts[i], np.int32),
                               max_new=max_new))
        sched = BatchScheduler(
            queue=queue,
            admission=AdmissionController(capacity=b, policy="greedy"),
            engine=self, eos_id=self.cfg.eos_id, seed=seed)
        sched.run_until_drained()
        out = np.zeros((b, max_new), np.int32)
        never_eos = 0
        for req in sched.completed:
            toks = req.tokens[:max_new]
            out[req.rid, :len(toks)] = toks
            never_eos += 0 if req.eos else 1
        self.stats["prefill_s"] += sched.wall["prefill_s"]
        self.stats["decode_s"] += sched.wall["decode_s"]
        reg = _metrics()
        reg["repro_step_wall_seconds"].observe(
            sched.wall["prefill_s"], phase="prefill")
        reg["repro_step_wall_seconds"].observe(
            sched.wall["decode_s"], phase="decode")
        self.stats["tokens"] += never_eos * max_new
        return out
