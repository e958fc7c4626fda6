"""The port's plan-bound serving tier against the JAX package.

- ``serving/{queue,admission,traffic}.py`` and ``telemetry/slo.py`` are the
  reference's text with ``repro.`` read as ``repro_torch.`` (the admission
  module below its docstring), and give the reference's outputs on the
  same seeds;
- ``PlanBinder``: the same stage / swap / prefetch scripts give the same
  counters and builds as the reference's binder;
- ``ServeEngine.serving_program`` / ``bucket_plan`` / ``plan_report`` /
  ``plan_probe`` on reduced DBRX and Kimi (one rank, ``plan_policy="auto"``,
  fabric ``2x8``) give the reference engine's fingerprints and reports, and
  repeated reports plan nothing new;
- ``PlannerProbe``, the admission decisions and the probe-mode scheduler
  (no engine: virtual time) give the reference's numbers on the same
  scripts and the same seeded traffic;
- on the CPU the engine decodes eagerly (the rule), one-shot and staggered
  continuous serving stay bit-exact, a retired cohort's slot serves a
  later cohort, and a decode on the device position equals the
  reference's decode for all four families;
- over 4 gloo ranks a continuous run crosses a batch bucket and swaps its
  plan on a pointer flip.

Both packages' engines price their programs' overlap contexts at a peak
rate (the port at the H100's, the reference at the TPU's); the engine
comparisons pass the reference's rate to the port's
``build_collective_program`` so that the programs are the same.
"""

import dataclasses
import functools
import math
import tempfile
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.serving as jserving
from repro.configs.base import get_config as jax_get_config
from repro.core import latency_model as jlm
from repro.core import plan as jplan_ir
from repro.core import planner as jplanner
from repro.core import topology as jtopo
from repro.launch.mesh import make_test_mesh
from repro.models.api import build_model as jax_build_model
from repro.parallel import context as jctx
from repro.runtime.server import ServeConfig as JaxServeConfig
from repro.runtime.server import ServeEngine as JaxServeEngine
from repro.telemetry import metrics as jmetrics
from repro.telemetry import slo as jslo
import repro_torch.serving as tserving
from repro_torch.configs.base import get_config
from repro_torch.convert import params_from_jax
from repro_torch.core import latency_model as tlm
from repro_torch.core import plan as tplan_ir
from repro_torch.core import planner as tplanner
from repro_torch.core import topology as ttopo
from repro_torch.launch import ranks
from repro_torch.launch import serve as serve_cli
from repro_torch.models.api import build_model
from repro_torch.parallel import context as tctx
from repro_torch.parallel.mesh import RankMesh
from repro_torch.runtime.graphs import decode_mode
from repro_torch.runtime.server import ServeConfig, ServeEngine
from repro_torch.telemetry import metrics as tmetrics
from repro_torch.telemetry import slo as tslo

ROOT = Path(__file__).resolve().parents[1]
TOKEN_BYTES = 14336     # bf16 x d_model 7168: the Fig 8 decode payload

JAX = types.SimpleNamespace(
    serving=jserving, plan=jplan_ir, planner=jplanner, lm=jlm, topo=jtopo,
    ctx=jctx, metrics=jmetrics)
PORT = types.SimpleNamespace(
    serving=tserving, plan=tplan_ir, planner=tplanner, lm=tlm, topo=ttopo,
    ctx=tctx, metrics=tmetrics)


def _same(a, b):
    """Equal, NaN equal to NaN (empty percentiles)."""
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    if isinstance(a, float) and math.isnan(a):
        return isinstance(b, float) and math.isnan(b)
    return a == b


# ---------------------------------------------------------------------------
# the copies
# ---------------------------------------------------------------------------

def _below_docstring(text: str) -> str:
    """A module's text after its docstring."""
    return text[text.index('"""', 3) + 3:]


@pytest.mark.parametrize("module", ["serving/queue.py",
                                    "serving/admission.py",
                                    "serving/traffic.py",
                                    "telemetry/slo.py"])
def test_serving_copy_is_verbatim(module):
    """The reference's text; the admission module's docstring leaves out
    the reference's own history."""
    ref = (ROOT / "src" / "repro" / module).read_text()
    port = (ROOT / "src" / "repro_torch" / module).read_text()
    ref = ref.replace("repro.", "repro_torch.")
    if module == "serving/admission.py":
        port, ref = _below_docstring(port), _below_docstring(ref)
    assert port == ref


def test_traffic_equals_reference():
    kw = dict(arrival_rate_rps=300.0, num_requests=40,
              prompt_lens=(16, 64), prompt_len_probs=(.3, .7),
              max_news=(4, 8), slo_classes=("interactive", "batch"),
              slo_class_probs=(.5, .5), vocab=128, seed=7)
    got = tserving.TrafficGenerator(tserving.TrafficConfig(**kw)).requests()
    want = jserving.TrafficGenerator(jserving.TrafficConfig(**kw)).requests()
    for a, b in zip(got, want, strict=True):
        assert (a.rid, a.arrival_s, a.prompt_len, a.max_new, a.slo_class) \
            == (b.rid, b.arrival_s, b.prompt_len, b.max_new, b.slo_class)
        np.testing.assert_array_equal(a.prompt, b.prompt)


def test_slo_bands_equal_reference():
    rng = np.random.default_rng(3)
    for _ in range(50):
        measured = {m: float(rng.uniform(0, 3)) for m in ("ttft", "tpot")}
        predicted = {m: float(rng.uniform(0, 1.5)) for m in ("ttft", "tpot")}
        slack = float(rng.choice([1.0, 2.0, 8.0]))
        assert tslo.classify_request(measured, predicted, slack=slack) == \
            jslo.classify_request(measured, predicted, slack=slack)
    tmetrics.reset_default_registry()
    jmetrics.reset_default_registry()
    for slo in (tslo, jslo):
        slo.observe_request({"ttft": 1.0, "tpot": 3.0},
                            {"ttft": 1.0, "tpot": 1.0})
    for metric, band in (("ttft", "good"), ("tpot", "poor")):
        assert tmetrics.default_registry()[
            "repro_request_slo_class_total"].value(metric=metric, slo=band) \
            == jmetrics.default_registry()[
                "repro_request_slo_class_total"].value(metric=metric,
                                                       slo=band) == 1


# ---------------------------------------------------------------------------
# PlanBinder
# ---------------------------------------------------------------------------

class _FakePlan:
    def __init__(self, fp):
        self.fingerprint = fp
        self.program = types.SimpleNamespace(name="prog")


def _script(name, pkg):
    """Run one stage/swap/prefetch script on ``pkg``'s PlanBinder; returns
    the builds, the calls' answers and the counters."""
    pkg.metrics.reset_default_registry()
    log = []

    def trace(plan):
        log.append(plan.fingerprint if plan else None)
        return ("lowered", plan.fingerprint if plan else None)

    binder = pkg.ctx.PlanBinder(trace, plan=_FakePlan("A"),
                                cache_size=2 if name == "lru" else 8)
    answers = []
    steps = {
        "initial": [],
        "stage_swap": [("stage", "B"), ("swap",)],
        "flip_back": [("stage", "B"), ("swap",), ("stage", "A"), ("swap",)],
        "stage_active": [("stage", "A"), ("swap",)],
        "unstaged": [("pending", "C"), ("swap",)],
        "prefetch": [("prefetch", "B"), ("prefetch", "B"), ("prefetch", "A"),
                     ("stage", "B"), ("swap",)],
        "lru": [("prefetch", "B"), ("prefetch", "C"), ("stage", "A"),
                ("swap",), ("stage", "B"), ("swap",), ("stage", "D"),
                ("swap",), ("stage", "B"), ("swap",)],
    }[name]
    for op, *arg in steps:
        if op == "stage":
            answers.append(binder.stage(_FakePlan(arg[0])))
        elif op == "prefetch":
            answers.append(binder.prefetch(_FakePlan(arg[0])))
        elif op == "pending":
            binder._pending = _FakePlan(arg[0])
        else:
            answers.append(binder.swap_if_pending())
    reg = pkg.metrics.default_registry()
    return {"log": log, "answers": answers, "artifact": binder.artifact,
            "active": binder.plan.fingerprint, "swaps": binder.swaps,
            "cold_retraces": binder.cold_retraces,
            "cache_hits": binder.cache_hits,
            "cache_misses": binder.cache_misses,
            "rebinds": reg["repro_plan_rebind_total"].value(
                program="prog", fingerprint=binder.plan.fingerprint),
            "cold_metric": reg["repro_rebind_cold_retrace_total"].value(
                program="prog")}


@pytest.mark.parametrize("name", ["initial", "stage_swap", "flip_back",
                                  "stage_active", "unstaged", "prefetch",
                                  "lru"])
def test_plan_binder_counts_as_reference(name):
    got, want = _script(name, PORT), _script(name, JAX)
    assert got == want
    if name == "stage_swap":         # the reference test's own expectations
        assert got["log"] == ["A", "B"] and got["swaps"] == 1
        assert got["cold_retraces"] == 0
    if name == "unstaged":
        assert got["cold_retraces"] == got["cold_metric"] == 1


# ---------------------------------------------------------------------------
# the engine's plan-bound methods, one rank, plan_policy="auto" on 2x8
# ---------------------------------------------------------------------------

class _Stub:
    """The reference engine's model stand-in (its plan methods read the
    config alone), as ``tests/test_serving.py`` builds it."""

    def __init__(self, cfg):
        self.cfg = cfg
    prefill = staticmethod(lambda *a: None)
    decode = staticmethod(lambda *a: None)


def _engines(arch, monkeypatch):
    """(reference, port) engines on one rank with ``plan_policy="auto"``
    on ``2x8``; the port's programs priced at the reference's peak."""
    monkeypatch.setattr(tctx, "build_collective_program", functools.partial(
        tctx.build_collective_program, peak_flops=ttopo.TPU_PEAK_FLOPS))
    jcfg = jax_get_config(arch).reduced()
    jpctx = jctx.ParallelContext(
        mesh=make_test_mesh(shape=(1,), axes=("model",)), pod_axis=None,
        data_axis="model", model_axis="model", plan_policy="auto")
    jeng = JaxServeEngine(_Stub(jcfg), None, pctx=jpctx, fabric="2x8")
    tpctx = tctx.ParallelContext(RankMesh((1, 1, 1)), plan_policy="auto")
    model = build_model(get_config(arch).reduced(), device="cpu",
                        dtype=torch.float32, pctx=tpctx)
    teng = ServeEngine(model, None, device="cpu", pctx=tpctx, fabric="2x8")
    return jeng, teng


def _report(rep):
    """A plan report without the planner's wall time."""
    rep = dict(rep)
    if "planner" in rep:
        rep["planner"] = {k: v for k, v in rep["planner"].items()
                          if k != "planning_wall_s"}
    return rep


@pytest.mark.parametrize("arch", ["dbrx_132b", "kimi_k2_1t"])
def test_plans_and_reports_equal_reference(arch, monkeypatch):
    jeng, teng = _engines(arch, monkeypatch)
    for batch, prompt_len in ((8, 32), (1, 32), (4, 512)):
        jp, tp = (e.serving_program(batch, prompt_len) for e in (jeng, teng))
        assert [s.role for s in tp.sites] == [s.role for s in jp.sites]
        assert tp.sites and teng.serving_program(batch, prompt_len) is tp
        assert teng._fresh_plan(batch, prompt_len).fingerprint == \
            jeng._fresh_plan(batch, prompt_len).fingerprint
        got, want = (_report(e.plan_report(batch, prompt_len))
                     for e in (jeng, teng))
        assert got == want
        assert {"execution_plan", "phases", "prefill", "decode"} <= set(got)
        for phase in ("prefill", "decode"):
            assert set(got[phase]) >= {"dispatch", "combine"}
    for batch in (1, 3, 5, 64):
        assert teng.bucket_plan(batch, 32).fingerprint == \
            jeng.bucket_plan(batch, 32).fingerprint
    jprobe, tprobe = jeng.plan_probe(), teng.plan_probe()
    assert teng.plan_probe() is tprobe
    assert tprobe.crossover_batch() == jprobe.crossover_batch()
    for b in (1, 2, 7, 32, 200):
        assert tprobe.decode_step_s(b) == jprobe.decode_step_s(b)


@pytest.mark.parametrize("arch", ["dbrx_132b", "kimi_k2_1t"])
def test_repeated_plan_report_plans_nothing_new(arch, monkeypatch):
    _, teng = _engines(arch, monkeypatch)
    teng.plan_report(8, 32)                       # warm
    misses0 = tplanner.default_planner().cache_info()["misses"]
    for _ in range(5):
        teng.plan_report(8, 32)
        teng.bucket_plan(8, 32)
    assert tplanner.default_planner().cache_info()["misses"] == misses0
    pl1 = teng._fresh_plan(8, 32)
    teng.invalidate_plan_cache()
    assert (8, 32) not in teng._plan_cache
    assert teng._fresh_plan(8, 32).fingerprint == pl1.fingerprint


def test_prefetch_and_rebind_count_as_reference(monkeypatch):
    """The same prefetch / rebind / swap calls on both engines: the same
    binder counters, and the port's re-bound lowering runs a model built
    against the context bound to the new plan."""
    jeng, teng = _engines("dbrx_132b", monkeypatch)
    out = []
    for eng in (jeng, teng):
        b = eng.plan_binder
        calls = [eng.prefetch_bucket(3, 32), eng.prefetch_bucket(3, 32),
                 eng.rebind(eng.bucket_plan(16, 32)), b.swap_if_pending(),
                 eng.rebind(eng.bucket_plan(4, 32)), b.swap_if_pending()]
        out.append((calls, b.swaps, b.cold_retraces, b.cache_hits,
                    b.cache_misses, b.plan.fingerprint))
    assert out[0] == out[1]
    assert out[1][0] == [True, False, True, True, True, True]
    lowering = teng.plan_binder.artifact
    assert lowering.pctx.execution_plan is teng.plan_binder.plan
    assert lowering.model.pctx is lowering.pctx
    assert lowering.decode.model is lowering.model
    assert teng.execution_plan(4, 32) is teng.plan_binder.plan


def test_engine_refuses_the_telemetry_loop():
    """The engine refused a store and a monitor until the port had the
    telemetry loop; it takes both now (parity with the reference's engine:
    ``tests/test_torch_telemetry.py``), and without a context its report is
    the monitor's alone, as the reference's."""
    from repro_torch.telemetry import CalibrationStore, DriftMonitor
    model = build_model(get_config("dbrx_132b").reduced(), device="cpu",
                        dtype=torch.float32)
    store = CalibrationStore(":memory:")
    monitor = DriftMonitor(tplanner.Planner(), store,
                           ttopo.get_fabric("2x8"))
    eng = ServeEngine(model, None, device="cpu", calibration=store,
                      monitor=monitor)
    assert eng.monitor is monitor and eng.pctx is None
    assert eng.plan_report(4, 32) == {"calibration": monitor.report()}


# ---------------------------------------------------------------------------
# PlannerProbe, admission and the probe-mode scheduler
# ---------------------------------------------------------------------------

def _probe(pkg):
    return pkg.serving.PlannerProbe(pkg.topo.get_fabric("2x8"),
                                    token_bytes=TOKEN_BYTES)


def test_planner_probe_equals_reference():
    jp, tp = _probe(JAX), _probe(PORT)
    assert tp.crossover_batch() == jp.crossover_batch() != math.inf
    for b in (1, 2, 3, 8, 31, 64, 100, 256, 1024):
        assert tp.decode_step_s(b) == jp.decode_step_s(b)
        assert tp.decode_step_s(b, bound_batch=1) == \
            jp.decode_step_s(b, bound_batch=1)
        assert tp.scheme_at(b) == jp.scheme_at(b)
        for s in (16, 128, 512):
            assert tp.prefill_s(b, s) == jp.prefill_s(b, s)


def _admission(name, pkg):
    """One admission script of ``tests/test_serving.py``; returns the
    decisions and the controller's counters."""
    pkg.metrics.reset_default_registry()
    probe = _probe(pkg)
    xover = int(probe.crossover_batch())
    slo = probe.decode_step_s(xover) * 1.05
    A = pkg.serving.AdmissionController
    if name == "hold":
        adm = A(probe, capacity=4 * xover, policy="planner", tpot_slo_s=slo,
                ttft_slo_s=0.08)
        decs = [adm.decide(in_flight=xover, ready=xover),
                adm.decide(in_flight=1, ready=3 * xover)]
    elif name == "greedy":
        adm = A(probe, capacity=4 * xover, policy="greedy", tpot_slo_s=slo)
        decs = [adm.decide(in_flight=xover, ready=xover),
                adm.decide(in_flight=0, ready=0)]
    elif name == "ttft_pressure":
        adm = A(probe, capacity=4 * xover, policy="planner", tpot_slo_s=slo,
                ttft_slo_s=0.08)
        decs = [adm.decide(in_flight=xover, ready=xover, oldest_wait_s=0.05)]
    elif name == "bucket":
        adm = A(probe, capacity=8 * xover, policy="planner",
                tpot_slo_s=probe.decode_step_s(8 * xover) * 2,
                ttft_slo_s=0.08, max_join=xover)
        decs = [adm.decide(in_flight=xover // 2, ready=xover // 2,
                           bound_bucket=xover // 2),
                adm.decide(in_flight=1, ready=1, bound_bucket=2),
                adm.decide(in_flight=3, ready=4 * xover, bound_bucket=4)]
    else:
        adm = A(probe, capacity=4, policy="greedy")
        decs = [adm.decide(in_flight=4, ready=3)]
    return ([dataclasses.astuple(d) for d in decs], adm.holds,
            adm.held_requests, adm.rejected)


@pytest.mark.parametrize("name", ["hold", "greedy", "ttft_pressure",
                                  "bucket", "capacity"])
def test_admission_decides_as_reference(name):
    got, want = _admission(name, PORT), _admission(name, JAX)
    assert got == want
    reasons = [d[-1] for d in got[0]]
    expect = {"hold": "tpot_slo_hold", "greedy": "greedy",
              "ttft_pressure": "ttft_pressure",
              "bucket": "crossover_rebind", "capacity": "capacity"}[name]
    assert reasons[0] == expect


def _bucket_plans(pkg):
    """Decode-site plans per batch bucket on 2x8 (the reference test's
    ``plan_for_bucket``)."""
    topo = pkg.topo.get_fabric("2x8")

    def plan_for_bucket(bucket):
        sites = pkg.plan.moe_sites(
            "decode", num_experts=64, top_k=8, tokens_per_rank=bucket,
            token_bytes=TOKEN_BYTES,
            compute_s=pkg.lm.expert_compute_time_s(bucket, 8, 7168, 2048))
        return pkg.planner.default_planner().plan_program(
            pkg.plan.CollectiveProgram("serve", sites), topo, None)
    return plan_for_bucket


def _schedule(name, pkg):
    """One probe-mode scheduler script (no engine); returns the report,
    every request's stamps and predictions, and the binder's counters."""
    pkg.metrics.reset_default_registry()
    S = pkg.serving
    probe = _probe(pkg)
    kw = {}
    greedy = S.AdmissionController(probe, capacity=64, policy="greedy")
    R = S.Request
    if name == "join_exit":
        reqs = [R(rid=0, arrival_s=0.0, prompt_len=16, max_new=2),
                R(rid=1, arrival_s=0.0, prompt_len=16, max_new=64),
                R(rid=2, arrival_s=1e-3, prompt_len=16, max_new=4)]
    elif name == "static":
        reqs = [R(rid=0, arrival_s=0.0, prompt_len=16, max_new=32),
                R(rid=1, arrival_s=1e-4, prompt_len=16, max_new=4)]
        kw["static_batching"] = True
    elif name == "bucket_growth":
        reqs = [R(rid=i, arrival_s=0.0, prompt_len=16, max_new=8)
                for i in range(4)]
        reqs += [R(rid=4 + i, arrival_s=2e-3, prompt_len=16, max_new=8)
                 for i in range(28)]
        plan_for_bucket = _bucket_plans(pkg)
        kw.update(binder=pkg.ctx.PlanBinder(
            lambda p: {"fp": p.fingerprint}, plan=plan_for_bucket(4)),
            plan_for_bucket=plan_for_bucket)
        greedy = S.AdmissionController(
            probe, capacity=64, policy="planner",
            tpot_slo_s=probe.decode_step_s(64) * 2.0, ttft_slo_s=0.08)
    else:                                  # a seeded stream, a tight SLO
        reqs = S.TrafficGenerator(S.TrafficConfig(
            arrival_rate_rps=20000.0, num_requests=48, prompt_lens=(64,),
            max_news=(4, 16), slo_classes=("interactive", "batch"),
            seed=5)).requests()
        greedy = S.AdmissionController(
            probe, capacity=48, policy="planner",
            tpot_slo_s=probe.decode_step_s(4) * 1.01, ttft_slo_s=0.002)
    q = S.RequestQueue()
    for r in reqs:
        q.push(r)
    sched = S.BatchScheduler(queue=q, probe=probe, admission=greedy, **kw)
    if name == "traffic":
        sched.run_for(5e-4)
    sched.run_until_drained()
    rep = sched.report(ttft_slo_s=0.08,
                       tpot_slo_s=probe.decode_step_s(64) * 1.15)
    stamps = sorted((r.rid, r.admit_s, r.first_token_s, r.finish_s,
                     r.predicted_ttft_s, r.predicted_tpot_s, r.emitted)
                    for r in sched.completed)
    reg = pkg.metrics.default_registry()
    return {"report": rep, "stamps": stamps,
            "bound_bucket": sched.bound_bucket,
            "admitted": reg["repro_requests_total"].value(outcome="admitted")}


@pytest.mark.parametrize("name", ["join_exit", "static", "bucket_growth",
                                  "traffic"])
def test_probe_mode_scheduler_equals_reference(name):
    got, want = _schedule(name, PORT), _schedule(name, JAX)
    assert _same(got, want)
    assert got["report"]["completed"] == len(got["stamps"]) > 0
    if name == "bucket_growth":
        assert got["report"]["plan_swaps"] >= 1
        assert got["report"]["cold_retraces"] == 0
        assert got["bound_bucket"] == 32
    if name == "traffic":
        assert got["report"]["admission_holds"] > 0


# ---------------------------------------------------------------------------
# the engine on the CPU: eager by the rule, slots, bit-exact serving
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def rwkv_engines():
    """Reference and port engines on the same reduced RWKV-6 parameters
    (the reference's own bit-exact continuous test uses this family)."""
    kw = dict(n_layers=2, d_model=32, n_heads=2, d_ff=64, vocab=64)
    cfg = get_config("rwkv6_7b").reduced(**kw)
    jmodel = jax_build_model(jax_get_config("rwkv6_7b").reduced(**kw),
                             dtype=jnp.float32)
    jparams = jmodel.init(jax.random.key(0))
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                              cfg, device="cpu", dtype=torch.float32)
    jeng = JaxServeEngine(jmodel, jparams, JaxServeConfig(
        max_new_tokens=6, cache_dtype=jnp.float32))
    teng = ServeEngine(build_model(cfg, device="cpu", dtype=torch.float32),
                       tparams, ServeConfig(max_new_tokens=6,
                                            cache_dtype=torch.float32),
                       device="cpu")
    return cfg, jeng, teng


def test_cpu_decode_is_eager_by_the_rule(rwkv_engines):
    _, _, teng = rwkv_engines
    g = teng.stats["decode_graph"]
    assert (g["mode"], g["reason"]) == decode_mode(torch.device("cpu"))
    assert g["mode"] == "eager" and "cpu" in g["reason"]
    prompts = np.zeros((2, 4), np.int32)
    before = dict(g)
    teng.generate(prompts, max_new=4)
    assert g["eager_rounds"] - before["eager_rounds"] == 3
    assert g["captures"] == g["replays"] == 0


def test_gloo_ranks_decode_eagerly(tmp_path):
    """A CUDA device under gloo process groups decodes eagerly, with the
    reason; one rank with no groups, or nccl, is graphed."""
    import torch.distributed as dist
    assert decode_mode(torch.device("cuda"))[0] == "graph"
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/s",
                            rank=0, world_size=1)
    try:
        pctx = tctx.ParallelContext(RankMesh((1, 1, 1)))
        mode, reason = decode_mode(torch.device("cuda"), pctx)
    finally:
        dist.destroy_process_group()
    assert mode == "eager" and "gloo" in reason and "host" in reason
    assert decode_mode(torch.device("cuda"), pctx)[0] == "graph"


def test_generate_and_staggered_serving_match_reference(rwkv_engines):
    cfg, jeng, teng = rwkv_engines
    prompts = np.random.default_rng(2).integers(
        0, 64, size=(4, 8)).astype(np.int32)
    one_shot = teng.generate(prompts)
    np.testing.assert_array_equal(one_shot, jeng.generate(prompts))
    # a later call of the same shape takes the retired cohort's slot
    decoder = teng.plan_binder.artifact.decode
    free = [s.key for s in decoder._free.values()]
    assert (4, 14) in free
    np.testing.assert_array_equal(teng.generate(prompts), one_shot)
    assert [s.key for s in decoder._free.values()].count((4, 14)) == 1
    assert len(decoder._free) == len(free)
    for capacity in (1, 2, 3):
        q = tserving.RequestQueue()
        for i in range(4):
            q.push(tserving.Request(rid=i, arrival_s=0.002 * i,
                                    prompt=prompts[i], max_new=6))
        sched = tserving.BatchScheduler(
            queue=q, admission=tserving.AdmissionController(
                capacity=capacity, policy="greedy"),
            engine=teng, seed=0)
        sched.run_until_drained()
        out = np.zeros_like(one_shot)
        for r in sched.completed:
            out[r.rid] = r.tokens[:6]
        np.testing.assert_array_equal(out, one_shot)
        assert not sched.cohorts


@pytest.mark.parametrize("family", ["dense", "moe", "hybrid", "rwkv"])
def test_decode_on_the_device_position_equals_reference(family):
    arch = {"dense": "dbrx_132b", "moe": "dbrx_132b", "hybrid": "zamba2_7b",
            "rwkv": "rwkv6_7b"}[family]
    jcfg, cfg = jax_get_config(arch).reduced(), get_config(arch).reduced()
    if family == "dense":
        jcfg = dataclasses.replace(jcfg, family="dense", num_experts=0)
        cfg = dataclasses.replace(cfg, family="dense", num_experts=0)
    jmodel = jax_build_model(jcfg, dtype=jnp.float32)
    jparams = jmodel.init(jax.random.key(3))
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                              cfg, device="cpu", dtype=torch.float32)
    model = build_model(cfg, device="cpu", dtype=torch.float32)
    toks = np.random.default_rng(9).integers(
        0, cfg.vocab, size=(2, 8)).astype(np.int32)
    jcache = jmodel.init_cache(2, 14, jnp.float32)
    tcache = model.init_cache(2, 14, torch.float32)
    jl, jcache = jax.jit(jmodel.prefill)(
        jparams, {"tokens": jnp.asarray(toks)}, jcache)
    jdecode = jax.jit(jmodel.decode)
    with torch.inference_mode():
        tl, tcache = model.prefill(tparams,
                                   {"tokens": torch.from_numpy(toks)}, tcache)
        assert int(tcache["pos"]) == tcache["len"] == 8
        for step in range(5):
            nxt = np.array(jnp.argmax(jl, axis=-1), np.int32)[:, None]
            jl, jcache = jdecode(jparams, {"tokens": jnp.asarray(nxt)},
                                 jcache)
            tl, tcache = model.decode_step(
                tparams, {"tokens": torch.from_numpy(nxt)}, tcache)
            np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                       atol=1e-4, rtol=1e-4)
            # the step advanced the device position, not the host length
            assert int(tcache["pos"]) == 9 + step and tcache["len"] == 8
    assert int(jcache["len"]) == int(tcache["pos"]) == 13


def test_launcher_serves_a_continuous_stream(capsys):
    out = serve_cli.main(["--arch", "dbrx_132b", "--device", "cpu",
                          "--smoke", "--continuous", "--requests", "6",
                          "--prompts", "3", "--prompt-len", "8",
                          "--max-new", "3", "--arrival-rate", "3000"])
    rep = out["report"]
    assert rep["completed"] == 6 and rep["pending"] == 0
    assert out["decode_graph"]["mode"] == "eager"
    text = capsys.readouterr().out
    assert "served 6/6 request(s)" in text and "decode: eager" in text


def test_continuous_over_ranks_swaps_the_bucket_plan():
    """4 gloo ranks (2 x 2), groups of one request a rank: the admission
    grows the batch from one bucket into the next, the engine's binder
    swaps to the prefetched plan without a cold retrace, and every rank
    returns the same tokens."""
    cfg = serve_cli.serve_config("dbrx_132b", layers=None, smoke=True)
    with tempfile.TemporaryDirectory() as tmp:
        spec = dict(world=4, pods=2, ep=2, backend="gloo", device="cpu",
                    init_method=f"file://{tmp}/store", timeout_s=120,
                    out_dir=f"{tmp}/out", threads=1, cfg=cfg,
                    dtype=torch.float32, cache_dtype=torch.float32, seed=0,
                    prompts=serve_cli.make_prompts(cfg, 4, 8), max_new=3,
                    runs=[dict(scheme="hierarchical",
                               combine="hierarchical")],
                    continuous=dict(requests=12, prompt_len=8, max_new=4,
                                    rate=1e5, capacity=8))
        results = ranks.run_ranks(ranks.serve_worker, spec, timeout_s=300)
    c0 = results[0]["continuous"]
    rep = c0["report"]
    assert rep["completed"] == 12 and rep["max_in_flight"] == 8
    assert rep["plan_swaps"] >= 1 and rep["cold_retraces"] == 0
    assert c0["bound_bucket"] == 8
    assert c0["decode_graph"]["mode"] == "eager"
    assert all(r["continuous"]["tokens"] == c0["tokens"] for r in results)
    assert all(len(t) == 4 for t in c0["tokens"].values())
