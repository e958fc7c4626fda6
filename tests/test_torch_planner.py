"""The port's planner slice against the JAX package.

- The control-plane modules the port copies (telemetry metrics, topology,
  MultiWrite simulator, plan IR, latency model, schedules, planner) are the
  reference's text with ``repro.`` read as ``repro_torch.``.
- For the same program, fabric and hardware model both packages plan the
  same ``ExecutionPlan`` (fingerprint and every decision), each with a
  fresh ``Planner`` (the process-wide one caches decisions).
- ``ParallelContext.moe_pipeline_kwargs`` resolves as the reference's does
  (bound plan, then ``auto``, then the fixed knobs; the re-resolve at an
  executed G), and ``bind`` refuses a plan made on a foreign fabric.

Contexts here need no process group: both packages' ``ParallelContext``
read only the mesh's axis sizes for planning, so a stand-in mesh of the
2 pods x 2 ep shape serves both.
"""

import dataclasses
import math
from pathlib import Path

import jax  # noqa: F401  (keeps JAX on the CPU before torch is imported)
import pytest

from repro.configs.base import get_config as jax_get_config
from repro.core import plan as jplan_ir
from repro.core import planner as jplanner
from repro.core import topology as jtopo
from repro.core.latency_model import TOKEN_BYTES, expert_compute_time_s
from repro.models.api import param_count_shape_only
from repro.parallel import context as jctx
from repro_torch.configs.base import get_config
from repro_torch.core import h100
from repro_torch.core import plan as plan_ir
from repro_torch.core import planner as tplanner
from repro_torch.core import topology as ttopo
from repro_torch.models.api import \
    param_count_shape_only as torch_param_count
from repro_torch.parallel import context as tctx
from repro_torch.parallel.mesh import AXES, RankMesh

ROOT = Path(__file__).resolve().parents[1]
COPIES = ("telemetry/metrics.py", "core/topology.py", "core/multiwrite.py",
          "core/plan.py", "core/latency_model.py", "core/schedules.py",
          "core/planner.py")
FABRICS = ("mesh8", "2x8", "2x8asym", "tpu_2x16")
# DBRX serving on 4 prompts of 512 tokens
SERVE = {"prefill": (4, 512), "decode": (4, 1)}


@pytest.mark.parametrize("module", COPIES)
def test_copy_is_verbatim(module):
    ref = (ROOT / "src" / "repro" / module).read_text()
    port = (ROOT / "src" / "repro_torch" / module).read_text()
    assert port == ref.replace("repro.", "repro_torch.")


class StandInMesh:
    """The axis sizes of a (pods, data, model) mesh, for both packages'
    contexts: ``shape`` as a JAX mesh has it, ``axis_size`` as a RankMesh
    has it."""

    def __init__(self, pods, data, model=1):
        self.shape = dict(zip(AXES, (pods, data, model)))

    def axis_size(self, *names):
        return math.prod(self.shape[a] for a in names)


def contexts(fabric, **kw):
    """(reference, port) contexts on a 2 x 2 x 1 mesh and one fabric."""
    mesh = StandInMesh(2, 2)
    return (jctx.ParallelContext(mesh=mesh, pod_axis="pod", fabric=fabric(
                jtopo), **kw),
            tctx.ParallelContext(mesh, pod_axis="pod", fabric=fabric(ttopo),
                                 **kw))


def named(name):
    return lambda topo: topo.get_fabric(name)


def failed_2x8(topo):
    """2x8 with one pod rail at half rate and one relay down."""
    return topo.get_fabric("2x8").with_failures(topo.FailureState(
        degraded_links={(0, 8): 0.5}, dead_relays={3}))


def decisions(eplan) -> dict:
    """Every decision of a plan, per site and per coupled group, as plain
    values."""
    def row(d):
        return (d.op, d.plan, tuple(d.knobs), d.predicted_s, d.baseline_s,
                d.predicted_serial_s, d.predicted_ideal_s,
                dict(d.shard_map_kwargs), tuple(d.candidates))
    return {"sites": {r: row(d) for r, d in eplan.decisions.items()},
            "joint": {r: row(d) for r, d in eplan.joint.items()},
            "group_of": dict(eplan.group_of)}


def plan_both(fabric, phases, *, budgets=None, arch_cfg=None):
    """The reference's and the port's ExecutionPlan of one program, each
    from a fresh Planner on its own package's topology."""
    jp, tp = contexts(fabric)
    jcfg = arch_cfg(jax_get_config) if arch_cfg else \
        jax_get_config("dbrx_132b")
    tcfg = arch_cfg(get_config) if arch_cfg else get_config("dbrx_132b")
    jprog = jctx.build_collective_program(jcfg, jp, "serve", phases,
                                          phase_budgets=budgets)
    tprog = tctx.build_collective_program(
        tcfg, tp, "serve", phases, phase_budgets=budgets,
        peak_flops=ttopo.TPU_PEAK_FLOPS)
    assert tprog.cache_key() == jprog.cache_key()
    plans = []
    for pctx, prog, planner in ((jp, jprog, jplanner),
                                (tp, tprog, tplanner)):
        topo, hw = pctx._plan_topo_hw(16)
        plans.append(planner.Planner().plan_program(prog, topo, hw))
    return plans


@pytest.mark.parametrize("fabric", [named(f) for f in FABRICS]
                         + [failed_2x8], ids=list(FABRICS) + ["2x8-failed"])
def test_serve_plan_equals_reference(fabric):
    jplan, tplan = plan_both(fabric, SERVE)
    assert tplan.fingerprint == jplan.fingerprint
    assert decisions(tplan) == decisions(jplan)
    assert tplan.topo_fingerprint == jplan.topo_fingerprint


def test_serve_plan_with_a_decode_budget_equals_reference():
    jplan, tplan = plan_both(named("2x8"), SERVE, budgets={"decode": 2e-4})
    assert tplan.fingerprint == jplan.fingerprint
    assert decisions(tplan) == decisions(jplan)
    for phase in SERVE:
        for key in ("budget_s", "budget_ok", "score_s", "contention_s"):
            assert (tplan.phase_report[phase].get(key)
                    == jplan.phase_report[phase].get(key)), (phase, key)


@pytest.mark.parametrize("fabric", ["2x8", "tpu_2x16"])
def test_train_plan_with_grad_sync_equals_reference(fabric):
    jplan, tplan = plan_both(named(fabric), {"train": (8, 64)},
                             arch_cfg=lambda g: g("dbrx_132b").reduced())
    assert "train/grad_sync" in tplan.decisions
    assert tplan.fingerprint == jplan.fingerprint
    assert decisions(tplan) == decisions(jplan)


@pytest.mark.parametrize("reduced", [True, False], ids=["reduced", "full"])
def test_train_program_counts_the_port_models_parameters(reduced):
    jcfg, tcfg = jax_get_config("dbrx_132b"), get_config("dbrx_132b")
    if reduced:
        jcfg, tcfg = jcfg.reduced(), tcfg.reduced()
    assert torch_param_count(tcfg) == param_count_shape_only(jcfg)
    jp, tp = contexts(named("2x8"))
    jsite = jctx.build_collective_program(jcfg, jp, "t", {"train": (8, 64)}
                                          ).site("train/grad_sync")
    tsite = tctx.build_collective_program(
        tcfg, tp, "t", {"train": (8, 64)},
        peak_flops=ttopo.TPU_PEAK_FLOPS).site("train/grad_sync")
    assert tsite.key() == jsite.key()
    assert tsite.payload_bytes == jsite.payload_bytes


def test_h100_peak_moves_only_the_overlap_context():
    """At the H100's peak the program's MoE sites differ from the
    reference's only in their overlap context, which is 197 / 989.4 of the
    TPU's."""
    jp, tp = contexts(named("2x8"))
    jprog = jctx.build_collective_program(jax_get_config("dbrx_132b"), jp,
                                          "serve", SERVE)
    tprog = tctx.build_collective_program(get_config("dbrx_132b"), tp,
                                          "serve", SERVE)
    for js, ts in zip(jprog.sites, tprog.sites):
        assert (ts.role, ts.payload_bytes) == (js.role, js.payload_bytes)
        assert ts.compute_ctx == pytest.approx(
            js.compute_ctx * ttopo.TPU_PEAK_FLOPS / h100.H100_BF16_PEAK_FLOPS)
    assert h100.fabric_spec(2, 2, 123.456e9) == "2x2@123.5:123.5"
    assert h100.fabric_spec(2, 2, 150e9, 12.5e9) == "2x2@12.5:150"
    topo = ttopo.get_fabric(h100.fabric_spec(2, 2, 150e9, 12.5e9))
    assert (topo.num_nodes, topo.link(0, 1).bw, topo.link(0, 2).bw) == (
        4, 150e9, 12.5e9)


# ---------------------------------------------------------------------------
# moe_pipeline_kwargs: the cases of tests/test_overlap.py's
# TestContextThreading, against the reference
# ---------------------------------------------------------------------------

def compute_ctx(batch, top_k=8, d_model=7168, f_shard=2048):
    return expert_compute_time_s(batch, top_k, d_model, f_shard)


@pytest.fixture(scope="module")
def overlap_contexts():
    """The reference's and the port's auto contexts of one rank on the
    paper's two-server fabric, as ``test_overlap.py`` makes them."""
    from repro.launch.mesh import make_test_mesh
    jp = jctx.ParallelContext(
        mesh=make_test_mesh(shape=(1,), axes=("model",)), pod_axis=None,
        data_axis="model", model_axis="model", plan_policy="auto",
        fabric=jtopo.two_server_cluster())
    tp = tctx.ParallelContext(
        RankMesh((1, 1, 1)), pod_axis=None, data_axis="model",
        model_axis="model", plan_policy="auto",
        fabric=ttopo.two_server_cluster())
    return jp, tp


@pytest.mark.parametrize("case", [
    dict(tokens_per_rank=2048, compute_s=compute_ctx(2048)),
    dict(tokens_per_rank=2048, compute_s=compute_ctx(2048), microbatch=2),
    dict(tokens_per_rank=2048, compute_s=compute_ctx(2048), microbatch=1),
    dict(tokens_per_rank=8),
    dict(tokens_per_rank=8, microbatch=4),
], ids=["large", "large-at-g2", "large-at-g1", "small", "small-at-g4"])
@pytest.mark.parametrize("policy", ["auto", "fixed"])
def test_pipeline_kwargs_equal_reference(overlap_contexts, case, policy):
    jp, tp = overlap_contexts
    if policy == "fixed":
        jp, tp = (dataclasses.replace(p, plan_policy="fixed",
                                      moe_scheme="baseline", moe_microbatch=4)
                  for p in (jp, tp))
    args = dict(token_bytes=TOKEN_BYTES, **case)
    got = tp.moe_pipeline_kwargs(64, 8, **args)
    assert got == jp.moe_pipeline_kwargs(64, 8, **args)
    if policy == "auto" and "microbatch" not in case:
        assert (got["microbatch"] > 1) == (case["tokens_per_rank"] == 2048)
    if policy == "fixed" and "microbatch" not in case:
        assert got == {"moe_scheme": "baseline", "moe_combine": "baseline",
                       "microbatch": 4}


@pytest.mark.parametrize("g", [None, 1, 2])
def test_bound_plan_resolves_as_reference(overlap_contexts, g):
    """A planned program bound on both sides: the declared workload is a
    lookup (at an executed G too), an undeclared one falls back to auto."""
    jp, tp = overlap_contexts
    ask = dict(num_experts=64, top_k=8, tokens_per_rank=2048,
               token_bytes=TOKEN_BYTES, compute_s=compute_ctx(2048))
    bound = []
    for pctx, planner, plan_mod in ((jp, jplanner, jplan_ir),
                                    (tp, tplanner, plan_ir)):
        program = plan_mod.CollectiveProgram(
            "serve", pctx.moe_sites("prefill", **ask))
        topo, hw = pctx._plan_topo_hw(64)
        bound.append(pctx.bind(planner.Planner().plan_program(
            program, topo, hw)))
    jb, tb = bound
    for kw in (ask, dict(ask, tokens_per_rank=8, compute_s=0.0)):
        got = tb.moe_pipeline_kwargs(**kw, microbatch=g)
        assert got == jb.moe_pipeline_kwargs(**kw, microbatch=g)
        if g is not None:
            assert got["microbatch"] == g


def test_bind_refuses_a_foreign_fabric():
    _, tp = contexts(named("2x8"))
    ask = dict(num_experts=16, top_k=4, tokens_per_rank=512,
               token_bytes=12288)
    program = plan_ir.CollectiveProgram("serve",
                                        tp.moe_sites("prefill", **ask))
    foreign = tplanner.Planner().plan_program(program,
                                              ttopo.get_fabric("4x8"))
    with pytest.raises(ValueError, match="replan the program"):
        tp.bind(foreign)
    failed = failed_2x8(ttopo)
    variant = tplanner.Planner().plan_program(program, failed)
    assert tp.bind(variant).execution_plan is variant
    pinned = plan_ir.pinned_execution_plan(program, {
        "prefill/moe_dispatch": {"moe_scheme": "baseline",
                                 "microbatch": 2}})
    assert tp.bind(pinned).moe_pipeline_kwargs(**ask) == {
        "moe_scheme": "baseline", "moe_combine": "baseline",
        "microbatch": 2}


def test_resolved_kwargs_are_kept_on_the_context(monkeypatch):
    """The second ask of the same workload is answered from the context,
    as a copy; another context (a bound one is another) asks afresh."""
    _, tp = contexts(named("2x8"), plan_policy="auto")
    calls = []
    real = tctx.ParallelContext._resolve_pipeline_kwargs

    def counted(self, *args):
        calls.append(args)
        return real(self, *args)
    monkeypatch.setattr(tctx.ParallelContext, "_resolve_pipeline_kwargs",
                        counted)
    ask = dict(num_experts=16, top_k=4, tokens_per_rank=512,
               token_bytes=12288, compute_s=1e-4)
    first = tp.moe_pipeline_kwargs(**ask)
    first["moe_scheme"] = "changed"
    assert tp.moe_pipeline_kwargs(**ask)["moe_scheme"] != "changed"
    assert len(calls) == 1
    tp.moe_pipeline_kwargs(**ask, microbatch=1)
    dataclasses.replace(tp, moe_skew=0.0).moe_pipeline_kwargs(**ask)
    assert len(calls) == 3


def test_bind_counts_into_the_metrics_registry():
    from repro_torch.telemetry import metrics
    counter = metrics.default_registry()["repro_plan_bind_total"]
    _, tp = contexts(named("2x8"))
    program = plan_ir.CollectiveProgram("count-me", tp.moe_sites(
        "prefill", num_experts=16, top_k=4, tokens_per_rank=512,
        token_bytes=12288))
    eplan = tp.plan_collectives(program)
    labels = dict(program="count-me", fingerprint=eplan.fingerprint)
    before = counter.value(**labels)
    tp.bind(eplan)
    assert counter.value(**labels) == before + 1


def test_bound_plan_stale_equals_reference(overlap_contexts):
    """Each side with its own fresh Planner: nothing bound cannot be
    judged, a bound plan is current, and it is stale once a recalibration
    (a 200x operator start-up alpha, as ``test_contention.py``'s) replans
    its program into another plan."""
    ask = dict(num_experts=64, top_k=8, tokens_per_rank=4096,
               token_bytes=TOKEN_BYTES, compute_s=compute_ctx(4096))
    seen = []
    for pctx, planner_mod, plan_mod in zip(overlap_contexts,
                                           (jplanner, tplanner),
                                           (jplan_ir, plan_ir)):
        planner = planner_mod.Planner()
        states = [pctx.bound_plan_stale(planner)]
        program = plan_mod.CollectiveProgram(
            "serve", pctx.moe_sites("prefill", **ask))
        topo, hw = pctx._plan_topo_hw(64)
        bound = pctx.bind(planner.plan_program(program, topo, hw))
        states.append(bound.bound_plan_stale(planner))
        planner.refresh_hardware(dataclasses.replace(
            planner.hw, alpha_base=planner.hw.alpha_base * 200))
        changed = [e["changed"] for e in planner.replan_programs()]
        states += [bound.bound_plan_stale(planner), changed]
        seen.append(states)
    assert seen[1] == seen[0] == [None, False, True, [True]]


@pytest.mark.parametrize("frag", [8 << 20, 1 << 20],
                         ids=["declared", "undeclared"])
def test_allgather_plan_equals_reference(overlap_contexts, frag):
    """A plan holding the split-TP AllGather site (as
    ``test_program.py``'s binding test) answers the declared fragment size
    from the plan and leaves another to the fixed knobs (None), as the
    reference's context does; an unbound fixed context answers None."""
    got = []
    for pctx, planner_mod, plan_mod, topo_mod in zip(
            overlap_contexts, (jplanner, tplanner), (jplan_ir, plan_ir),
            (jtopo, ttopo)):
        fixed = dataclasses.replace(pctx, plan_policy="fixed")
        assert fixed.allgather_plan(frag) is None
        split, _ = topo_mod.split_tp_full_mesh(8, tp=4)
        site = plan_mod.allgather_site("train", frag_bytes=8 << 20,
                                       num_domains=2, topo=split)
        topo, hw = pctx._plan_topo_hw(0)
        eplan = planner_mod.Planner().plan_program(
            plan_mod.CollectiveProgram("train", (site,)), topo, hw)
        d = fixed.bind(eplan).allgather_plan(frag, num_domains=2)
        got.append(None if d is None else
                   (d.plan, tuple(d.knobs), d.predicted_s, eplan.fingerprint))
    assert got[1] == got[0]
    assert (got[1] is not None) == (frag == 8 << 20)


@pytest.mark.parametrize("fabric", ["2x8", "tpu_2x16"])
def test_moe_skew_prices_as_reference(fabric):
    """A hot-expert skew reaches the planner through ``moe_sites`` and the
    ad-hoc ``auto`` path on both sides alike, and moves the priced
    round trip (as ``test_telemetry.py``'s threading test)."""
    ask = dict(num_experts=16, top_k=4, tokens_per_rank=256,
               token_bytes=12288, compute_s=1e-4)
    predicted = {}
    for skew in (0.0, 2.0):
        jp, tp = contexts(named(fabric), plan_policy="auto", moe_skew=skew)
        assert tp.moe_pipeline_kwargs(**ask) == \
            jp.moe_pipeline_kwargs(**ask)
        plans = []
        for pctx, planner_mod, plan_mod in ((jp, jplanner, jplan_ir),
                                            (tp, tplanner, plan_ir)):
            program = plan_mod.CollectiveProgram(
                "skew", pctx.moe_sites("prefill", **ask))
            topo, hw = pctx._plan_topo_hw(16)
            plans.append(planner_mod.Planner().plan_program(program, topo,
                                                            hw))
        assert plans[1].fingerprint == plans[0].fingerprint
        assert decisions(plans[1]) == decisions(plans[0])
        predicted[skew] = plans[1].decision("prefill/moe_dispatch"
                                            ).predicted_s
    assert predicted[2.0] != predicted[0.0]


# ---------------------------------------------------------------------------
# Kimi-K2-1T at 2 pods x 8 ep ranks (384 experts, 24 a rank)
# ---------------------------------------------------------------------------

# one prompt of 512 tokens a rank over the 16 ranks
KIMI_SERVE = {"prefill": (16, 512), "decode": (16, 1)}


@pytest.mark.parametrize("fabric", [None, "2x8"],
                         ids=["mesh-derived", "2x8"])
def test_kimi_at_2x8_plans_as_reference(fabric):
    """``moe_pipeline_kwargs(384, 8, ...)`` at Kimi's prefill and decode
    rows a rank, and the ExecutionPlan of its serve program, on the
    mesh-derived default fabric and on ``2x8``: the reference's decisions
    and fingerprint, EP over all 16 ranks."""
    mesh = StandInMesh(2, 8)
    jp = jctx.ParallelContext(
        mesh=mesh, pod_axis="pod", plan_policy="auto",
        fabric=jtopo.get_fabric(fabric) if fabric else None)
    tp = tctx.ParallelContext(
        mesh, pod_axis="pod", plan_policy="auto",
        fabric=ttopo.get_fabric(fabric) if fabric else None)
    assert tp.ep_ranks(384) == jp.ep_ranks(384) == (True, 16)
    jcfg, tcfg = jax_get_config("kimi_k2_1t"), get_config("kimi_k2_1t")
    for batch, seq in KIMI_SERVE.values():
        n = batch * seq // 16
        ask = dict(tokens_per_rank=n, token_bytes=tcfg.d_model * 2,
                   compute_s=expert_compute_time_s(n, 8, 7168, 2048))
        assert (tp.moe_pipeline_kwargs(384, 8, **ask)
                == jp.moe_pipeline_kwargs(384, 8, **ask))
    jprog = jctx.build_collective_program(jcfg, jp, "serve", KIMI_SERVE)
    tprog = tctx.build_collective_program(tcfg, tp, "serve", KIMI_SERVE,
                                          peak_flops=ttopo.TPU_PEAK_FLOPS)
    assert tprog.cache_key() == jprog.cache_key()
    plans = [planner.Planner().plan_program(prog, *pctx._plan_topo_hw(384))
             for pctx, prog, planner in ((jp, jprog, jplanner),
                                         (tp, tprog, tplanner))]
    assert plans[1].fingerprint == plans[0].fingerprint
    assert decisions(plans[1]) == decisions(plans[0])
