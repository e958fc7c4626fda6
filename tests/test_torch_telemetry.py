"""The port's telemetry loop against the JAX package.

- ``telemetry/{store,fit,monitor,failover,exporter}.py`` and
  ``launch/stress.py`` are the reference's text with ``repro.`` read as
  ``repro_torch.``, the port's own default paths aside (its store and soak
  output live under ``results/calibration_torch/``); ``telemetry/probe.py``
  is the reference's text apart from its docstring and ``LiveProbe``.
- The same ``SimProbe(GroundTruth(...))`` sweeps give the reference's
  records (``ts`` aside) and calibrated models, on ``2x8`` and ``2x8asym``.
- After ``startup_calibration`` under rails 4x slower than the datasheet,
  DBRX's serve program plans to the reference's ``ExecutionPlan``; a JSONL
  store written by either package calibrates the other alike;
  ``DriftMonitor.run_cycle`` emits the reference's events; the soak
  harness passes with the reference's assertions and timeline.
- ``ParallelContext(calibration=)`` and ``ServeEngine(calibration=,
  monitor=)`` plan and report as the reference's.
- The MoE probe hands the dispatch the bytes its ledger charges, where the
  reference's sends fewer.

The live probe over ranks is ``tests/test_torch_live_probe.py``.
"""

import functools
import math
import types
from pathlib import Path
from unittest import mock

import jax
import numpy as np
import pytest
import torch

import repro.telemetry as jtel
from repro.configs.base import get_config as jax_get_config
from repro.core import collectives as jcl
from repro.core import latency_model as jlm
from repro.core import plan as jplan_ir
from repro.core import planner as jplanner
from repro.core import topology as jtopo
from repro.launch import stress as jstress
from repro.launch.mesh import make_test_mesh
from repro.parallel import context as jctx
from repro.runtime.server import ServeEngine as JaxServeEngine
import repro_torch.telemetry as ttel
from repro_torch.configs.base import get_config
from repro_torch.core import collectives as tcl
from repro_torch.core import latency_model as tlm
from repro_torch.core import plan as tplan_ir
from repro_torch.core import planner as tplanner
from repro_torch.core import topology as ttopo
from repro_torch.launch import stress as tstress
from repro_torch.models.api import build_model
from repro_torch.parallel import context as tctx
from repro_torch.parallel.mesh import AXES, RankMesh
from repro_torch.runtime.server import ServeEngine

ROOT = Path(__file__).resolve().parents[1]
JAX = types.SimpleNamespace(tel=jtel, topo=jtopo, planner=jplanner,
                            plan=jplan_ir, ctx=jctx, lm=jlm, stress=jstress)
PORT = types.SimpleNamespace(tel=ttel, topo=ttopo, planner=tplanner,
                             plan=tplan_ir, ctx=tctx, lm=tlm, stress=tstress)
# the port's own default paths: (reference text, port text)
OWN_PATHS = {
    "telemetry/store.py": [
        ("results/calibration/", "results/calibration_torch/"),
        ('"results", "calibration")', '"results", "calibration_torch")')],
    "launch/stress.py": [
        ("results/STRESS_", "results/calibration_torch/STRESS_")] + [
        (f'"..", "results", "{name}")',
         f'"..", "results", "calibration_torch",\n'
         f'                                "{name}")')
        for name in ("STRESS_soak.json", "STRESS_failover.json")]}
COPIES = ("telemetry/store.py", "telemetry/fit.py", "telemetry/monitor.py",
          "telemetry/failover.py", "telemetry/exporter.py",
          "launch/stress.py")
FABRICS = ("2x8", "2x8asym")
TRUTHS = {
    "healthy": lambda tel, topo: tel.GroundTruth(),
    "rails_4x": lambda tel, topo: tel.GroundTruth().degraded(topo, 4.0),
    "noisy": lambda tel, topo: tel.GroundTruth(noise=0.05, seed=3),
}
# DBRX serving on 4 prompts of 512 tokens
SERVE = {"prefill": (4, 512), "decode": (4, 1)}


def _text(module: str, pkg: str) -> str:
    return (ROOT / "src" / pkg / module).read_text()


@pytest.mark.parametrize("module", COPIES)
def test_copy_is_verbatim(module):
    ref = _text(module, "repro").replace("repro.", "repro_torch.")
    for old, new in OWN_PATHS.get(module, ()):
        assert old in ref
        ref = ref.replace(old, new)
    assert _text(module, "repro_torch") == ref


def _without_live_probe(text: str) -> str:
    """A probe module's text below its docstring, without the LiveProbe
    section."""
    body = text[text.index("from __future__ import annotations"):]
    start = body.index("class LiveProbe:")
    end = body.index("# -----------------------------------------------"
                     "----------------------------\n# the sweep")
    return body[:start] + body[end:]


def test_probe_is_verbatim_but_the_live_probe():
    ref = _text("telemetry/probe.py", "repro").replace("repro.",
                                                       "repro_torch.")
    port = _text("telemetry/probe.py", "repro_torch")
    assert _without_live_probe(port) == _without_live_probe(ref)
    assert "import jax" not in port


def test_package_exports_the_references_names():
    assert ttel.__all__ == jtel.__all__
    for name in ttel.__all__:
        assert hasattr(ttel, name), name


# ---------------------------------------------------------------------------
# the simulated loop: records, fits, plans against the reference
# ---------------------------------------------------------------------------

def _sweep(pkg, fabric: str, truth: str) -> tuple:
    """(topology, records) of one full SimProbe sweep and the directed
    rail probes under ``truth``."""
    topo = pkg.topo.get_fabric(fabric)
    probe = pkg.tel.SimProbe(TRUTHS[truth](pkg.tel, topo))
    records = pkg.tel.probe_sweep(topo, probe)
    records += pkg.tel.probe_link_directions(topo, probe)
    return topo, records


def _no_ts(records):
    return [{k: v for k, v in r.items() if k != "ts"} for r in records]


@pytest.mark.parametrize("truth", TRUTHS)
@pytest.mark.parametrize("fabric", FABRICS)
def test_sim_sweep_records_equal_reference(fabric, truth):
    _, jrec = _sweep(JAX, fabric, truth)
    _, trec = _sweep(PORT, fabric, truth)
    assert len(trec) == len(jrec) > 0
    assert _no_ts(trec) == _no_ts(jrec)


@pytest.mark.parametrize("truth", TRUTHS)
@pytest.mark.parametrize("fabric", FABRICS)
def test_calibrated_hw_equals_reference(fabric, truth):
    fps = []
    for pkg in (JAX, PORT):
        topo, records = _sweep(pkg, fabric, truth)
        store = pkg.tel.CalibrationStore(":memory:")
        store.extend(records)
        fps.append(pkg.tel.calibrated_hw(store, topo).fingerprint())
        measurements, fits = pkg.tel.fit_measurements(
            list(store.latest_by_key().values()), topo)
        fps.append((measurements, {k: f.report() for k, f in fits.items()}))
    assert fps[2:] == fps[:2]
    if truth == "rails_4x":
        assert fps[0] != jlm.DEFAULT.fingerprint()


class StandInMesh:
    """The axis sizes of a (pods, data, model) mesh, for both packages'
    contexts: ``shape`` as a JAX mesh has it, ``axis_size`` as a RankMesh
    has it."""

    def __init__(self, pods, data, model=1):
        self.shape = dict(zip(AXES, (pods, data, model)))

    def axis_size(self, *names):
        return math.prod(self.shape[a] for a in names)


def _decisions(eplan) -> dict:
    def row(d):
        return (d.op, d.plan, tuple(d.knobs), d.predicted_s, d.baseline_s,
                d.predicted_serial_s, d.predicted_ideal_s,
                dict(d.shard_map_kwargs), tuple(d.candidates))
    return {"sites": {r: row(d) for r, d in eplan.decisions.items()},
            "joint": {r: row(d) for r, d in eplan.joint.items()}}


def _calibrated(pkg, fabric: str, truth: str = "rails_4x", path=":memory:"):
    """``startup_calibration`` on ``fabric`` (a fresh planner) under the
    simulated ``truth``: (topology, store, monitor, event)."""
    topo = pkg.topo.get_fabric(fabric)
    store, monitor, event = pkg.tel.startup_calibration(
        topo, path, planner=pkg.planner.Planner(),
        probe=pkg.tel.SimProbe(TRUTHS[truth](pkg.tel, topo)))
    return topo, store, monitor, event


def _serve_plan(pkg, topo, calibration):
    """DBRX's serve program on a 2 x 2 context of ``topo`` with
    ``calibration``, planned by a fresh planner (the port's program priced
    at the reference's peak)."""
    mesh = StandInMesh(2, 2)
    if pkg is JAX:
        pctx = jctx.ParallelContext(mesh=mesh, pod_axis="pod", fabric=topo,
                                    calibration=calibration)
        program = jctx.build_collective_program(
            jax_get_config("dbrx_132b"), pctx, "serve", SERVE)
    else:
        pctx = tctx.ParallelContext(mesh, pod_axis="pod", fabric=topo,
                                    calibration=calibration)
        program = tctx.build_collective_program(
            get_config("dbrx_132b"), pctx, "serve", SERVE,
            peak_flops=ttopo.TPU_PEAK_FLOPS)
    topo, hw = pctx._plan_topo_hw(16)
    return hw, pkg.planner.Planner().plan_program(program, topo, hw)


@pytest.mark.parametrize("fabric", FABRICS)
def test_startup_calibration_plans_dbrx_as_reference(fabric):
    out = []
    for pkg in (JAX, PORT):
        topo, store, _, event = _calibrated(pkg, fabric)
        hw, eplan = _serve_plan(pkg, topo, store)
        out.append((hw.fingerprint(), eplan.fingerprint, _decisions(eplan),
                    {k: v for k, v in event.items() if k != "time"}))
    assert out[1] == out[0]
    assert out[0][0] != jlm.DEFAULT.fingerprint()
    _, datasheet = _serve_plan(PORT, ttopo.get_fabric(fabric), None)
    assert datasheet.fingerprint != out[1][1]


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_store_file_calibrates_the_other_package(writer, tmp_path):
    path = str(tmp_path / "calibration.jsonl")
    first, second = (JAX, PORT) if writer == "reference" else (PORT, JAX)
    topo, store, _, _ = _calibrated(first, "2x8", path=path)
    written = first.tel.calibrated_hw(store, topo).fingerprint()
    reader = second.tel.CalibrationStore(path)
    assert len(reader) == len(store) > 0
    got = second.tel.calibrated_hw(reader, second.topo.get_fabric("2x8"))
    assert got.fingerprint() == written != jlm.DEFAULT.fingerprint()


def _monitor_events(pkg) -> list:
    """Cycles of a DriftMonitor over 2x8 with a registered program:
    healthy, rails 4x slower twice, recovered.  Each cycle's event (None
    when nothing fired) without its wall-clock time, and the final
    report."""
    topo = pkg.topo.get_fabric("2x8")
    planner = pkg.planner.Planner()
    monitor = pkg.tel.DriftMonitor(planner, pkg.tel.CalibrationStore(
        ":memory:"), topo)
    planner.plan_program(pkg.plan.CollectiveProgram(
        "serve", pkg.plan.moe_sites("prefill", num_experts=64, top_k=8,
                                    tokens_per_rank=64, token_bytes=7168)),
        topo)
    events = []
    for truth in ("healthy", "rails_4x", "rails_4x", "healthy"):
        ev = monitor.run_cycle(pkg.tel.SimProbe(TRUTHS[truth](pkg.tel,
                                                              topo)))
        events.append(None if ev is None else
                      {k: v for k, v in ev.items() if k != "time"})
    return events + [monitor.report()]


def test_drift_monitor_cycles_emit_the_references_events():
    got, want = _monitor_events(PORT), _monitor_events(JAX)
    assert got == want
    assert any(ev is not None and ev["kind"] == "recalibrated"
               for ev in got[:-1])


@pytest.fixture(scope="module")
def soaks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("soak")
    return [pkg.stress.run_soak(epochs=6, smoke=True,
                                out_path=str(tmp / f"{name}.json"))
            for name, pkg in (("reference", JAX), ("port", PORT))]


def test_soak_smoke_passes_with_the_references_assertions(soaks):
    want, got = soaks
    assert got["ok"] and want["ok"]
    assert [a["name"] for a in got["assertions"]] == [
        "detection", "convergence", "flips", "stale", "slo"]
    assert got["assertions"] == want["assertions"]


def test_soak_timeline_equals_reference(soaks):
    want, got = soaks
    assert got["schedule"] == want["schedule"]
    assert got["timeline"] == want["timeline"]


def test_failure_soak_passes(tmp_path):
    result = tstress.run_failure_soak(epochs=10,
                                      out_path=str(tmp_path / "f.json"))
    assert result["ok"]
    assert [a["name"] for a in result["assertions"]] == [
        "detection", "reroute", "no_dead_exec", "rebind", "flipback",
        "traffic"]


def test_default_store_lives_under_the_ports_own_directory():
    """The port's records never share the reference's default file (both
    key records by fabric alone, so they would supersede each other)."""
    own = ROOT / "results" / "calibration_torch" / "calibration.jsonl"
    assert Path(ttel.CalibrationStore().path).resolve() == own.resolve()
    assert Path(jtel.CalibrationStore().path).resolve() != own.resolve()


# ---------------------------------------------------------------------------
# the context and the engine take the loop
# ---------------------------------------------------------------------------

def test_context_scores_on_the_calibrated_model():
    out = []
    for pkg in (JAX, PORT):
        topo, store, _, _ = _calibrated(pkg, "2x8")
        mesh = StandInMesh(2, 2)
        kw = dict(pod_axis="pod", fabric=topo, calibration=store)
        pctx = (jctx.ParallelContext(mesh=mesh, **kw) if pkg is JAX
                else tctx.ParallelContext(mesh, **kw))
        topo2, hw = pctx._plan_topo_hw(16)
        out.append((pkg.tel.topo_key(topo2), hw.fingerprint()))
    assert out[1] == out[0]
    assert out[1][1] != jlm.DEFAULT.fingerprint()
    assert tctx.ParallelContext(RankMesh((1, 1, 1)),
                                calibration=":memory:").calibration


class _Stub:
    """The reference engine's model stand-in (its plan methods read the
    config alone)."""

    def __init__(self, cfg):
        self.cfg = cfg
    prefill = staticmethod(lambda *a: None)
    decode = staticmethod(lambda *a: None)


def _report(rep):
    rep = dict(rep)
    if "planner" in rep:
        rep["planner"] = {k: v for k, v in rep["planner"].items()
                          if k != "planning_wall_s"}
    return rep


def test_engine_plan_report_with_the_loop_equals_reference(monkeypatch):
    """One rank, ``plan_policy="auto"`` on 2x8, each engine with its own
    package's store and monitor after the same startup calibration: the
    reports (the monitor's drift report included) and the fresh plans are
    the reference's."""
    monkeypatch.setattr(tctx, "build_collective_program", functools.partial(
        tctx.build_collective_program, peak_flops=ttopo.TPU_PEAK_FLOPS))
    engines = []
    for pkg in (JAX, PORT):
        _, store, monitor, _ = _calibrated(pkg, "2x8")
        if pkg is JAX:
            pctx = jctx.ParallelContext(
                mesh=make_test_mesh(shape=(1,), axes=("model",)),
                pod_axis=None, data_axis="model", model_axis="model",
                plan_policy="auto")
            engines.append(JaxServeEngine(
                _Stub(jax_get_config("dbrx_132b").reduced()), None,
                pctx=pctx, fabric="2x8", calibration=store,
                monitor=monitor))
        else:
            pctx = tctx.ParallelContext(RankMesh((1, 1, 1)),
                                        plan_policy="auto")
            model = build_model(get_config("dbrx_132b").reduced(),
                                device="cpu", dtype=torch.float32,
                                pctx=pctx)
            engines.append(ServeEngine(model, None, device="cpu", pctx=pctx,
                                       fabric="2x8", calibration=store,
                                       monitor=monitor))
    jeng, teng = engines
    assert teng.pctx.calibration is not None and teng.monitor is not None
    for batch, prompt_len in ((8, 32), (4, 512)):
        got, want = (_report(e.plan_report(batch, prompt_len))
                     for e in (teng, jeng))
        assert got.keys() == want.keys()
        assert {"calibration", "execution_plan", "prefill"} <= set(got)
        assert got == want
    topo, hw = teng.pctx._plan_topo_hw(16)
    assert hw.fingerprint() == jeng.pctx._plan_topo_hw(16)[1].fingerprint()


# ---------------------------------------------------------------------------
# the MoE probe's bytes
# ---------------------------------------------------------------------------

def _recorded(module, fn_name, calls):
    real = getattr(module, fn_name)

    def call(tokens, *args):
        calls.append((tokens.shape[0],
                      tokens.shape[1] * np.dtype(tokens.dtype).itemsize
                      if not isinstance(tokens, torch.Tensor)
                      else tokens.shape[1] * tokens.element_size()))
        return real(tokens, *args)
    return mock.patch.object(module, fn_name, call)


@pytest.mark.parametrize("token_bytes", [7168, 12288])
def test_moe_probe_bytes_against_the_ledger(token_bytes):
    """The ledger charges ``token_bytes`` a token.  The reference's probe
    hands its dispatch fp32 rows of ``min(1024, token_bytes // 4)``
    columns (4,096 bytes at the default 7,168); the port's hands it
    ``token_bytes``, bf16."""
    payload = 4 * token_bytes
    kw = dict(token_bytes=token_bytes, num_experts=16, top_k=4)
    topo = jtopo.get_fabric("2x8")
    jcalls, tcalls = [], []
    with _recorded(jcl, "hierarchical_dispatch", jcalls):
        jtel.LiveProbe(jax.make_mesh((1,), ("data",)), repeats=1).measure(
            "dispatch", "multiwrite", payload, topo, **kw)
    with _recorded(tcl, "hierarchical_dispatch", tcalls):
        ttel.LiveProbe(RankMesh((1, 1, 1)), repeats=1,
                       device="cpu").measure(
            "dispatch", "multiwrite", payload, ttopo.get_fabric("2x8"),
            **kw)
    assert jcalls[0] == (4, min(1024, token_bytes // 4) * 4)
    assert set(tcalls) == {(4, token_bytes)}
    scenario = tplan_ir.DispatchScenario(topo=ttopo.get_fabric("2x8"),
                                         **kw)
    assert scenario.token_bytes * tcalls[0][0] == payload


def test_launcher_calibrates_before_it_plans(tmp_path, capsys):
    """``launch.serve --calibrate startup`` on the CPU (one rank, the
    simulated probe): the store's file holds the sweep's records, the plan
    report carries the drift at fit, and the metrics snapshot is
    written."""
    from repro_torch.launch import serve as serve_cli
    store, snap = tmp_path / "cal.jsonl", tmp_path / "metrics.txt"
    planner = tplanner.default_planner()
    hw = planner.hw
    try:
        result = serve_cli.main([
            "--arch", "dbrx_132b", "--device", "cpu", "--smoke",
            "--prompt-len", "8", "--max-new", "2", "--calibrate",
            "startup", "--calibration-store", str(store),
            "--metrics-snapshot", str(snap)])
    finally:
        planner.refresh_hardware(hw)   # startup_calibration refits it
    out = capsys.readouterr().out
    records = ttel.CalibrationStore(str(store))
    assert len(records) > 0
    assert f"calibration: {len(records)} records, recalibrated=True" in out
    assert "calibration: drift" in out
    assert "repro_recalibrations_total" in snap.read_text()
    assert result["shape"] == [4, 2]


def test_engine_restages_a_retargeted_plan(monkeypatch):
    """A rail goes dark: the monitor's failure detector declares it, the
    planner retargets the bound serve program, and the engine's next plan
    report finds its plan stale and stages the monitor's replacement for a
    hot re-bind, which swaps in at the next step boundary."""
    planner = tplanner.Planner()
    monkeypatch.setattr(tplanner, "default_planner", lambda: planner)
    topo = ttopo.get_fabric("2x8")
    cfg = get_config("dbrx_132b").reduced()
    pctx = tctx.ParallelContext(RankMesh((1, 1, 1)), plan_policy="auto",
                                fabric=topo)
    program = tctx.build_collective_program(
        cfg, pctx, "serve", {"prefill": (4, 32), "decode": (4, 1)},
        itemsize=4)
    pctx = pctx.bind(pctx.plan_collectives(program))
    detector = ttel.FailureDetector(topo, strikes=1,
                                    policy=ttel.ProbePolicy(retries=0))
    monitor = ttel.DriftMonitor(planner, ttel.CalibrationStore(":memory:"),
                                topo, detector=detector)
    engine = ServeEngine(build_model(cfg, device="cpu", dtype=torch.float32,
                                     pctx=pctx), None, device="cpu",
                         pctx=pctx, monitor=monitor)
    assert engine.plan_report(4, 32)["stale"] is False
    monitor.run_cycle(ttel.SimProbe(ttel.GroundTruth().with_dead(
        [(0, 8), (8, 0)])))
    report = engine.plan_report(4, 32)
    assert report["stale"] is True and report["restaged"] is True
    assert report["calibration"]["last_failover"]["kind"] == "failover"
    staged = monitor.staged_plan("serve")
    assert engine.plan_binder.swap_if_pending()
    assert engine.plan_binder.plan is staged
    assert staged.fingerprint != pctx.execution_plan.fingerprint
