"""The port's serving path against the JAX package, and the port's rules.

- greedy ``ServeEngine.generate`` tokens equal the reference engine's on
  reduced DBRX (fp32, the reference's parameters carried across);
- staggered continuous batching equals one-shot generate, bit-exact;
- entry points default to CUDA and raise without it (no hidden fallback);
- the port imports nothing of JAX or of the reference package.
"""

import ast
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jax_get_config
from repro.models.api import build_model as jax_build_model
from repro.runtime.server import ServeConfig as JaxServeConfig
from repro.runtime.server import ServeEngine as JaxServeEngine
from repro_torch.configs.base import get_config
from repro_torch.convert import params_from_jax
from repro_torch.device import resolve_device
from repro_torch.launch import serve as serve_cli
from repro_torch.models.api import build_model, make_batch
from repro_torch.runtime.server import ServeConfig, ServeEngine
from repro_torch.serving import (AdmissionController, BatchScheduler,
                                 Request, RequestQueue, batch_bucket)

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"


@pytest.fixture(scope="module")
def engines():
    """Reference and port engines on the same reduced-DBRX parameters."""
    cfg = get_config("dbrx_132b").reduced()
    jmodel = jax_build_model(jax_get_config("dbrx_132b").reduced(),
                             dtype=jnp.float32)
    jparams = jmodel.init(jax.random.key(1))
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                              cfg, device="cpu", dtype=torch.float32)
    model = build_model(cfg, device="cpu", dtype=torch.float32)
    # fp32 caches on both sides: the comparison is of the algorithm
    jeng = JaxServeEngine(jmodel, jparams,
                          JaxServeConfig(max_new_tokens=6,
                                         cache_dtype=jnp.float32))
    teng = ServeEngine(model, tparams,
                       ServeConfig(max_new_tokens=6,
                                   cache_dtype=torch.float32), device="cpu")
    return cfg, jeng, teng


def test_greedy_generate_matches_reference(engines):
    cfg, jeng, teng = engines
    prompts = np.random.default_rng(2).integers(
        0, cfg.vocab, size=(3, 8)).astype(np.int32)
    got = teng.generate(prompts)
    assert got.shape == (3, 6) and got.dtype == np.int32
    np.testing.assert_array_equal(got, jeng.generate(prompts))
    assert teng.stats["nonfinite_logits"] == 0


def test_staggered_continuous_matches_one_shot(engines):
    cfg, _, teng = engines
    prompts = np.random.default_rng(4).integers(
        0, cfg.vocab, size=(4, 8)).astype(np.int32)
    ref = teng.generate(prompts)
    q = RequestQueue()
    for i in range(4):
        q.push(Request(rid=i, arrival_s=0.002 * i, prompt=prompts[i],
                       max_new=6))
    sched = BatchScheduler(
        queue=q, admission=AdmissionController(capacity=2),
        engine=teng, seed=0)
    sched.run_until_drained()
    assert len(sched.completed) == 4
    out = np.zeros_like(ref)
    for r in sched.completed:
        out[r.rid, :len(r.tokens[:6])] = r.tokens[:6]
    np.testing.assert_array_equal(out, ref)
    rep = sched.report()
    assert rep["completed"] == 4 and rep["pending"] == 0
    assert rep["max_in_flight"] <= 2


def test_temperature_sampling_is_seeded(engines):
    cfg, _, teng = engines
    hot = ServeEngine(teng.model, teng.params,
                      ServeConfig(max_new_tokens=4, temperature=1.0),
                      device="cpu")
    prompts = np.random.default_rng(6).integers(
        0, cfg.vocab, size=(2, 8)).astype(np.int32)
    a = hot.generate(prompts, seed=3)
    np.testing.assert_array_equal(a, hot.generate(prompts, seed=3))
    assert ((a >= 0) & (a < cfg.vocab)).all()


def test_scheduler_rejects_mixed_prompt_lengths_in_one_wave(engines):
    _, _, teng = engines
    q = RequestQueue()
    for rid, size in ((0, 8), (1, 12)):
        q.push(Request(rid=rid, prompt=np.zeros(size, np.int32), max_new=2))
    sched = BatchScheduler(
        queue=q, admission=AdmissionController(capacity=4), engine=teng)
    with pytest.raises(ValueError, match="one cohort"):
        sched.run_until_drained()


def test_queue_and_admission_copies():
    q = RequestQueue()
    q.push(Request(rid=0, arrival_s=0.0, prompt_len=4, slo_class="batch"))
    q.push(Request(rid=1, arrival_s=0.5, prompt_len=4,
                   slo_class="interactive"))
    q.push(Request(rid=2, arrival_s=0.1, prompt_len=4,
                   slo_class="interactive"))
    assert [r.rid for r in q.ready(1.0)] == [2, 1, 0]
    assert q.ready_count(0.2) == 2 and q.next_arrival_s(0.2) == 0.5
    adm = AdmissionController(capacity=3)
    dec = adm.decide(in_flight=1, ready=5)
    assert (dec.admit, dec.target_batch, dec.reason) == (2, 3, "greedy")
    assert adm.decide(in_flight=3, ready=1).reason == "capacity"
    assert adm.decide(in_flight=0, ready=0).reason == "idle"
    assert AdmissionController(capacity=0).capacity == 1
    assert [batch_bucket(b) for b in (0, 1, 3, 4, 5, 33)] == \
        [1, 1, 4, 4, 8, 64]


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg = get_config("dbrx_132b").reduced()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_model(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_batch(cfg, "prefill", 2, 4)
    model = build_model(cfg, device="cpu", dtype=torch.float32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServeEngine(model, None)
    assert resolve_device("cpu") == torch.device("cpu")


def test_engine_over_ranks_checks_its_context_and_batch(engines):
    """The engine takes the model's own context, and a batch that does not
    divide over the data-parallel ranks is padded with rows that are not
    valid (they take no expert capacity; their samples are dropped)."""
    cfg, _, teng = engines

    class FourRanks:                   # dp rank 1 of 4, no plan bound
        dp_size, dp_index = 4, 1
        execution_plan = None

    pctx = FourRanks()
    with pytest.raises(ValueError, match="ParallelContext"):
        ServeEngine(teng.model, teng.params, device="cpu", pctx=pctx)
    model = build_model(cfg, device="cpu", dtype=torch.float32, pctx=pctx)
    eng = ServeEngine(model, teng.params, device="cpu", pctx=pctx)
    np.testing.assert_array_equal(eng._my_rows(np.arange(8)), [2, 3])
    np.testing.assert_array_equal(eng._my_rows(np.arange(1, 4)), [2])
    np.testing.assert_array_equal(eng._my_valid(3), [True])
    np.testing.assert_array_equal(eng._my_rows(np.arange(1, 2)), [0])
    np.testing.assert_array_equal(eng._my_valid(1), [False])
    np.testing.assert_array_equal(eng._my_rows(np.arange(1, 6)), [3, 4])
    np.testing.assert_array_equal(eng._my_valid(5), [True, True])
    with pytest.raises(NotImplementedError, match="ParallelContext"):
        build_model(get_config("zamba2_7b").reduced(), device="cpu",
                    pctx=pctx)


def test_unported_families_raise():
    import dataclasses
    cfg = get_config("dbrx_132b").reduced()
    with pytest.raises(NotImplementedError, match="family"):
        build_model(dataclasses.replace(cfg, family="encdec"), device="cpu")
    with pytest.raises(NotImplementedError, match="input_mode=embeddings"):
        build_model(dataclasses.replace(cfg, input_mode="embeddings"),
                    device="cpu")
    with pytest.raises(NotImplementedError, match="post_norm"):
        build_model(dataclasses.replace(cfg, post_norm=True), device="cpu")
    with pytest.raises(ValueError, match="no config"):
        get_config("gemma2_9b")


def test_serve_cli_smoke(capsys):
    out = serve_cli.main(["--arch", "dbrx_132b", "--device", "cpu",
                          "--smoke", "--prompts", "2", "--prompt-len", "8",
                          "--max-new", "3"])
    assert out["shape"] == [2, 3] and out["nonfinite_logits"] == 0
    assert '"arch": "dbrx_132b-smoke"' in capsys.readouterr().out
    full = serve_cli.serve_config("dbrx_132b", layers=4, smoke=False)
    ref = jax_get_config("dbrx_132b")
    assert full.n_layers == 4
    assert (full.d_model, full.n_heads, full.n_kv_heads, full.head_dim,
            full.num_experts, full.top_k, full.expert_d_ff, full.vocab,
            full.tie_embeddings) == (
        ref.d_model, ref.n_heads, ref.n_kv_heads, ref.head_dim,
        ref.num_experts, ref.top_k, ref.expert_d_ff, ref.vocab,
        ref.tie_embeddings) == (6144, 48, 8, 128, 16, 4, 10752, 100352,
                                False)


def test_launcher_plans_on_the_given_or_measured_fabric(tmp_path, capsys):
    """``--fabric`` is taken as given.  Without it gloo ranks plan on the
    reference's mesh-derived fabric and say so, and nccl ranks time their
    link and plan on ``PxD@R:R`` from the measured rate (here one gloo
    rank stands in for the timing)."""
    import argparse

    import torch.distributed as dist

    from repro_torch.parallel.context import ParallelContext
    from repro_torch.parallel.mesh import RankMesh
    cfg = serve_cli.serve_config("dbrx_132b", layers=None, smoke=True)
    pctx = ParallelContext(RankMesh((1, 1, 1)), pod_axis=None)
    args = argparse.Namespace(fabric="2x8", backend="gloo", prompts=4,
                              prompt_len=16, pods=1, ep=1, smoke=True)
    assert serve_cli.planning_fabric(pctx, cfg, args, "cpu") == "2x8"
    args.fabric = None
    assert serve_cli.planning_fabric(pctx, cfg, args, "cpu") is None
    assert "mesh-derived TPU fabric" in capsys.readouterr().out
    args.backend = "nccl"
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    try:
        spec = serve_cli.planning_fabric(pctx, cfg, args,
                                         torch.device("cpu"))
    finally:
        dist.destroy_process_group()
    assert spec.startswith("1x1@") and f"fabric {spec}" in \
        capsys.readouterr().out


# ---------------------------------------------------------------------------
# the port stands alone: no JAX, nothing of the reference package
# ---------------------------------------------------------------------------

def test_importing_the_port_loads_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages(\n"
        "    repro_torch.__path__, 'repro_torch.')]\n"
        "for m in mods:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "assert len(mods) >= 20, mods\n"
        "assert {'repro_torch.parallel.mesh', 'repro_torch.parallel.context',\n"
        "        'repro_torch.core.bitmap', 'repro_torch.launch.ranks',\n"
        "        'repro_torch.core.planner', 'repro_torch.core.plan',\n"
        "        'repro_torch.core.schedules', 'repro_torch.core.topology',\n"
        "        'repro_torch.core.latency_model',\n"
        "        'repro_torch.core.multiwrite', 'repro_torch.core.h100',\n"
        "        'repro_torch.telemetry.metrics',\n"
        "        'repro_torch.optim.optimizers', 'repro_torch.data.pipeline',\n"
        "        'repro_torch.checkpoint.store', 'repro_torch.runtime.trainer',\n"
        "        'repro_torch.launch.train'} <= set(mods), mods\n"
        "assert not bad, bad\n"
        "print(len(mods))\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         env={"PYTHONPATH": str(ROOT / "src"),
                              "PATH": "/usr/bin:/bin"},
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_no_source_of_the_port_imports_jax_or_the_reference():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) >= 20
    assert {PORT / "parallel" / "mesh.py", PORT / "parallel" / "context.py",
            PORT / "core" / "bitmap.py", PORT / "launch" / "ranks.py",
            PORT / "core" / "planner.py", PORT / "core" / "plan.py",
            PORT / "core" / "schedules.py", PORT / "core" / "topology.py",
            PORT / "core" / "latency_model.py",
            PORT / "core" / "multiwrite.py", PORT / "core" / "h100.py",
            PORT / "telemetry" / "metrics.py",
            PORT / "optim" / "optimizers.py", PORT / "data" / "pipeline.py",
            PORT / "checkpoint" / "store.py", PORT / "runtime" / "trainer.py",
            PORT / "launch" / "train.py"} <= set(files)
    for path in files:
        for name in _imports(path):
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), (path, name)


def test_chip_smoke_fails_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for cwd, script in ((ROOT, ROOT / "chip_smoke.py"),
                        (tmp_path, tmp_path / "chip_smoke.py")):
        if cwd is tmp_path:
            script.write_text((ROOT / "chip_smoke.py").read_text())
        res = subprocess.run([sys.executable, str(script)], cwd=cwd,
                             capture_output=True, text=True, timeout=120,
                             env={"PATH": "/usr/bin:/bin"})
        assert res.returncode != 0
        assert '"ok"' not in res.stdout
