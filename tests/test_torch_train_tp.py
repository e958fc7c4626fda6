"""Training over the model axis on the CPU (4 gloo ranks), and the training
launcher under ``torchrun``.

- the reduced Mistral-NeMo over (1, 1, 4), from the reference's weights
  (``convert.params_from_jax``): the step-0 loss within 1e-5 and every
  gradient (gathered to its global shape) within 1e-4 of its largest,
  against one rank, with sequence parallelism on (the norms and the
  unembedding on a rank's positions), on through the split-TP MultiWrite
  gather (``tp_subgroups`` 2, bit-identical to 1: the same gradients and
  the same weights after 2 steps), and off; every replicated leaf
  bit-identical over the model ranks after 2 steps;
- the reduced DBRX over (1, 2, 2): EP over the data axis with TP inside
  each expert, the experts' row-parallel sum per expert and deferred past
  the combine: the step-0 ce gradients against one rank;
- ``launch.train`` under ``torchrun --standalone --nproc-per-node 4``
  over gloo: 2 x 2 ranks train the reduced DBRX for 5 steps, log the
  ``grad_sync`` verdict with the scheme that runs, and with
  ``--calibrate online`` feed step walls into ``StepAttribution``.
"""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs.base import get_config
from repro_torch.launch import ranks

ROOT = Path(__file__).resolve().parents[1]
WORLD = 4
BATCH, SEQ, STEPS, LR = 4, 32, 2, 3e-3
SEED = 7
SPAWN_TIMEOUT_S = 180


def _spec(tmp: Path, mesh, **kw) -> dict:
    pods, ep, tp = mesh
    return dict(world=WORLD, pods=pods, ep=ep, tp=tp, backend="gloo",
                device="cpu", init_method=f"file://{tmp / 'store'}",
                timeout_s=60, out_dir=str(tmp / "out"), threads=1,
                dp_servers=(2,), dtype=torch.float32, batch=BATCH, seq=SEQ,
                steps=STEPS, lr=LR, **kw)


def _weights(arch: str, cfg_fn):
    import jax
    import jax.numpy as jnp

    from repro.configs.base import get_config as jax_get_config
    from repro.models.api import build_model as jax_build_model
    params = jax_build_model(cfg_fn(jax_get_config(arch).reduced()), None,
                             dtype=jnp.float32).init(jax.random.key(SEED))
    return jax.tree_util.tree_map(np.asarray, params)


def _one_rank_grads(cfg, weights):
    """Step-0 (loss, ce, {name: ce gradient}) on one rank."""
    from repro_torch.convert import params_from_jax
    from repro_torch.data.pipeline import DataConfig, SyntheticLM, \
        batch_for_model
    from repro_torch.models.api import build_model
    from repro_torch.runtime.trainer import trainable
    model = build_model(cfg, device="cpu", dtype=torch.float32)
    params = params_from_jax(weights, cfg, device="cpu", dtype=torch.float32)
    trainable(params)
    raw = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=SEQ,
                                 global_batch=BATCH, seed=0)).batch(0)
    loss, met = model.loss(params, batch_for_model(cfg, raw, device="cpu"))
    met["ce"].backward()
    return loss.item(), met["ce"].item(), {
        n: p.grad.numpy() for n, p in params.named_parameters()}


def _check_grads(run: dict, want: dict) -> None:
    assert set(run["grads"]) == set(want)
    for name, g in want.items():
        err = np.abs(run["grads"][name] - g).max()
        assert err <= 1e-4 * np.abs(g).max(), name


def _identity(cfg):
    return cfg


def _factor4(cfg):
    return dataclasses.replace(cfg, moe_capacity=4.0)


@pytest.fixture(scope="module")
def mistral(tmp_path_factory):
    cfg = get_config("mistral_nemo_12b").reduced()
    weights = _weights("mistral_nemo_12b", _identity)
    tmp = tmp_path_factory.mktemp("mistral")
    runs = [dict(label="sp", grads=True, grad_of="ce"),
            dict(label="split", tp_subgroups=2, grads=True, grad_of="ce"),
            dict(label="nosp", seq_parallel=False, grads=True,
                 grad_of="ce")]
    got = ranks.run_ranks(ranks.train_worker,
                          _spec(tmp, (1, 1, WORLD), cfg=cfg, weights=weights,
                                runs=runs), timeout_s=SPAWN_TIMEOUT_S)
    return got, _one_rank_grads(cfg, weights)


@pytest.mark.parametrize("label", ["sp", "split", "nosp"])
def test_mistral_tp_gradients_match_one_rank(mistral, label):
    got, (loss, ce, want) = mistral
    run = got[0]["runs"][label]
    assert run["step0"]["loss"] == pytest.approx(loss, rel=1e-5)
    assert run["step0"]["ce"] == pytest.approx(ce, rel=1e-5)
    _check_grads(run, want)


def test_split_tp_gather_trains_bit_identically(mistral):
    """tp_subgroups 2 runs each block's sequence gather as the MultiWrite
    AllGather: its forward is the plain gather's bits and its backward
    this rank's block of the cotangent, so the gradients and the weights
    after 2 steps are the same bits as at tp_subgroups 1."""
    got, _ = mistral
    for r in got:
        sp, split = r["runs"]["sp"], r["runs"]["split"]
        for name, g in sp["grads"].items():
            np.testing.assert_array_equal(split["grads"][name], g)
        assert split["digest"] == sp["digest"]
        assert [h["loss"] for h in split["history"]] == \
            [h["loss"] for h in sp["history"]]


@pytest.mark.parametrize("label", ["sp", "split", "nosp"])
def test_mistral_replicated_leaves_identical_over_model_ranks(mistral,
                                                              label):
    """Every leaf not split over the model axis (embeddings, norms, the kv
    projections replicated over 4 ranks) is the same bits on each rank
    after 2 steps, and each rank clipped by the same norm."""
    got, _ = mistral
    runs = [r["runs"][label] for r in got]
    assert "final_norm.w" in runs[0]["replicated"]
    for run in runs[1:]:
        for name in runs[0]["replicated"]:
            assert run["digest"][name] == runs[0]["digest"][name], name
        assert [h["grad_norm"] for h in run["history"]] == \
            [h["grad_norm"] for h in runs[0]["history"]]


@pytest.fixture(scope="module")
def dbrx_tp(tmp_path_factory):
    cfg = _factor4(get_config("dbrx_132b").reduced())
    weights = _weights("dbrx_132b", _factor4)
    tmp = tmp_path_factory.mktemp("dbrx_tp")
    runs = [dict(label="per-expert", grads=True, grad_of="ce"),
            dict(label="deferred", deferred=True, grads=True,
                 grad_of="ce")]
    got = ranks.run_ranks(ranks.train_worker,
                          _spec(tmp, (1, 2, 2), cfg=cfg, weights=weights,
                                runs=runs), timeout_s=SPAWN_TIMEOUT_S)
    return got, _one_rank_grads(cfg, weights)


@pytest.mark.parametrize("label", ["per-expert", "deferred"])
def test_dbrx_experts_over_the_model_axis_match_one_rank(dbrx_tp, label):
    got, (_, ce, want) = dbrx_tp
    run = got[0]["runs"][label]
    assert run["step0"]["ce"] == pytest.approx(ce, rel=1e-5)
    _check_grads(run, want)


def test_launch_train_under_torchrun(tmp_path):
    """``torchrun`` starts 4 gloo ranks of the launcher (2 x 2, the reduced
    DBRX, 4 x 256 tokens on a slow fabric, where the planner pipelines the
    MoE round trip): it exits 0, rank 0 logs the bound plan's gradient
    sync and the scheme that runs, and ``--calibrate online`` feeds the
    step walls after the warm-up into ``StepAttribution``."""
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join(
                   [str(ROOT / "src"), os.environ.get("PYTHONPATH", "")]))
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc-per-node", str(WORLD), "-m", "repro_torch.launch.train",
           "--arch", "dbrx_132b", "--smoke", "--device", "cpu", "--pods",
           "2", "--ep", "2", "--backend", "gloo", "--steps", "5", "--batch",
           "4", "--seq", "256", "--fabric", "2x2@0.1:10", "--calibrate",
           "online", "--calibrate-every", "2", "--calibration-store",
           str(tmp_path / "calibration.jsonl")]
    res = subprocess.run(cmd, env=env, cwd=tmp_path, capture_output=True,
                         text=True, timeout=240)
    out = res.stdout + res.stderr
    assert res.returncode == 0, out[-4000:]
    assert "planner gradient sync:" in out
    assert "runs: planned_psum reduce_scheme=" in out
    assert "pipelined MoE round trip: G=" in out
    fed = [line for line in out.splitlines()
           if line.startswith("overlap feedback:")]
    assert len(fed) == 1 and not fed[0].startswith("overlap feedback: 0 ")
    assert "final loss" in out
