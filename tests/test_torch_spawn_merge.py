"""A serving spawn that then trains on the same mesh, against a spawn that
only trains (4 gloo ranks on the CPU).

``ranks.serve_worker`` runs the entries of ``spec["models"]`` one after
another on one spawned mesh; an entry with ``train`` runs
``ranks.train_worker``'s work there after the served weights and engines
are freed.  ``chip_smoke.py`` lets phase 11's trainings ride the spawns of
phases 6 (DBRX over 2 x 2) and 8 (Mistral-NeMo over (1, 1, 4)) so, to
save two spawns and their imports.  Here the reduced DBRX over (2, 2, 1)
and the reduced Mistral-NeMo over (1, 1, 4) are served (a prefill and 3
greedy tokens) and then trained for 2 steps on one spawn; each rank's
training must give the bits of ``train_worker`` alone on its own spawn:
every step's loss and grad norm, every leaf's digest after the run, the
kernel launches and the resolved gradient mean.
"""

import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs.base import get_config
from repro_torch.launch import ranks

SPAWN_TIMEOUT_S = 180
PROMPTS, LEN, NEW = 4, 8, 3
TRAIN = dict(batch=4, seq=32, steps=2, lr=3e-3)

# (mesh, arch): the meshes of chip_smoke's phases 6 and 8
CASES = [((2, 2, 1), "dbrx_132b"), ((1, 1, 4), "mistral_nemo_12b")]


def _cfg(arch: str):
    cfg = get_config(arch).reduced()
    if cfg.family == "moe":         # num_experts / top_k: nothing dropped
        cfg = dataclasses.replace(cfg, moe_capacity=4.0)
    return cfg


def _spec(tmp: Path, mesh, **kw) -> dict:
    pods, ep, tp = mesh
    return dict(world=pods * ep * tp, pods=pods, ep=ep, tp=tp,
                backend="gloo", device="cpu",
                init_method=f"file://{tmp / 'store'}", timeout_s=60,
                out_dir=str(tmp / "out"), threads=1, dp_servers=(pods,),
                seed=0, dtype=torch.float32, **kw)


def _train_run(arch: str) -> dict:
    return dict(cfg=_cfg(arch), runs=[dict(label="trained", policy="auto")],
                **TRAIN)


@pytest.fixture(scope="module", params=CASES,
                ids=[f"{arch}-{'x'.join(map(str, mesh))}"
                     for mesh, arch in CASES])
def spawned(request, tmp_path_factory):
    """(merged, alone): each rank's results of the serve-then-train spawn
    and of the training spawn."""
    mesh, arch = request.param
    cfg = _cfg(arch)
    prompts = np.random.default_rng(3).integers(
        0, cfg.vocab, size=(PROMPTS, LEN)).astype(np.int32)
    tmp = tmp_path_factory.mktemp("merged")
    merged = ranks.run_ranks(ranks.serve_worker, _spec(
        tmp, mesh, cache_dtype=torch.float32, max_new=NEW, models=[
            dict(name="served", cfg=cfg, prompts=prompts,
                 runs=[dict(label="served")]),
            dict(name="trained", train=True, **_train_run(arch))]),
        timeout_s=SPAWN_TIMEOUT_S)
    tmp = tmp_path_factory.mktemp("alone")
    alone = ranks.run_ranks(ranks.train_worker,
                            _spec(tmp, mesh, **_train_run(arch)),
                            timeout_s=SPAWN_TIMEOUT_S)
    return merged, alone


def test_serving_spawn_trains_as_a_training_spawn(spawned):
    merged, alone = spawned
    assert len(merged) == len(alone) == 4
    for m, a in zip(merged, alone):
        got = m["models"]["trained"]["runs"]["trained"]
        want = a["runs"]["trained"]
        assert [(h["loss"], h["grad_norm"]) for h in got["history"]] == \
            [(h["loss"], h["grad_norm"]) for h in want["history"]]
        assert got["digest"] == want["digest"]
        assert got["launches"] == want["launches"]
        assert (got["scheme"], got["sync_bytes"], got["moe"]) == \
            (want["scheme"], want["sync_bytes"], want["moe"])
        assert np.isfinite([h["loss"] for h in got["history"]]).all()


def test_serving_spawn_serves_before_it_trains(spawned):
    merged, _ = spawned
    tokens = [r["models"]["served"]["runs"]["served"]["tokens"]
              for r in merged]
    assert tokens[0].shape == (PROMPTS, NEW)
    assert all(np.array_equal(t, tokens[0]) for t in tokens)
    labels = [label for label, _ in merged[0]["marks"]]
    assert labels.index("model served") < labels.index("run trained") \
        < labels.index("model trained")
