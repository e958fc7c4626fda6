"""FSDP (ZeRO-3 over the data axis) in training over 4 gloo ranks on the
CPU, against the same training with every leaf replicated (``nofsdp``),
against the reference's 4-device step, and checkpoints moved between the
layouts.

- ``parallel.sharding.shard_fsdp`` keeps each data-cut leaf's ``1/data``
  slice under its own name, and reading it gathers it whole;
- the reduced DBRX over (2, 2, 1) (EP over the data axis, FSDP on the
  attention, the embedding and the unembedding), the reduced
  Mistral-NeMo over (1, 2, 2) and (1, 4, 1), and over (1, 2, 2) the
  reduced Zamba2 (Mamba2's ``in_proj`` cut by column segments), RWKV6,
  SeamlessM4T (the encoder-decoder's target lookup) and Gemma2 (a tied
  table read once for the lookup and the unembedding) under remat
  "full" (each block's recompute gathers again), these four with the
  clip not binding (``CASES``), from the reference's weights: three
  steps under FSDP and under ``nofsdp``, losses and grad norms within
  1e-5 relative, every weight and AdamW moment gathered to its global
  shape within 1e-5 of its largest; each rank's FSDP leaves (and their
  AdamW state) at ``sharding.leaf_shape``'s shapes; step 0's loss and
  grad norm within 1e-5 relative of the reference's ``make_train_step``
  on the same mesh of 4 forced CPU devices (its default ``fsdp=True``,
  ``param_specs`` on real arrays), and every FSDP shard bit-identical on
  its pod replicas after the run;
- a checkpoint written under FSDP over (1, 2, 2) restores under
  ``nofsdp`` and on one rank, and one written on one rank restores under
  FSDP: each saved again holds the same bits, leaf for leaf.
"""

import dataclasses
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[1]
WORLD = 4
BATCH, SEQ, STEPS, LR = 4, 32, 3, 3e-3
SEED = 7
SPAWN_TIMEOUT_S = 180
# (arch, (pods, data, model), remat, the clip's max norm), each with
# capacity factor 4 for the MoE.  The clip scales every gradient by
# max_norm / norm, and the norm of a layout sums its squares in its own
# grouping (one fp32 ulp apart): the reduced Zamba2 takes that ulp to 2e-5
# of a few AdamW moments in three steps, and with the clip not binding its
# FSDP and nofsdp runs are the same bits.  So the families added last run
# unclipped; the norm is still held (every step, and step 0 to the
# reference's).
NO_CLIP = math.inf
CASES = {"dbrx_2x2x1": ("dbrx_132b", (2, 2, 1), "none", 1.0),
         "mistral_1x2x2": ("mistral_nemo_12b", (1, 2, 2), "none", 1.0),
         "mistral_1x4x1": ("mistral_nemo_12b", (1, 4, 1), "none", 1.0),
         "zamba2_1x2x2": ("zamba2_7b", (1, 2, 2), "none", NO_CLIP),
         "rwkv6_1x2x2": ("rwkv6_7b", (1, 2, 2), "none", NO_CLIP),
         "seamless_1x2x2": ("seamless_m4t_medium", (1, 2, 2), "none",
                            NO_CLIP),
         "gemma2_1x2x2_full": ("gemma2_9b", (1, 2, 2), "full", NO_CLIP)}
TOL = 1e-5


def reduced(get_config, arch):
    return dataclasses.replace(get_config(arch).reduced(), moe_capacity=4.0)


# ---------------------------------------------------------------------------
# the JAX side (run as a script)
# ---------------------------------------------------------------------------

def jax_steps(path: str) -> None:
    """The reference's first train step of each case on its mesh of 4 CPU
    devices (``fsdp=True``, the case's remat, parameters and AdamW state
    placed by ``param_specs``, the batch by ``batch_specs``): loss and
    grad norm."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding

    from repro.configs.base import get_config
    from repro.data import pipeline as jdata
    from repro.launch.mesh import make_test_mesh
    from repro.models.api import build_model
    from repro.optim import adamw, cosine_schedule
    from repro.parallel import sharding as shd
    from repro.parallel.context import ParallelContext
    from repro.runtime.trainer import TrainState, make_train_step

    assert jax.device_count() == WORLD
    out = {}
    for label, (arch, shape, remat, _) in CASES.items():
        cfg = reduced(get_config, arch)
        mesh = make_test_mesh(shape)
        pctx = ParallelContext(mesh=mesh, pod_axis="pod" if shape[0] > 1
                               else None, plan_policy="fixed", remat=remat)
        model = build_model(cfg, pctx, dtype=jnp.float32)
        params = model.init(jax.random.key(SEED))

        def place(tree, specs):
            return jax.tree_util.tree_map(
                lambda x, sp: jax.device_put(x, NamedSharding(mesh, sp)),
                tree, specs)
        opt = adamw(lr=cosine_schedule(LR, warmup=1, total=STEPS),
                    weight_decay=0.01)
        opt_state = opt.init(params)
        state = TrainState(place(params, shd.param_specs(params, cfg, pctx)),
                           place(opt_state, shd.param_specs(opt_state, cfg,
                                                            pctx)),
                           jnp.zeros((), jnp.int32))
        step = make_train_step(model, opt, donate=False)
        data = jdata.SyntheticLM(jdata.DataConfig(
            vocab=cfg.vocab, seq_len=SEQ, global_batch=BATCH, seed=0))
        with mesh:
            b = jdata.batch_for_model(cfg, data.batch(0))
            _, m = step(state, place(b, shd.batch_specs(b, pctx)))
        out[label] = {k: float(m[k]) for k in ("loss", "grad_norm")}
    with open(path, "w") as f:
        json.dump(out, f)


if __name__ == "__main__":
    jax_steps(sys.argv[1])
    raise SystemExit(0)


# ---------------------------------------------------------------------------
# the torch side
# ---------------------------------------------------------------------------

import torch  # noqa: E402

from repro_torch.checkpoint.store import CheckpointManager  # noqa: E402
from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.launch import ranks  # noqa: E402
from repro_torch.launch.mesh import shape_pctx  # noqa: E402
from repro_torch.models.api import param_module  # noqa: E402
from repro_torch.parallel import sharding  # noqa: E402


def _spec(tmp: Path, mesh, **kw) -> dict:
    pods, ep, tp = mesh
    return dict(world=WORLD, pods=pods, ep=ep, tp=tp, backend="gloo",
                device="cpu", init_method=f"file://{tmp / 'store'}",
                timeout_s=60, out_dir=str(tmp / "out"), threads=1,
                dp_servers=(2,), dtype=torch.float32, batch=BATCH, seq=SEQ,
                steps=STEPS, lr=LR, **kw)


def _weights(arch: str):
    import jax
    import jax.numpy as jnp

    from repro.configs.base import get_config as jax_get_config
    from repro.models.api import build_model as jax_build_model
    params = jax_build_model(reduced(jax_get_config, arch), None,
                             dtype=jnp.float32).init(jax.random.key(SEED))
    return jax.tree_util.tree_map(np.asarray, params)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference's step 0 of every case, computed in a subprocess
    started at once (it compiles while the ranks run)."""
    path = tmp_path_factory.mktemp("jax") / "steps.json"
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS=f"--xla_force_host_platform_device_count={WORLD}",
               PYTHONPATH=os.pathsep.join(
                   [str(ROOT / "src"), os.environ.get("PYTHONPATH", "")]))
    proc = subprocess.Popen([sys.executable, __file__, str(path)], env=env,
                            cwd=ROOT, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    yield proc, path
    if proc.poll() is None:
        proc.kill()


def _reference_steps(reference) -> dict:
    proc, path = reference
    _, err = proc.communicate(timeout=300)
    assert proc.returncode == 0, err[-4000:]
    return json.loads(path.read_text())


def _one_rank_trainer(cfg, weights, steps: int, ckpt_dir):
    from repro_torch.convert import params_from_jax
    from repro_torch.data.pipeline import DataConfig, SyntheticLM, \
        batch_for_model
    from repro_torch.models.api import build_model
    from repro_torch.optim import adamw, cosine_schedule
    from repro_torch.runtime.trainer import Trainer, TrainerConfig
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=SEQ,
                                  global_batch=BATCH, seed=0))
    return Trainer(
        build_model(cfg, device="cpu", dtype=torch.float32),
        adamw(lr=cosine_schedule(LR, warmup=1, total=STEPS),
              weight_decay=0.01),
        lambda s: batch_for_model(cfg, data.batch(s), device="cpu"),
        TrainerConfig(total_steps=steps, log_every=1 << 30,
                      checkpoint_every=1 << 30, checkpoint_dir=ckpt_dir),
        params=params_from_jax(weights, cfg, device="cpu",
                               dtype=torch.float32))


@pytest.fixture(scope="module")
def trained(reference, tmp_path_factory):
    """Every case over 4 ranks under FSDP and ``nofsdp`` (3 steps, the
    global state recorded); for Mistral-NeMo over (1, 2, 2) also the
    checkpoint moves: the FSDP run's step-3 checkpoint restored under
    ``nofsdp`` and saved again, and a one-rank checkpoint (written here
    first, after one step) restored under FSDP and saved again; then the
    FSDP checkpoint restored on one rank and saved again."""
    out = {}
    for label, (arch, mesh, remat, clip) in CASES.items():
        cfg = reduced(get_config, arch)
        weights = _weights(arch)
        tmp = tmp_path_factory.mktemp(label)
        knobs = dict(state=True, remat=remat, max_grad_norm=clip)
        runs = [dict(label="fsdp", **knobs),
                dict(label="nofsdp", fsdp=False, **knobs)]
        dirs = {}
        if label == "mistral_1x2x2":
            dirs = {k: str(tmp / k) for k in ("fsdp", "to_nofsdp", "one",
                                             "to_fsdp", "to_one")}
            _one_rank_trainer(cfg, weights, 1, dirs["one"]).run()
            runs[0]["ckpt"] = {"dir": dirs["fsdp"], "every": STEPS}
            runs += [dict(label="to_nofsdp", fsdp=False,
                          restore=dirs["fsdp"], resave=dirs["to_nofsdp"]),
                     dict(label="to_fsdp", steps=1, restore=dirs["one"],
                          resave=dirs["to_fsdp"])]
        got = ranks.run_ranks(ranks.train_worker,
                              _spec(tmp, mesh, cfg=cfg, weights=weights,
                                    runs=runs), timeout_s=SPAWN_TIMEOUT_S)
        if dirs:
            one = _one_rank_trainer(cfg, weights, STEPS, dirs["fsdp"])
            assert one.state.step == STEPS
            CheckpointManager(dirs["to_one"]).save(one.state.step,
                                                   one.state.tree())
        out[label] = (cfg, mesh, got, dirs)
    return out


@pytest.mark.parametrize("case", list(CASES))
def test_fsdp_trains_as_nofsdp(trained, case):
    """Three steps: the losses and grad norms within 1e-5 relative, and
    every weight and AdamW moment, gathered to its global shape, within
    1e-5 of its largest element."""
    _, _, got, _ = trained[case]
    fsdp, rep = got[0]["runs"]["fsdp"], got[0]["runs"]["nofsdp"]
    assert fsdp["fsdp"] and not rep["fsdp"]
    for key in ("loss", "grad_norm"):
        np.testing.assert_allclose([h[key] for h in fsdp["history"]],
                                   [h[key] for h in rep["history"]],
                                   rtol=TOL)
    assert set(fsdp["state"]) == set(rep["state"])
    for key, want in rep["state"].items():
        err = np.abs(fsdp["state"][key] - want).max()
        assert err <= TOL * max(np.abs(want).max(), 1e-30), key


@pytest.mark.parametrize("case", list(CASES))
def test_fsdp_leaves_at_leaf_shape(trained, case):
    """Each rank's leaves at ``sharding.leaf_shape`` of its model-axis cut
    (a ``ShapeMesh`` module of the same rank), the FSDP ones cut and their
    AdamW state at the shards' shapes; under ``nofsdp`` every leaf at its
    model-axis cut."""
    cfg, mesh, got, _ = trained[case]
    for r in got:
        pctx = shape_pctx(shape=mesh, rank=r["rank"])
        whole = param_module(cfg, device="meta", dtype=torch.float32,
                             pctx=pctx)
        want = sharding.param_shapes(whole, cfg, pctx)
        fsdp, rep = r["runs"]["fsdp"], r["runs"]["nofsdp"]
        assert fsdp["shapes"] == want
        assert {n for n, p in whole.named_parameters()
                if tuple(p.shape) != want[n]} == set(fsdp["fsdp"])
        assert rep["shapes"] == {n: tuple(p.shape)
                                 for n, p in whole.named_parameters()}
        per_leaf = 4 * sum(np.prod(s) for s in want.values())
        assert fsdp["state_bytes"] == {"weights": per_leaf,
                                       "grads": per_leaf,
                                       "opt_state": 2 * per_leaf}


@pytest.mark.parametrize("case", list(CASES))
def test_step0_matches_reference(trained, reference, case):
    """Step 0 under FSDP: loss and grad norm within 1e-5 relative of the
    reference's step on the same mesh of 4 CPU devices."""
    ref = _reference_steps(reference)[case]
    h0 = trained[case][2][0]["runs"]["fsdp"]["history"][0]
    assert h0["loss"] == pytest.approx(ref["loss"], rel=TOL)
    assert h0["grad_norm"] == pytest.approx(ref["grad_norm"], rel=TOL)


@pytest.mark.parametrize("case", list(CASES))
def test_shards_bit_identical_on_their_replicas(trained, case):
    """After the run every replicated leaf is the same bits on every rank,
    every FSDP shard on every rank of its (data, model) coordinate (its
    pod replicas), each segment of an FSDP shard that every model rank
    holds whole (Zamba2's ``in_proj`` B/C columns) on every rank of its
    data coordinate, and the grad norm is the same on every rank."""
    _, _, got, _ = trained[case]
    runs = [(r["coords"], r["runs"]["fsdp"]) for r in got]
    first = runs[0][1]
    assert first["replicated"] and first["fsdp"]
    assert bool(first["data_replicated"]) == case.startswith("zamba2")
    for coords, run in runs:
        for name in first["replicated"]:
            assert run["digest"][name] == first["digest"][name], name
        for c, other in runs:
            if (c["data"], c["model"]) == (coords["data"], coords["model"]):
                for name in first["fsdp"]:
                    assert run["digest"][name] == other["digest"][name]
            if c["data"] == coords["data"]:
                for name in first["data_replicated"]:
                    assert run["digest"][name] == other["digest"][name]
        assert [h["grad_norm"] for h in run["history"]] == \
            [h["grad_norm"] for h in first["history"]]


def _leaves(directory: str, step: int) -> dict:
    d = Path(directory) / f"step_{step:08d}"
    manifest = json.loads((d / "manifest.json").read_text())
    with np.load(d / "shard_00000.npz") as z:
        arrays = {k: z[k] for k in z.files}
    return {k: (v["shape"], v["dtype"], v["crc"], arrays[k])
            for k, v in manifest["leaves"].items()}


def _same_bits(a: dict, b: dict) -> None:
    assert set(a) == set(b)
    for key, (shape, dtype, crc, arr) in a.items():
        assert (shape, dtype, crc) == b[key][:3], key
        assert arr.tobytes() == b[key][3].tobytes(), key


def test_checkpoint_moves_between_layouts(trained):
    """The FSDP run's step-3 checkpoint over (1, 2, 2), restored under
    ``nofsdp`` over the same ranks and on one rank, each saved again: the
    same bits; a one-rank checkpoint restored under FSDP and saved again:
    the same bits."""
    _, _, got, dirs = trained["mistral_1x2x2"]
    assert got[0]["runs"]["to_nofsdp"]["start_step"] == STEPS
    assert got[0]["runs"]["to_fsdp"]["start_step"] == 1
    written = _leaves(dirs["fsdp"], STEPS)
    assert any(k.startswith("opt/") for k in written)
    _same_bits(_leaves(dirs["to_nofsdp"], STEPS), written)
    _same_bits(_leaves(dirs["to_one"], STEPS), written)
    _same_bits(_leaves(dirs["to_fsdp"], 1), _leaves(dirs["one"], 1))


def test_shard_fsdp_keeps_names_and_gathers_on_read():
    """On a ``ShapeMesh`` rank of (1, 2, 2): the sharded module keeps every
    parameter name, its data-cut leaves hold their shard, and reading one
    as an attribute gives the whole model-axis part (one all-gather over
    ``data`` logged); with ``fsdp`` off or one data rank nothing changes."""
    cfg = get_config("mistral_nemo_12b").reduced()
    pctx = shape_pctx(shape=(1, 2, 2), rank=3)
    params = param_module(cfg, device="meta", dtype=torch.float32,
                          pctx=pctx)
    before = {n: tuple(p.shape) for n, p in params.named_parameters()}
    sharding.shard_fsdp(params, cfg, pctx)
    after = {n: tuple(p.shape) for n, p in params.named_parameters()}
    assert set(after) == set(before)
    assert after == sharding.param_shapes(
        param_module(cfg, device="meta", dtype=torch.float32, pctx=pctx),
        cfg, pctx)
    attn = params.blocks[0].attn
    assert attn._parameters["wq"].shape[0] == before[
        "blocks.0.attn.wq"][0] // 2
    pctx.mesh.log.clear()
    assert tuple(attn.wq.shape) == before["blocks.0.attn.wq"]
    assert [(k, ax) for k, ax, *_ in pctx.mesh.log] == [("all-gather",
                                                         "data")]
    assert tuple(params.final_norm.w.shape) == before["final_norm.w"]
    for off in (dataclasses.replace(pctx, fsdp=False),
                shape_pctx(shape=(1, 1, 2))):
        mod = param_module(cfg, device="meta", dtype=torch.float32,
                           pctx=off)
        sharding.shard_fsdp(mod, cfg, off)
        assert not any(isinstance(m, sharding.Gathering)
                       for m in mod.modules())
