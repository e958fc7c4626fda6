"""The hybrid and rwkv families' cache-free training stacks
(``ssm.zamba2_hidden``, ``rwkv.rwkv6_hidden``), each block under
``transformer._remat``.

- The loss and every gradient through the stacks against
  ``jax.value_and_grad`` of the reference's ``Model.loss`` on the same
  weights (``convert.params_from_jax``): the loss within 1e-5 relative,
  each gradient within 1e-4 of its largest element.  The reduced Zamba2
  runs 4 blocks with the shared block after every 2, so the shared block
  is called once.
- ``remat="full"`` against ``"none"`` through a stand-in context: the same
  loss and gradients, bit for bit, with each scan's forward run twice.
- The dry run's train cell at 4,096 tokens a sequence (full widths, cut
  depth) peaks lower under ``"full"`` than under ``"none"``, and its peak
  under ``"full"`` counts no recomputed block that only a reference cycle
  keeps alive.
- No decode cache is made on the training path.
"""

import gc
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jax_get_config
from repro.data import pipeline as jdata
from repro.models.api import build_model as jax_build_model
from repro_torch.configs.base import ShapeSpec, get_config
from repro_torch.convert import params_from_jax
from repro_torch.data.pipeline import DataConfig, SyntheticLM, batch_for_model
from repro_torch.kernels import ops
from repro_torch.launch import dryrun
from repro_torch.models import api, rwkv, ssm
from repro_torch.models.api import build_model
from repro_torch.runtime.trainer import trainable

ARCHS = ["zamba2_7b", "rwkv6_7b"]
BATCH, SEQ = 2, 24
# the reduced configs: Zamba2 with one call of its shared block
REDUCED = {"zamba2_7b": dict(n_layers=4, shared_attn_every=2),
           "rwkv6_7b": dict(n_layers=2)}
SCAN = {"zamba2_7b": "mamba2_scan", "rwkv6_7b": "rwkv6_scan"}
# the dry run's cells: full widths, Zamba2 cut to one group and its shared
# block, RWKV6 to 2 blocks
DEPTH = {"zamba2_7b": 7, "rwkv6_7b": 2}
TRAIN_4K = ShapeSpec("train_4k_cut", 4096, 256, "train")


def _configs(arch):
    return (jax_get_config(arch).reduced(**REDUCED[arch]),
            get_config(arch).reduced(**REDUCED[arch]))


def _weights(jcfg):
    jmodel = jax_build_model(jcfg, None, dtype=jnp.float32)
    return jmodel, jax.tree_util.tree_map(np.asarray,
                                          jmodel.init(jax.random.key(5)))


def _raw(cfg):
    return SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=SEQ,
                                  global_batch=BATCH, seed=0)).batch(0)


def _stand_in(remat):
    """A context of one rank that asks for ``remat`` (the stacks read its
    ``remat`` and ``model_size`` alone)."""
    return types.SimpleNamespace(remat=remat, model_size=1)


@pytest.mark.parametrize("arch", ARCHS)
def test_stack_loss_and_gradients_match_reference(arch):
    jcfg, cfg = _configs(arch)
    if arch == "zamba2_7b":
        assert ssm.n_shared_calls(cfg) == 1
    jmodel, np_params = _weights(jcfg)
    raw = _raw(cfg)
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(
        jmodel.loss, has_aux=True))(
        jax.tree_util.tree_map(jnp.asarray, np_params),
        jdata.batch_for_model(jcfg, raw))
    params = params_from_jax(np_params, cfg, device="cpu",
                             dtype=torch.float32)
    trainable(params)
    model = build_model(cfg, device="cpu", dtype=torch.float32)
    loss, _ = model.loss(params, batch_for_model(cfg, raw, device="cpu"))
    loss.backward()
    assert loss.item() == pytest.approx(float(jloss), rel=1e-5)
    want = dict(params_from_jax(jax.tree_util.tree_map(np.asarray, jgrads),
                                cfg, device="cpu", dtype=torch.float32)
                .named_parameters())
    assert set(want) == {n for n, _ in params.named_parameters()}
    for name, p in params.named_parameters():
        g = want[name].detach()
        err = float((p.grad - g).abs().max())
        assert err <= 1e-4 * float(g.abs().max()), (name, err)


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_full_gives_the_gradients_of_none(arch, monkeypatch):
    _, cfg = _configs(arch)
    params = build_model(cfg, device="cpu", dtype=torch.float32).init(
        torch.Generator().manual_seed(3))
    trainable(params)
    batch = batch_for_model(cfg, _raw(cfg), device="cpu")
    calls = []
    scan = getattr(ops, SCAN[arch])
    monkeypatch.setattr(ops, SCAN[arch],
                        lambda *a, **k: calls.append(1) or scan(*a, **k))

    def run(remat):
        calls.clear()
        model = build_model(cfg, device="cpu", dtype=torch.float32,
                            pctx=_stand_in(remat))
        loss, _ = model.loss(params, batch)
        loss.backward()
        grads = {n: p.grad.clone() for n, p in params.named_parameters()}
        params.zero_grad(set_to_none=True)
        return loss.detach(), grads, len(calls)

    plain, plain_grads, plain_calls = run("none")
    full, full_grads, full_calls = run("full")
    assert plain_calls == cfg.n_layers
    assert full_calls == 2 * plain_calls
    assert torch.equal(full, plain)
    for name, g in plain_grads.items():
        assert torch.equal(full_grads[name], g), name


@pytest.mark.parametrize("arch", ARCHS)
def test_dry_run_train_peak_is_lower_under_remat(arch):
    cfg = get_config(arch).with_depth(DEPTH[arch])
    peak = {}
    for remat in ("none", "full"):
        r = dryrun.run_cell(arch, TRAIN_4K, multi_pod=False, config=cfg,
                            knobs={"remat": remat}, verbose=False,
                            fabrics=())
        peak[remat] = r["memory"]["peak_live_bytes"]
        launches = r["launches"]
        fwd, bwd = launches[SCAN[arch]], launches[SCAN[arch] + "_bwd"]
        assert fwd == (2 if remat == "full" else 1) * bwd, remat
    assert peak["full"] < peak["none"], peak


@pytest.mark.parametrize("arch", ARCHS)
def test_dry_run_peak_holds_no_block_a_cycle_keeps(arch, monkeypatch):
    """The dry run's train peak under ``"full"`` is the same with Python's
    collector off as with a full collection before each sweep of the dead
    storages: no counter keeps a recomputed block's activations alive in a
    reference cycle once its backward has ended."""
    cfg = get_config(arch).with_depth(DEPTH[arch])

    def peak():
        return dryrun.run_cell(arch, TRAIN_4K, multi_pod=False, config=cfg,
                               knobs={"remat": "full"}, verbose=False,
                               fabrics=())["memory"]["peak_live_bytes"]
    sweep = dryrun.Traffic._sweep

    def collected(self):
        gc.collect()
        sweep(self)
    peak()              # what the step imports on its first call
    gc.disable()
    gc.freeze()         # the collections scan only what the cells make
    try:
        kept = peak()
        monkeypatch.setattr(dryrun.Traffic, "_sweep", collected)
        freed = peak()
    finally:
        gc.unfreeze()
        gc.enable()
    assert kept == freed


@pytest.mark.parametrize("arch", ARCHS)
def test_training_path_makes_no_cache(arch, monkeypatch):
    _, cfg = _configs(arch)

    def refuse(*args, **kwargs):
        raise AssertionError("a decode cache was made in training")
    for mod, name in ((ssm, "zamba2_init_state"), (rwkv, "rwkv6_init_state"),
                      (api.Model, "init_cache")):
        monkeypatch.setattr(mod, name, refuse)
    model = build_model(cfg, device="cpu", dtype=torch.float32)
    params = model.init(torch.Generator().manual_seed(1))
    trainable(params)
    loss, _ = model.loss(params, batch_for_model(cfg, _raw(cfg),
                                                 device="cpu"))
    loss.backward()
    assert torch.isfinite(loss)
    assert all(p.grad is not None for p in params.parameters())
