"""Training the reduced DBRX, Mistral-NeMo, Gemma2, Qwen2-VL, SeamlessM4T,
Zamba2 and RWKV6 in both packages (Gemma2's post-norms, windows and
softcaps; Qwen2-VL's M-RoPE and its embeddings input through the stub
frontend; SeamlessM4T's encoder over the stub frontend's source
embeddings, and its decoder's cross-attention; Zamba2's and RWKV6's scans
through their autograd Functions, whose backward is the scans' plain
backward on the CPU).

The reference's parameters, carried across by ``convert.params_from_jax``,
and the same ``SyntheticLM`` batches: ``Model.loss`` and every parameter's
gradient within 1e-4 of that gradient's max |grad|, and the loss curve of 5
``Trainer`` steps (AdamW on a cosine schedule, clipping at 1.0) within 1e-4
relative of the reference's ``Trainer`` step by step.  The reference's
gradient pytree is carried across with the same converter, so each
gradient lands on the port's parameter of the same name.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jax_get_config
from repro.data import pipeline as jdata
from repro.models.api import build_model as jax_build_model
from repro.optim import adamw as jadamw
from repro.optim import cosine_schedule as jcosine
from repro.runtime.trainer import Trainer as JTrainer
from repro.runtime.trainer import TrainerConfig as JTrainerConfig
from repro_torch.configs.base import get_config
from repro_torch.convert import params_from_jax
from repro_torch.data.pipeline import DataConfig, SyntheticLM, batch_for_model
from repro_torch.models.api import build_model
from repro_torch.optim import adamw, cosine_schedule
from repro_torch.runtime.trainer import Trainer, TrainerConfig, trainable

ARCHS = ["dbrx_132b", "mistral_nemo_12b", "gemma2_9b", "qwen2_vl_2b",
         "seamless_m4t_medium", "zamba2_7b", "rwkv6_7b"]
BATCH, SEQ, STEPS, LR = 4, 32, 5, 3e-3
# the reduced Zamba2's loss on the fifth batch is above its loss on the
# first at any learning rate tried (1e-4 to 1e-2), in both packages alike:
# its curve is held to the reference's, the fall is not asked of it
NO_FALL_IN_5 = {"zamba2_7b"}


def _setup(arch):
    jcfg = jax_get_config(arch).reduced()
    cfg = get_config(arch).reduced()
    jmodel = jax_build_model(jcfg, None, dtype=jnp.float32)
    jparams = jmodel.init(jax.random.key(7))
    np_params = jax.tree_util.tree_map(np.asarray, jparams)
    model = build_model(cfg, device="cpu", dtype=torch.float32)
    return jcfg, cfg, jmodel, np_params, model


def _raw(cfg, step=0):
    return SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=SEQ,
                                  global_batch=BATCH, seed=0)).batch(step)


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_every_gradient_match_reference(arch):
    jcfg, cfg, jmodel, np_params, model = _setup(arch)
    raw = _raw(cfg)
    jbatch = jdata.batch_for_model(jcfg, raw)
    (jloss, jmet), jgrads = jax.jit(jax.value_and_grad(
        jmodel.loss, has_aux=True))(jax.tree_util.tree_map(jnp.asarray,
                                                           np_params), jbatch)
    params = params_from_jax(np_params, cfg, device="cpu",
                             dtype=torch.float32)
    trainable(params)
    loss, met = model.loss(params, batch_for_model(cfg, raw, device="cpu"))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(met["ce"].item(), float(jmet["ce"]),
                               rtol=1e-5)
    np.testing.assert_allclose(met["aux"].item(), float(jmet["aux"]),
                               rtol=1e-4, atol=1e-6)
    expected = params_from_jax(jax.tree_util.tree_map(np.asarray, jgrads),
                               cfg, device="cpu", dtype=torch.float32)
    exp = dict(expected.named_parameters())
    assert len(exp) == len(list(params.parameters()))
    for name, p in params.named_parameters():
        e = exp[name].detach()
        scale = float(e.abs().max())
        err = float((p.grad - e).abs().max())
        assert err <= 1e-4 * scale, f"{name}: {err:.3e} of {scale:.3e}"


@pytest.mark.parametrize("arch", ARCHS)
def test_trainer_loss_curve_matches_reference(arch):
    """Five steps of both packages' ``Trainer`` from the reference's
    initial parameters: every step's loss within 1e-4 relative."""
    jcfg, cfg, jmodel, np_params, model = _setup(arch)
    jdata_ = jdata.SyntheticLM(jdata.DataConfig(vocab=cfg.vocab, seq_len=SEQ,
                                                global_batch=BATCH, seed=0))
    jtr = JTrainer(jmodel, jadamw(lr=jcosine(LR, warmup=1, total=STEPS),
                                  weight_decay=0.01),
                   lambda s: jdata.batch_for_model(jcfg, jdata_.batch(s)),
                   JTrainerConfig(total_steps=STEPS, log_every=1000),
                   init_rng=jax.random.key(7))
    start = jax.tree_util.tree_map(np.asarray, jtr.state.params)
    for a, b in zip(jax.tree_util.tree_leaves(start),
                    jax.tree_util.tree_leaves(np_params)):
        np.testing.assert_array_equal(a, b)
    jhist = jtr.run()

    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=SEQ,
                                  global_batch=BATCH, seed=0))
    tr = Trainer(model, adamw(lr=cosine_schedule(LR, warmup=1, total=STEPS),
                              weight_decay=0.01),
                 lambda s: batch_for_model(cfg, data.batch(s), device="cpu"),
                 TrainerConfig(total_steps=STEPS, log_every=1000),
                 params=params_from_jax(np_params, cfg, device="cpu",
                                        dtype=torch.float32))
    hist = tr.run()
    assert [h["step"] for h in hist] == list(range(STEPS))
    for mine, theirs in zip(hist, jhist):
        for key in ("loss", "grad_norm"):
            assert mine[key] == pytest.approx(theirs[key], rel=1e-4), \
                (mine["step"], key)
    if arch not in NO_FALL_IN_5:
        assert hist[-1]["loss"] < hist[0]["loss"]
