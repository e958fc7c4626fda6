"""Modules whose width does not divide over the model axis, replicated on
every model rank (``layers.splits``), over 4 gloo ranks (1, 1, 4) on the
CPU in fp32.

Six tiny twins, each with one or two widths that 4 does not divide:

- ``attn``: Mistral-NeMo's reduction with 6 query heads over 2 kv heads
  (attention replicated; the MLP split), served also with the decode KV
  length sharded (``seq_shard_decode``: every rank runs all 6 heads over
  its block of positions, the partials merged over every rank);
- ``ffn``: 4 query heads, FFN width 130 (attention split; the MLP
  replicated, so the sequence-parallel training block takes the plain
  cut, not the reduce-scatter);
- ``moe``: DBRX's reduction with expert FFN width 130 (the experts
  replicated), the TP reduction deferred;
- ``hybrid``: Zamba2's reduction at d_model 48 (6 SSM heads replicated;
  the shared block split);
- ``rwkv_heads``: RWKV6's at d_model 96 (6 heads: the time mix
  replicated; the channel mix split);
- ``rwkv_cmix``: RWKV6's with channel-mix width 130 (the time mix split;
  the channel mix replicated).

One spawn serves and then trains every twin (``ranks.serve_worker`` with
``models``) on weights in the reference's parameter tree (its shapes from
``jax.eval_shape``, its leaves drawn from a seed) carried across by
``convert.params_from_jax``.  Each twin, against the port's one rank on
the same weights: greedy tokens equal and every step's logits within
1e-5; one training step's loss within 1e-5 relative and every gradient,
gathered to its global shape, within 1e-4 of its largest element, the
step's gradient norm within 1e-5 relative (each leaf counted once: a
replicated expert width too) and its weights within ``STEP_TOL``; one
gradient norm on every rank and the replicated leaves the same bits on
every rank; the step's checkpoint (global leaves, ``checkpoint/store.py``)
restored over the ranks and on one rank, the same bits as each rank's
leaves.
"""

import numpy as np
import pytest
import torch

from repro_torch.configs.base import get_config
from repro_torch.launch import ranks

WORLD = 4
PROMPTS, LEN, NEW = 2, 8, 4
BATCH, SEQ, STEPS, LR = 4, 16, 2, 3e-3
SPAWN_TIMEOUT_S = 240
# AdamW's first step moves an element by about LR whatever its gradient's
# size, and a gradient near zero by a share of it that a rounding of that
# gradient changes: the step's weights are held within a quarter of LR
STEP_TOL = LR / 4
# twin -> (arch, reduced-config overrides, run knobs, the leaves that must
# be replicated)
TWINS = {
    "attn": ("mistral_nemo_12b", dict(d_model=48, n_heads=6, n_kv_heads=2),
             {}, ["blocks.0.attn.wq", "blocks.0.attn.wo"]),
    "ffn": ("mistral_nemo_12b", dict(d_model=48, n_heads=4, n_kv_heads=2,
                                     d_ff=130),
            {}, ["blocks.0.mlp.w1", "blocks.0.mlp.w2"]),
    "moe": ("dbrx_132b", dict(d_ff=130), {"deferred": True},
            ["blocks.0.moe.w1", "blocks.0.moe.w2"]),
    "hybrid": ("zamba2_7b", dict(d_model=48), {},
               ["mamba.0.in_proj", "mamba.0.out_proj", "mamba.0.A_log"]),
    "rwkv_heads": ("rwkv6_7b", dict(d_model=96), {},
                   ["layers.0.wr", "layers.0.wo", "layers.0.gn.w"]),
    "rwkv_cmix": ("rwkv6_7b", dict(d_ff=130), {},
                  ["layers.0.ck", "layers.0.cv"]),
}
SERVE_RUNS = {"attn": [dict(label="tp", seq_shard_decode=False),
                       dict(label="seq", seq_shard_decode=True)]}


def config(twin: str, get=get_config):
    arch, kw, _, _ = TWINS[twin]
    return get(arch).reduced(**kw)


def _data(cfg):
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    return SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=SEQ,
                                  global_batch=BATCH, seed=0))


def _one_rank_training(cfg, weights, ckpt: str) -> dict:
    """One rank, set up as ``ranks.train_worker`` sets up a run: the
    step-0 loss and gradients and one ``Trainer`` step's loss; and the
    ranks' checkpoint of that step restored into a fresh one-rank
    trainer."""
    from repro_torch.data.pipeline import batch_for_model
    from repro_torch.launch.train import build_training
    from repro_torch.runtime.trainer import Trainer, TrainerConfig, \
        trainable

    def built():
        return build_training(cfg, None, batch=BATCH, seq=SEQ,
                              dtype=torch.float32, device="cpu", lr=LR,
                              steps=STEPS, warmup=1, weights=weights)
    data = _data(cfg)

    def make_batch(step):
        return batch_for_model(cfg, data.batch(step), device="cpu")

    def trainer(b, steps, directory=None):
        return Trainer(b.model, b.opt, make_batch,
                       TrainerConfig(total_steps=steps,
                                     checkpoint_every=1 << 30,
                                     checkpoint_dir=directory,
                                     log_every=1 << 30),
                       params=b.params, train_step=b.train_step)
    one = built()
    named = trainable(one.params)
    loss, _ = one.model.loss(one.params, make_batch(0))
    loss.backward()
    grads = {n: p.grad.numpy().copy() for n, p in named.items()}
    for p in named.values():
        p.grad = None
    hist = trainer(one, 1).run()
    stepped = {n: p.detach().numpy().copy()
               for n, p in one.params.named_parameters()}
    restored = built()
    resumed = trainer(restored, STEPS, ckpt)
    return dict(loss=loss.item(), grads=grads, history=hist,
                stepped=stepped, resumed_step=resumed.state.step,
                resumed={n: p.detach().numpy().copy()
                         for n, p in restored.params.named_parameters()})


def _cuts(cfg, rank: int) -> dict:
    """{leaf: its ``shards`` entry} of model rank ``rank`` of (1, 1, 4),
    from the module built on the meta device over a ``ShapeMesh``."""
    from repro_torch.launch.mesh import shape_pctx
    from repro_torch.models.api import param_module
    params = param_module(cfg, device="meta", dtype=torch.float32,
                          pctx=shape_pctx(shape=(1, 1, WORLD), rank=rank))
    return {f"{prefix}.{name}".lstrip("."): shard
            for prefix, sub in params.named_modules()
            for name, shard in getattr(sub, "shards", {}).items()}


@pytest.fixture(scope="module")
def twins(tmp_path_factory):
    import jax
    import jax.numpy as jnp

    from repro.configs.base import get_config as jax_get_config
    from repro.models.api import build_model as jax_build_model
    from repro_torch.convert import params_from_jax
    from repro_torch.models.api import build_model
    from repro_torch.runtime.server import ServeConfig
    tmp = tmp_path_factory.mktemp("replicated")
    ref, models, trains = {}, [], []
    for i, twin in enumerate(TWINS):
        cfg = config(twin)
        # the reference's parameter tree, its shapes traced (nothing
        # compiled) and its leaves drawn here
        rng = np.random.default_rng(30 + i)
        weights = jax.tree_util.tree_map(
            lambda leaf: (0.2 * rng.standard_normal(leaf.shape)).astype(
                leaf.dtype),
            jax.eval_shape(jax_build_model(config(twin, jax_get_config),
                                           None, dtype=jnp.float32).init,
                           jax.random.key(0)))
        prompts = np.random.default_rng(40 + i).integers(
            0, cfg.vocab, size=(PROMPTS, LEN)).astype(np.int32)
        one = ranks.RecordingEngine(
            build_model(cfg, device="cpu", dtype=torch.float32),
            params_from_jax(weights, cfg, device="cpu", dtype=torch.float32),
            ServeConfig(max_new_tokens=NEW, cache_dtype=torch.float32),
            device="cpu")
        ref[twin] = dict(weights=weights, tokens=one.generate(prompts),
                         logits=[lg.numpy() for lg in one.step_logits],
                         ckpt=str(tmp / f"ckpt_{twin}"))
        knobs = TWINS[twin][2]
        runs = [dict(r, **knobs) for r in SERVE_RUNS.get(
            twin, [dict(label="tp", seq_shard_decode=False)])]
        models.append(dict(name=twin, cfg=cfg, weights=weights,
                           prompts=prompts, runs=runs))
        trains.append(dict(
            name=f"{twin} train", train=True, cfg=cfg, weights=weights,
            runs=[dict(label="step", grads=True, steps=1,
                       ckpt={"dir": ref[twin]["ckpt"], "every": 1}, **knobs),
                  # restored and left as it is (no step)
                  dict(label="back", restore=ref[twin]["ckpt"], steps=1,
                       **knobs)]))
    spec = dict(world=WORLD, pods=1, ep=1, tp=WORLD, backend="gloo",
                device="cpu", init_method=f"file://{tmp / 'store'}",
                timeout_s=60, out_dir=str(tmp / "out"), threads=1, seed=0,
                dtype=torch.float32, cache_dtype=torch.float32, max_new=NEW,
                keep_logits=True, batch=BATCH, seq=SEQ, steps=STEPS, lr=LR,
                models=models + trains)
    got = ranks.run_ranks(ranks.serve_worker, spec,
                          timeout_s=SPAWN_TIMEOUT_S)
    for twin in TWINS:
        ref[twin].update(_one_rank_training(config(twin),
                                            ref[twin]["weights"],
                                            ref[twin]["ckpt"]))
    return ref, got


@pytest.mark.parametrize("twin", list(TWINS))
def test_served_over_four_ranks_matches_one_rank(twins, twin):
    ref, got = twins
    want = ref[twin]
    for r in got:
        for label, run in r["models"][twin]["runs"].items():
            np.testing.assert_array_equal(run["tokens"], want["tokens"])
            assert len(run["step_logits"]) == len(want["logits"])
            for a, b in zip(run["step_logits"], want["logits"]):
                np.testing.assert_allclose(a.numpy(), b, atol=1e-5,
                                           rtol=1e-5,
                                           err_msg=f"{label} {r['rank']}")


@pytest.mark.parametrize("twin", list(TWINS))
def test_trained_over_four_ranks_matches_one_rank(twins, twin):
    ref, got = twins
    want = ref[twin]
    run = got[0]["models"][f"{twin} train"]["runs"]["step"]
    assert run["step0"]["loss"] == pytest.approx(want["loss"], rel=1e-5)
    assert set(run["grads"]) == set(want["grads"])
    for name, g in want["grads"].items():
        err = float(np.abs(run["grads"][name] - g).max())
        assert err <= 1e-4 * float(np.abs(g).max()), (name, err)
    assert run["history"][0]["loss"] == pytest.approx(
        want["history"][0]["loss"], rel=1e-5)
    # the clipped step: its gradient norm counts every leaf once
    assert len(run["history"]) == len(want["history"])
    for h, w in zip(run["history"], want["history"]):
        assert h["grad_norm"] == pytest.approx(w["grad_norm"], rel=1e-5)
    # the weights after the step (the ranks' checkpoint, global leaves)
    for name, w in want["stepped"].items():
        err = float(np.abs(want["resumed"][name] - w).max())
        assert err <= STEP_TOL, (name, err)


@pytest.mark.parametrize("twin", list(TWINS))
def test_replicated_leaves_and_norm_same_on_every_rank(twins, twin):
    _, got = twins
    runs = [r["models"][f"{twin} train"]["runs"]["step"] for r in got]
    # the twin's own replicated leaves (the MoE's experts, every one on
    # every rank here, are listed apart from the replicated leaves)
    leaves = TWINS[twin][3]
    assert not set(leaves) & set(runs[0]["split"])
    assert set(leaves) <= set(runs[0]["replicated"]) or twin == "moe"
    for run in runs[1:]:
        for name in runs[0]["replicated"] + leaves:
            assert run["digest"][name] == runs[0]["digest"][name], name
        assert [h["grad_norm"] for h in run["history"]] == \
            [h["grad_norm"] for h in runs[0]["history"]]


@pytest.mark.parametrize("twin", list(TWINS))
def test_checkpoint_round_trips(twins, twin):
    """The ranks' checkpoint after their step holds global leaves: the
    ranks restore it to the same bits, leaf by leaf on every rank, and one
    rank restores it at step 1, each rank's cut of every leaf (the whole
    leaf where it is replicated) the same bits as that rank's."""
    from repro_torch.convert import block_of
    ref, got = twins
    want = ref[twin]
    assert want["resumed_step"] == 1
    cfg = config(twin)
    for r in got:
        runs = r["models"][f"{twin} train"]["runs"]
        back = runs["back"]
        assert back["start_step"] == 1 and back["history"] == []
        assert back["digest"] == runs["step"]["digest"], r["rank"]
        cuts = _cuts(cfg, r["rank"])
        for name, whole in want["resumed"].items():
            mine = whole if name not in cuts else block_of(whole,
                                                           cuts[name])
            assert ranks.leaf_digest(torch.from_numpy(np.ascontiguousarray(
                mine))) == runs["step"]["digest"][name], (name, r["rank"])
