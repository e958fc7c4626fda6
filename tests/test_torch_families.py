"""The decoder-only secondary families against the JAX package: Gemma2-9B
(post-norm, alternating 32-token windows in the reduced config, both
softcaps, tied embeddings), StarCoder2-15B (non-gated GELU), Minitron-8B
(squared ReLU) and Qwen2-VL-2B's backbone (M-RoPE, the embeddings input
through the reference's stub frontend).

The reduced configs in fp32 on the reference's parameters (carried across
by ``convert.params_from_jax``): prefill and 3 decode steps at a prompt
longer than the window, within atol = rtol = 1e-4; greedy ``ServeEngine``
tokens equal to the reference engine's; Gemma2 also at head_dim 256.
M-RoPE at three different position ids per token within 1e-6; the stub
frontend bit-equal; each full config's parameter count equal to the
reference's; the reduced Gemma2 over (1, 1, 2) gloo ranks (serving, and
a training step with sequence parallelism, where ``pn2`` must norm the
summed FFN output) within 1e-4 of one rank.
"""

import dataclasses
import math
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jax_get_config
from repro.data import pipeline as jpipeline
from repro.models import layers as jlayers
from repro.models.api import build_model as jax_build_model
from repro.models.api import param_count_shape_only
from repro.runtime.server import ServeConfig as JaxServeConfig
from repro.runtime.server import ServeEngine as JaxServeEngine
from repro_torch.configs.base import get_config
from repro_torch.convert import params_from_jax
from repro_torch.data import pipeline
from repro_torch.launch import ranks
from repro_torch.models import layers as L
from repro_torch.models.api import build_model, param_module
from repro_torch.runtime.server import ServeConfig, ServeEngine

ARCHS = ["gemma2_9b", "starcoder2_15b", "minitron_8b", "qwen2_vl_2b"]
# Gemma2's reduced config at head_dim 16, and a variant that keeps its
# head_dim 256 (two heads over one kv head at d_model 512)
VARIANTS = {arch: {} for arch in ARCHS}
VARIANTS["gemma2_9b-d256"] = dict(d_model=512, n_heads=2, d_head=256)
# fp32 everywhere; logits after a whole (reduced) model
LOGIT_TOL = dict(atol=1e-4, rtol=1e-4)
B, S = 2, 40                 # a prompt longer than the reduced window (32)
SPAWN_TIMEOUT_S = 180


def _np(x) -> np.ndarray:
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _configs(variant: str):
    arch = variant.split("-")[0]
    kw = VARIANTS[variant]
    return get_config(arch).reduced(**kw), jax_get_config(arch).reduced(**kw)


@pytest.fixture(scope="module", params=list(VARIANTS))
def family(request):
    """A reduced config, the reference model and its parameters (fp32),
    and the port's model on the same parameters."""
    cfg, jcfg = _configs(request.param)
    jmodel = jax_build_model(jcfg, dtype=jnp.float32)
    jparams = jmodel.init(jax.random.key(3))
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                              cfg, device="cpu", dtype=torch.float32)
    model = build_model(cfg, device="cpu", dtype=torch.float32)
    return cfg, jcfg, jmodel, jparams, model, tparams


def _prefill_batches(cfg, jcfg, toks):
    """The same prompt as each package's batch: tokens, or the stub
    frontend's embeddings and positions."""
    jbatch = jpipeline.batch_for_model(jcfg, {"tokens": toks, "labels": toks})
    jbatch.pop("labels")
    return jbatch, pipeline.batch_for_model(cfg, {"tokens": toks},
                                            device="cpu")


def _decode_batches(cfg, model, nxt):
    if cfg.input_mode == "embeddings":
        jbatch = {"embeds": jnp.asarray(jpipeline._stub_embed(
            nxt, cfg.d_model))}
    else:
        jbatch = {"tokens": jnp.asarray(nxt)}
    return jbatch, model.decode_batch(torch.from_numpy(nxt[:, 0]))


def test_prefill_and_decode_logits_match_reference(family):
    cfg, jcfg, jmodel, jparams, model, tparams = family
    assert (tparams.unembed is None) == cfg.tie_embeddings
    assert (tparams.blocks[0].pn1 is not None) == cfg.post_norm
    toks = np.random.default_rng(5).integers(
        0, cfg.vocab, size=(B, S)).astype(np.int32)
    jbatch, tbatch = _prefill_batches(cfg, jcfg, toks)
    # fp32 caches: the comparison is of the algorithm
    jcache = jmodel.init_cache(B, S + 4, jnp.float32)
    tcache = model.init_cache(B, S + 4, torch.float32)
    jl, jcache = jax.jit(jmodel.prefill)(jparams, jbatch, jcache)
    jdecode = jax.jit(jmodel.decode)
    with torch.inference_mode():
        tl, tcache = model.prefill(tparams, tbatch, tcache)
        np.testing.assert_allclose(_np(tl), np.asarray(jl), **LOGIT_TOL)
        for _ in range(3):
            nxt = np.array(jnp.argmax(jl, axis=-1), np.int32)[:, None]
            jdec, tdec = _decode_batches(cfg, model, nxt)
            jl, jcache = jdecode(jparams, jdec, jcache)
            tl, tcache = model.decode(tparams, tdec, tcache)
            np.testing.assert_allclose(_np(tl), np.asarray(jl), **LOGIT_TOL)
    assert tcache["len"] == int(jcache["len"]) == S + 3


@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_serve_engine_matches_reference(arch):
    """Both packages' ``ServeEngine`` on the same prompts (Qwen2-VL's
    through each package's stub frontend, in the prefill and for every
    sampled token)."""
    cfg, jcfg = _configs(arch)
    jmodel = jax_build_model(jcfg, dtype=jnp.float32)
    jparams = jmodel.init(jax.random.key(1))
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                              cfg, device="cpu", dtype=torch.float32)
    jeng = JaxServeEngine(jmodel, jparams,
                          JaxServeConfig(max_new_tokens=5,
                                         cache_dtype=jnp.float32))
    teng = ServeEngine(build_model(cfg, device="cpu", dtype=torch.float32),
                       tparams, ServeConfig(max_new_tokens=5,
                                            cache_dtype=torch.float32),
                       device="cpu")
    prompts = np.random.default_rng(2).integers(
        0, cfg.vocab, size=(3, S)).astype(np.int32)
    got = teng.generate(prompts)
    assert got.shape == (3, 5)
    np.testing.assert_array_equal(got, jeng.generate(prompts))
    assert teng.stats["nonfinite_logits"] == 0


def test_mrope_three_distinct_positions_match_reference():
    """Each (t, h, w) section rotated by its own position id: with three
    different ids a token, a swapped or misaligned section changes the
    result (with one id broadcast to all three it would not)."""
    cfg = get_config("qwen2_vl_2b")
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, 7, 3, cfg.head_dim)).astype(np.float32)
    pos = rng.integers(0, 4096, size=(2, 7, 3)).astype(np.int32)
    sections = cfg.mrope_sections
    want = np.asarray(jlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos),
                                         cfg.rope_theta, sections))
    got = L.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                       cfg.rope_theta, sections).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-6)
    swapped = L.apply_rope(torch.from_numpy(x),
                           torch.from_numpy(pos[..., [0, 2, 1]].copy()),
                           cfg.rope_theta, sections).numpy()
    assert np.abs(swapped - want).max() > 1e-2
    with pytest.raises(ValueError, match="sections"):
        L.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                     cfg.rope_theta, (16, 24, 16))


def test_qwen2_vl_prefill_at_distinct_section_positions():
    """The reduced Qwen2-VL's prefill on embeddings with three different
    position ids a token, as the reference's ``input_specs`` allows."""
    cfg, jcfg = _configs("qwen2_vl_2b")
    jmodel = jax_build_model(jcfg, dtype=jnp.float32)
    jparams = jmodel.init(jax.random.key(6))
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                              cfg, device="cpu", dtype=torch.float32)
    model = build_model(cfg, device="cpu", dtype=torch.float32)
    rng = np.random.default_rng(8)
    emb = rng.normal(size=(B, S, cfg.d_model)).astype(np.float32)
    pos = np.sort(rng.integers(0, 64, size=(B, S, 3)), axis=1).astype(
        np.int32)
    jl, _ = jax.jit(jmodel.prefill)(
        jparams, {"embeds": jnp.asarray(emb), "positions": jnp.asarray(pos)},
        jmodel.init_cache(B, S + 1, jnp.float32))
    with torch.inference_mode():
        tl, _ = model.prefill(
            tparams, {"embeds": torch.from_numpy(emb),
                      "positions": torch.from_numpy(pos)},
            model.init_cache(B, S + 1, torch.float32))
    np.testing.assert_allclose(_np(tl), np.asarray(jl), **LOGIT_TOL)


def test_stub_frontend_and_embeddings_batch_equal_reference():
    cfg, jcfg = _configs("qwen2_vl_2b")
    toks = np.random.default_rng(9).integers(
        0, cfg.vocab, size=(4, 9)).astype(np.int32)
    np.testing.assert_array_equal(pipeline._stub_embed(toks, 96),
                                  jpipeline._stub_embed(toks, 96))
    data = {"tokens": toks, "labels": np.roll(toks, -1, axis=1)}
    want = jpipeline.batch_for_model(jcfg, data)
    got = pipeline.batch_for_model(cfg, data, device="cpu")
    assert set(got) == set(want) == {"embeds", "positions", "labels"}
    for key in want:
        assert got[key].numpy().dtype == np.asarray(want[key]).dtype
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]))

    class DataRank:                   # dp rank 1 of 2
        dp_size, dp_index = 2, 1
    half = pipeline.batch_for_model(cfg, data, device="cpu", pctx=DataRank())
    for key in want:
        np.testing.assert_array_equal(half[key].numpy(),
                                      np.asarray(want[key])[2:])
    # a prompt batch without labels, as the server builds its prefill
    prompt = pipeline.batch_for_model(cfg, {"tokens": toks}, device="cpu")
    assert set(prompt) == {"embeds", "positions"}
    for key in prompt:
        np.testing.assert_array_equal(prompt[key].numpy(),
                                      np.asarray(want[key]))
    # the decode input: the stub embedding of each sampled token
    model = build_model(cfg, device="cpu", dtype=torch.float32)
    dec = model.decode_inputs(toks[:, 0])
    np.testing.assert_array_equal(
        dec["embeds"], jpipeline._stub_embed(toks[:, :1], cfg.d_model))
    assert build_model(get_config("gemma2_9b").reduced(), device="cpu"
                       ).decode_inputs(toks[:, 0])["tokens"].shape == (4, 1)
    # make_batch's synthetic embeddings input, prefill and decode
    from repro.models.api import make_batch as jax_make_batch
    from repro_torch.models.api import make_batch
    for kind in ("prefill", "decode"):
        want = jax_make_batch(jcfg, kind, 3, 6, rng_seed=4)
        got = make_batch(cfg, kind, 3, 6, rng_seed=4, device="cpu")
        assert set(got) == set(want)
        for key in want:
            np.testing.assert_array_equal(got[key].numpy(),
                                          np.asarray(want[key]))


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_and_full_parameter_counts_equal_reference(arch):
    """The copied config and its reduced variants equal the reference's
    field by field, and the full model's parameters (made on the meta
    device) count the reference's ``param_count_shape_only``."""
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    for kw in ({}, VARIANTS.get(f"{arch}-d256", {"n_heads": 8})):
        assert dataclasses.asdict(cfg.reduced(**kw)) == \
            dataclasses.asdict(jcfg.reduced(**kw))
    params = param_module(cfg, device="meta", dtype=torch.bfloat16)
    assert sum(math.prod(p.shape) for p in params.parameters()) == \
        param_count_shape_only(jcfg)


# ---------------------------------------------------------------------------
# the reduced Gemma2 over (1, 1, 2) gloo ranks against one rank
# ---------------------------------------------------------------------------

RANK_NEW = 4
TRAIN_BATCH, TRAIN_SEQ = 4, 40


def _rank_spec(tmp: Path, **kw) -> dict:
    return dict(world=2, pods=1, ep=1, tp=2, backend="gloo", device="cpu",
                init_method=f"file://{tmp / 'store'}", timeout_s=60,
                out_dir=str(tmp / "out"), threads=1, dtype=torch.float32,
                **kw)


@pytest.fixture(scope="module")
def gemma_ranks(tmp_path_factory):
    cfg, jcfg = _configs("gemma2_9b")
    weights = jax.tree_util.tree_map(np.asarray, jax_build_model(
        jcfg, dtype=jnp.float32).init(jax.random.key(11)))
    prompts = np.random.default_rng(12).integers(
        0, cfg.vocab, size=(B, S)).astype(np.int32)
    tmp = tmp_path_factory.mktemp("gemma_serve")
    served = ranks.run_ranks(ranks.serve_worker, _rank_spec(
        tmp, cfg=cfg, cache_dtype=torch.float32, seed=0, weights=weights,
        prompts=prompts, max_new=RANK_NEW, runs=[dict(label="tp2")],
        keep_logits=True), timeout_s=SPAWN_TIMEOUT_S)
    tmp = tmp_path_factory.mktemp("gemma_train")
    trained = ranks.run_ranks(ranks.train_worker, _rank_spec(
        tmp, cfg=cfg, weights=weights, batch=TRAIN_BATCH, seq=TRAIN_SEQ,
        steps=1, lr=1e-3, runs=[dict(label="sp", grads=True,
                                     grad_of="ce")]),
        timeout_s=SPAWN_TIMEOUT_S)
    return cfg, weights, prompts, served, trained


def test_gemma2_served_over_two_model_ranks_matches_one_rank(gemma_ranks):
    """Prefill (the prompt split over the ranks between blocks) and 3
    decode steps: every step's logits within 1e-4 of one rank's, on both
    ranks, and the greedy tokens equal."""
    cfg, weights, prompts, served, _ = gemma_ranks
    model = build_model(cfg, device="cpu", dtype=torch.float32)
    params = params_from_jax(weights, cfg, device="cpu", dtype=torch.float32)
    want, toks = [], []
    with torch.inference_mode():
        cache = model.init_cache(B, S + RANK_NEW, torch.float32)
        logits, _ = model.prefill(params, {"tokens": torch.from_numpy(
            prompts)}, cache)
        for step in range(RANK_NEW):
            want.append(logits.numpy())
            tok = torch.argmax(logits, dim=-1)
            toks.append(tok.numpy())
            if step + 1 < RANK_NEW:
                logits, _ = model.decode(params, model.decode_batch(tok),
                                         cache)
    for r in served:
        run = r["runs"]["tp2"]
        got = np.stack([lg.numpy() for lg in run["step_logits"]])
        np.testing.assert_allclose(got, np.stack(want), **LOGIT_TOL,
                                   err_msg=f"rank {r['rank']}")
        np.testing.assert_array_equal(run["tokens"], np.stack(toks, axis=1))


def test_gemma2_trained_over_two_model_ranks_matches_one_rank(gemma_ranks):
    """One training step with sequence parallelism: the ce and every
    gradient (gathered to its global shape) within 1e-4 of its largest,
    against one rank; ``pn2`` norms the reduce-scattered FFN sum."""
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.runtime.trainer import trainable
    cfg, weights, _, _, trained = gemma_ranks
    model = build_model(cfg, device="cpu", dtype=torch.float32)
    params = params_from_jax(weights, cfg, device="cpu", dtype=torch.float32)
    trainable(params)
    raw = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=TRAIN_SEQ,
                                 global_batch=TRAIN_BATCH, seed=0)).batch(0)
    _, met = model.loss(params, pipeline.batch_for_model(cfg, raw,
                                                         device="cpu"))
    met["ce"].backward()
    run = trained[0]["runs"]["sp"]
    assert run["step0"]["ce"] == pytest.approx(met["ce"].item(), rel=1e-5)
    assert any(".pn2." in name for name in run["grads"])
    assert set(run["grads"]) == {n for n, _ in params.named_parameters()}
    for name, p in params.named_parameters():
        g = p.grad.numpy()
        err = np.abs(run["grads"][name] - g).max()
        assert err <= 1e-4 * np.abs(g).max(), name


def test_gemma2_at_head_dim_256_trains_on_cpu_as_reference():
    """On the CPU attention's plain version runs at any head_dim, under
    autograd too: the Gemma2 variant at head_dim 256 gives the reference's
    loss and every gradient within 1e-4 of its largest element."""
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.runtime.trainer import trainable
    cfg, jcfg = _configs("gemma2_9b-d256")
    jmodel = jax_build_model(jcfg, dtype=jnp.float32)
    np_params = jax.tree_util.tree_map(np.asarray,
                                       jmodel.init(jax.random.key(13)))
    raw = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=S, global_batch=B,
                                 seed=0)).batch(0)
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(
        jmodel.loss, has_aux=True))(
        jax.tree_util.tree_map(jnp.asarray, np_params),
        jpipeline.batch_for_model(jcfg, raw))
    params = params_from_jax(np_params, cfg, device="cpu",
                             dtype=torch.float32)
    trainable(params)
    model = build_model(cfg, device="cpu", dtype=torch.float32)
    loss, _ = model.loss(params, pipeline.batch_for_model(cfg, raw,
                                                          device="cpu"))
    loss.backward()
    assert loss.item() == pytest.approx(float(jloss), rel=1e-5)
    want = dict(params_from_jax(jax.tree_util.tree_map(np.asarray, jgrads),
                                cfg, device="cpu", dtype=torch.float32)
                .named_parameters())
    for name, p in params.named_parameters():
        g = want[name].detach()
        assert float((p.grad - g).abs().max()) <= \
            1e-4 * float(g.abs().max()), name
