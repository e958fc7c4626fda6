"""The encoder-decoder (SeamlessM4T-medium) against the JAX package.

The reduced config in fp32 on the reference's parameters (carried across
by ``convert.params_from_jax``), inputs from a numpy seed: the encoder
output, the prefill logits and 6 decode steps' logits at a cache of
``S + 8`` rows, within atol = rtol = 1e-4; greedy ``ServeEngine`` tokens
equal to the reference engine's, also for a second cohort that reuses the
first one's decode slot; ``batch_for_model`` and ``make_batch`` equal to
the reference's; the full config's parameter count equal to
``param_count_shape_only``.

Two behaviours of the reference are held, and shown to matter: the target
embedding is unscaled in prefill and training but scaled by sqrt(d_model)
in decode, and decode's cross-attention runs over the whole zero-padded
``enc_out`` buffer (``max_len`` rows) with no mask.  Each test that shows
one of them bites runs the port the other way and finds the reference's
logits outside the tolerance.
"""

import copy
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jax_get_config
from repro.data import pipeline as jpipeline
from repro.models import transformer as JT
from repro.models.api import build_model as jax_build_model
from repro.models.api import make_batch as jax_make_batch
from repro.models.api import param_count_shape_only
from repro.runtime.server import ServeConfig as JaxServeConfig
from repro.runtime.server import ServeEngine as JaxServeEngine
from repro_torch.configs.base import get_config
from repro_torch.convert import params_from_jax
from repro_torch.data import pipeline
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.api import build_model, make_batch, param_module
from repro_torch.runtime.graphs import DecodeGraphs
from repro_torch.runtime.server import ServeConfig, ServeEngine

ARCH = "seamless_m4t_medium"
# fp32 everywhere; logits after a whole (reduced) model
TOL = dict(atol=1e-4, rtol=1e-4)
B, S, ROOM, STEPS = 2, 24, 8, 6


def _np(x) -> np.ndarray:
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.fixture(scope="module")
def seamless():
    """The reduced config, the reference model and its parameters (fp32),
    the port's model on the same parameters, and a prompt."""
    cfg, jcfg = get_config(ARCH).reduced(), jax_get_config(ARCH).reduced()
    jmodel = jax_build_model(jcfg, dtype=jnp.float32)
    jparams = jmodel.init(jax.random.key(3))
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                              cfg, device="cpu", dtype=torch.float32)
    model = build_model(cfg, device="cpu", dtype=torch.float32)
    toks = np.random.default_rng(5).integers(
        0, cfg.vocab, size=(B, S)).astype(np.int32)
    return cfg, jcfg, jmodel, jparams, model, tparams, toks


def _batches(cfg, jcfg, toks):
    jbatch = jpipeline.batch_for_model(jcfg, {"tokens": toks,
                                              "labels": toks})
    jbatch.pop("labels")
    return jbatch, pipeline.batch_for_model(cfg, {"tokens": toks},
                                            device="cpu")


def _reference_run(seamless, max_len, steps=STEPS):
    """The reference's prefill logits and its ``steps`` greedy decode
    steps' logits on a cache of ``max_len`` rows."""
    cfg, jcfg, jmodel, jparams, _, _, toks = seamless
    jbatch, _ = _batches(cfg, jcfg, toks)
    jl, jcache = jax.jit(jmodel.prefill)(
        jparams, jbatch, jmodel.init_cache(B, max_len, jnp.float32))
    out, nxt = [np.asarray(jl)], []
    jdecode = jax.jit(jmodel.decode)
    for _ in range(steps):
        nxt.append(np.array(jnp.argmax(jl, axis=-1), np.int32))
        jl, jcache = jdecode(jparams, {"tokens": jnp.asarray(
            nxt[-1][:, None])}, jcache)
        out.append(np.asarray(jl))
    return out, nxt


@pytest.fixture(scope="module")
def reference(seamless):
    return _reference_run(seamless, S + ROOM)


def test_encoder_output_matches_reference(seamless):
    cfg, jcfg, _, jparams, _, tparams, toks = seamless
    jbatch, tbatch = _batches(cfg, jcfg, toks)
    want = jax.jit(lambda p, x: JT.encode(p, jcfg, None, x))(
        jparams, jbatch["src_embeds"])
    with torch.inference_mode():
        got = T.encode(tparams, cfg, tbatch["src_embeds"])
    assert got.shape == (B, S, cfg.d_model)
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)


def test_prefill_and_decode_logits_match_reference(seamless, reference):
    """Prefill, then 6 decode steps fed the reference's greedy tokens, on
    a cache of S + 8 rows: every step within 1e-4, the encoder output
    written into the cache's first S rows and zeros after them."""
    cfg, jcfg, _, _, model, tparams, toks = seamless
    want, nxt = reference
    _, tbatch = _batches(cfg, jcfg, toks)
    with torch.inference_mode():
        cache = model.init_cache(B, S + ROOM, torch.float32)
        tl, cache = model.prefill(tparams, tbatch, cache)
        np.testing.assert_allclose(_np(tl), want[0], **TOL)
        enc = T.encode(tparams, cfg, tbatch["src_embeds"])
        assert torch.equal(cache["enc_out"][:, :S], enc)
        assert not cache["enc_out"][:, S:].any()
        for step in range(STEPS):
            tl, cache = model.decode(tparams, model.decode_batch(
                torch.from_numpy(nxt[step])), cache)
            np.testing.assert_allclose(_np(tl), want[step + 1], **TOL,
                                       err_msg=f"decode step {step}")
    assert cache["len"] == int(cache["pos"]) == S + STEPS


def test_greedy_serve_engine_matches_reference(seamless):
    """Both packages' ``ServeEngine`` on the same prompts; then a second
    cohort of a shorter prompt and as many more new tokens takes the
    first one's decode slot (the same rows and cache length), whose
    ``enc_out`` rows past the new source must be zero again."""
    cfg, _, jmodel, jparams, model, tparams, toks = seamless
    jeng = JaxServeEngine(jmodel, jparams,
                          JaxServeConfig(max_new_tokens=5,
                                         cache_dtype=jnp.float32))
    teng = ServeEngine(model, tparams,
                       ServeConfig(max_new_tokens=5,
                                   cache_dtype=torch.float32), device="cpu")
    got = teng.generate(toks)
    assert got.shape == (B, 5)
    np.testing.assert_array_equal(got, jeng.generate(toks))
    short = toks[:, :S - 4]
    np.testing.assert_array_equal(teng.generate(short, max_new=9),
                                  jeng.generate(short, max_new=9))
    assert teng.stats["nonfinite_logits"] == 0


def test_reused_decode_slot_zeroes_the_encoder_output(seamless):
    """``DecodeGraphs.start`` zeroes every top-level tensor of a reused
    slot's cache, ``enc_out`` included."""
    cfg, _, _, _, model, tparams, _ = seamless
    graphs = DecodeGraphs(model, tparams, mode="eager",
                          stats=dict(eager_rounds=0))
    slot = graphs.start(B, S, torch.float32)
    assert slot.cache["enc_out"].shape == (B, S, cfg.d_model)
    assert set(slot.inputs) == {"tokens"}
    slot.cache["enc_out"].fill_(1.0)
    graphs.release(slot)
    again = graphs.start(B, S, torch.float32)
    assert again is slot and not again.cache["enc_out"].any()


def test_target_embedding_scale_bites(seamless, reference):
    """Behaviour (a): prefill's target embedding is unscaled and decode's
    scaled by sqrt(d_model) (the reference's ``prefill`` and ``decode``,
    with tied embeddings).  A scaled prefill, or an unscaled decode, puts
    the port outside the tolerance of the reference's logits."""
    cfg, jcfg, _, _, model, tparams, toks = seamless
    want, nxt = reference
    _, tbatch = _batches(cfg, jcfg, toks)
    scale = cfg.d_model ** 0.5
    with torch.inference_mode():
        src, tgt, pos = model._encdec_in(tparams, tbatch)
        scaled, _ = T.prefill_encdec(
            tparams, cfg, src, tgt * scale, pos,
            model.init_cache(B, S + ROOM, torch.float32))
        assert np.abs(_np(scaled[:, 0]) - want[0]).max() > 100 * TOL["atol"]
        cache = model.init_cache(B, S + ROOM, torch.float32)
        model.prefill(tparams, tbatch, cache)
        x = L.embed(tparams.embed.emb, torch.from_numpy(nxt[0])[:, None])
        unscaled, _ = T.decode_step_encdec(tparams, cfg, x, cache)
    assert np.abs(_np(unscaled[:, 0]) - want[1]).max() > 100 * TOL["atol"]


def test_padded_encoder_output_bites(seamless, reference):
    """Behaviour (b): decode's cross-attention runs over all S + 8 rows
    of ``enc_out``, zeros included.  Over the source's S rows alone the
    first decode step's logits fall outside the tolerance of the
    reference's; so do the reference's own on a cache of S + 1 rows."""
    cfg, jcfg, _, _, model, tparams, toks = seamless
    want, nxt = reference
    _, tbatch = _batches(cfg, jcfg, toks)
    with torch.inference_mode():
        cache = model.init_cache(B, S + ROOM, torch.float32)
        model.prefill(tparams, tbatch, cache)
        unpadded = copy.copy(cache)
        unpadded["enc_out"] = cache["enc_out"][:, :S]
        tl, _ = model.decode(tparams, model.decode_batch(
            torch.from_numpy(nxt[0])), unpadded)
    assert np.abs(_np(tl) - want[1]).max() > 100 * TOL["atol"]
    shorter, _ = _reference_run(seamless, S + 1, steps=1)
    assert np.abs(shorter[1] - want[1]).max() > 100 * TOL["atol"]
    np.testing.assert_allclose(shorter[0], want[0], **TOL)


def test_source_longer_than_the_cache_raises(seamless):
    """Behaviour (c): the reference returns an unpadded ``enc_out`` of the
    source's length there; the port's buffers are fixed, so it raises."""
    cfg, _, _, _, model, tparams, toks = seamless
    batch = pipeline.batch_for_model(cfg, {"tokens": toks}, device="cpu")
    with torch.inference_mode(), pytest.raises(ValueError, match="source"):
        model.prefill(tparams, batch, model.init_cache(B, S - 1,
                                                       torch.float32))


def test_batches_equal_reference(seamless):
    """``batch_for_model`` (with and without labels, and one data-parallel
    rank's rows) and ``make_batch`` (prefill and decode) equal the
    reference's, key for key and bit for bit."""
    cfg, jcfg, *_ = seamless
    toks = np.random.default_rng(9).integers(
        0, cfg.vocab, size=(4, 9)).astype(np.int32)
    data = {"tokens": toks, "labels": np.roll(toks, -1, axis=1)}
    want = jpipeline.batch_for_model(jcfg, data)
    got = pipeline.batch_for_model(cfg, data, device="cpu")
    assert set(got) == set(want) == {"src_embeds", "tgt_tokens", "labels"}
    for key in want:
        assert got[key].numpy().dtype == np.asarray(want[key]).dtype
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]))

    class DataRank:                   # dp rank 1 of 2
        dp_size, dp_index = 2, 1
    half = pipeline.batch_for_model(cfg, data, device="cpu", pctx=DataRank())
    for key in want:
        np.testing.assert_array_equal(half[key].numpy(),
                                      np.asarray(want[key])[2:])
    prompt = pipeline.batch_for_model(cfg, {"tokens": toks}, device="cpu")
    assert set(prompt) == {"src_embeds", "tgt_tokens"}
    model = build_model(cfg, device="cpu", dtype=torch.float32)
    assert set(model.decode_inputs(toks[:, 0])) == {"tokens"}
    assert model.decode_batch(torch.from_numpy(toks[:, 0]))["tokens"].shape \
        == (4, 1)
    for kind in ("prefill", "decode"):
        want = jax_make_batch(jcfg, kind, 3, 6, rng_seed=4)
        got = make_batch(cfg, kind, 3, 6, rng_seed=4, device="cpu")
        assert set(got) == set(want)
        for key in want:
            np.testing.assert_array_equal(got[key].numpy(),
                                          np.asarray(want[key]))


def test_config_and_full_parameter_count_equal_reference():
    """The copied config and its reduced variant equal the reference's
    field by field, and the full model's parameters (on the meta device)
    count the reference's ``param_count_shape_only``: about 0.62 B."""
    cfg, jcfg = get_config(ARCH), jax_get_config(ARCH)
    assert get_config("seamless-m4t-medium") is cfg
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert dataclasses.asdict(cfg.reduced()) == \
        dataclasses.asdict(jcfg.reduced())
    params = param_module(cfg, device="meta", dtype=torch.bfloat16)
    assert len(params.enc_blocks) == cfg.n_enc_layers == 12
    assert params.blocks[0].xattn is not None
    assert params.blocks[0].pnx is None and params.unembed is None
    n = sum(math.prod(p.shape) for p in params.parameters())
    assert n == param_count_shape_only(jcfg)
    assert 0.6e9 < n < 0.64e9


def test_layers_cut_the_encoder_too():
    """``--layers`` cuts the encoder with the decoder, as ``reduced()``
    does; no cut is the default."""
    from repro_torch.launch.serve import serve_config
    from repro_torch.launch.train import train_config
    for make in (serve_config, train_config):
        cut = make(ARCH, layers=2, smoke=False)
        assert (cut.n_layers, cut.n_enc_layers, cut.d_model) == (2, 2, 1024)
        assert make(ARCH, layers=None, smoke=False) == get_config(ARCH)
