"""The port's single-rank MoE path and model against the JAX package.

Same numpy inputs (and the reference's own parameters, carried across by
``repro_torch.convert.params_from_jax``) through both packages on the CPU:
pack maps bit-exact, activations and logits within fp32 tolerances.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jax_get_config
from repro.core import collectives as jcl
from repro.models import moe as jmoe
from repro.models.api import build_model as jax_build_model
from repro_torch.configs.base import get_config
from repro_torch.convert import params_from_jax
from repro_torch.core import collectives as tcl
from repro_torch.models import moe as tmoe
from repro_torch.models.api import build_model

# fp32 everywhere; the two frameworks sum in different orders
TOL = dict(atol=1e-5, rtol=1e-5)
# logits after a whole (reduced) model: errors compound over the layers
LOGIT_TOL = dict(atol=1e-4, rtol=1e-4)


def _np(x) -> np.ndarray:
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# the reference under jit: one compile instead of one per eager op
_jit_dispatch = jax.jit(jcl.hierarchical_dispatch, static_argnums=(3, 4))
_jit_combine = jax.jit(jcl.hierarchical_combine)


def _dispatch_both(n, h, e, k, cf, seed):
    rng = np.random.default_rng(seed)
    tokens = rng.normal(size=(n, h)).astype(np.float32)
    logits = rng.normal(size=(n, e)).astype(np.float32)   # distinct
    jmesh = jcl.EPMesh(pod_axis=None, ep_axis="_none", num_pods=1,
                       ep_per_pod=1)
    tmesh = tcl.EPMesh(pod_axis=None, ep_axis="_none", num_pods=1,
                       ep_per_pod=1)
    jcfg = jmoe.balanced_capacities(n, k, 1, 1, e, cf)
    tcfg = tmoe.balanced_capacities(n, k, 1, 1, e, cf)
    assert jcfg.__dict__ == tcfg.__dict__
    jg, ji = jcl.route_topk(jnp.asarray(logits), k)
    tg, ti = tcl.route_topk(torch.from_numpy(logits), k)
    np.testing.assert_array_equal(_np(ti), np.asarray(ji))
    np.testing.assert_allclose(_np(tg), np.asarray(jg), **TOL)
    jout = _jit_dispatch(jnp.asarray(tokens), ji, jg, jcfg, jmesh)
    tout = tcl.hierarchical_dispatch(torch.from_numpy(tokens), ti, tg, tcfg,
                                     tmesh)
    return rng, jout, tout


@pytest.mark.parametrize("kind", ["zeros", "integers"])
def test_route_topk_breaks_ties_as_reference(kind):
    """Tied router logits: both packages take the lower expert index first
    (``lax.top_k``'s order), so ids and gates agree exactly."""
    if kind == "zeros":
        logits = np.zeros((8, 16), np.float32)
    else:
        logits = np.random.default_rng(3).integers(
            -2, 3, size=(64, 16)).astype(np.float32)
    for k in (1, 2, 4):
        jg, ji = jcl.route_topk(jnp.asarray(logits), k)
        tg, ti = tcl.route_topk(torch.from_numpy(logits), k)
        np.testing.assert_array_equal(_np(ti), np.asarray(ji))
        np.testing.assert_allclose(_np(tg), np.asarray(jg), **TOL)
    if kind == "zeros":
        assert _np(ti)[0].tolist() == [0, 1, 2, 3]


@pytest.mark.parametrize("n,h,e,k,cf", [
    (64, 16, 16, 4, 1.25),     # DBRX routing and capacity factor
    (64, 16, 16, 4, 0.5),      # drops at every stage
    (64, 16, 16, 4, 8.0),      # no drops
    (48, 8, 8, 2, 1.25),       # reduced-DBRX routing
    (5, 8, 16, 4, 1.25),       # decode-sized batch
    (6, 8, 16, 4, 1.25),       # 6 * 1.25 = 7.5: Python's round gives 8
])
def test_dispatch_combine_match_reference(n, h, e, k, cf):
    rng, (jtok, jgate, jst), (ttok, tgate, tst) = _dispatch_both(
        n, h, e, k, cf, seed=n * 31 + e)
    for name in ("map_pod", "map_ep", "map_exp", "recv_src"):
        np.testing.assert_array_equal(_np(getattr(tst, name)),
                                      np.asarray(getattr(jst, name)),
                                      err_msg=name)
    np.testing.assert_array_equal(_np(ttok), np.asarray(jtok))
    np.testing.assert_allclose(_np(tgate), np.asarray(jgate), **TOL)
    kept = int((_np(tst.map_exp) >= 0).sum())     # (token, expert) pairs
    if cf < 1:
        assert kept < n * k and int((_np(tst.map_pod) >= 0).sum()) < n
    elif cf >= 8:
        assert kept == n * k
    expert_out = rng.normal(size=ttok.shape).astype(np.float32)
    jcomb = _jit_combine(jnp.asarray(expert_out), jgate, jst)
    tcomb = tcl.hierarchical_combine(torch.from_numpy(expert_out), tgate,
                                     tst)
    assert tcomb.dtype == torch.float32 and tcomb.shape == (n, h)
    np.testing.assert_allclose(_np(tcomb), np.asarray(jcomb), **TOL)


def test_planner_and_tensor_parallel_slices_raise():
    """The context takes the planner's knobs and, since the telemetry
    slice, a calibration store; bad knobs raise.  Tensor parallelism is
    taken: a model axis needs its ranks (a mesh of 2 over a process group
    of 1 raises), and the deferred TP reduction and split-TP domains are
    knobs of the context."""
    from repro_torch.parallel.context import ParallelContext
    from repro_torch.parallel.mesh import RankMesh
    mesh = RankMesh((1, 1, 1))
    assert ParallelContext(mesh, calibration=":memory:").calibration \
        == ":memory:"
    with pytest.raises(ValueError, match="holds 2 ranks"):
        RankMesh((1, 1, 2))
    pctx = ParallelContext(mesh, tp_subgroups=2, moe_deferred_tp_reduce=True)
    assert (pctx.tp_subgroups, pctx.moe_deferred_tp_reduce) == (2, True)
    with pytest.raises(ValueError, match="tp_subgroups"):
        ParallelContext(mesh, tp_subgroups=0)
    with pytest.raises(ValueError, match="moe_microbatch"):
        ParallelContext(mesh, moe_microbatch=0)
    assert ParallelContext(mesh, plan_policy="auto").plan_policy == "auto"
    pctx = ParallelContext(mesh, moe_scheme="baseline",
                           moe_combine="hierarchical", moe_microbatch=2)
    assert pctx.moe_pipeline_kwargs(16, 4, 64, 128) == {
        "moe_scheme": "baseline", "moe_combine": "baseline",
        "microbatch": 2}


@pytest.mark.parametrize("scheme", ["unicast_combine", "baseline"])
def test_one_rank_schemes_match_reference(scheme):
    """The unicast combine and the baseline round trip on one rank (no
    transport) against the reference's."""
    n, h, e, k, cf = 24, 8, 8, 2, 1.25
    rng, (jtok, jgate, jst), (ttok, tgate, tst) = _dispatch_both(
        n, h, e, k, cf, seed=4)
    if scheme == "baseline":
        jmesh = jst.mesh
        tmesh = tst.mesh
        jcfg = jmoe.unicast_capacities(jst.cfg, n, k, 1, e, cf)
        tcfg = tmoe.unicast_capacities(tst.cfg, n, k, 1, e, cf)
        assert jcfg.__dict__ == tcfg.__dict__
        tok = rng.normal(size=(n, h)).astype(np.float32)
        logits = rng.normal(size=(n, e)).astype(np.float32)
        jg, ji = jcl.route_topk(jnp.asarray(logits), k)
        tg, ti = tcl.route_topk(torch.from_numpy(logits), k)
        jtok, jgate, jst = jax.jit(jcl.baseline_dispatch,
                                   static_argnums=(3, 4))(
            jnp.asarray(tok), ji, jg, jcfg, jmesh)
        ttok, tgate, tst = tcl.baseline_dispatch(torch.from_numpy(tok), ti,
                                                 tg, tcfg, tmesh)
        for name in ("map_rank", "map_exp"):
            np.testing.assert_array_equal(_np(getattr(tst, name)),
                                          np.asarray(getattr(jst, name)))
        jcombine, tcombine = jcl.baseline_combine, tcl.baseline_combine
    else:
        jcombine = jcl.hierarchical_combine_unicast
        tcombine = tcl.hierarchical_combine_unicast
    np.testing.assert_array_equal(_np(ttok), np.asarray(jtok))
    expert_out = rng.normal(size=ttok.shape).astype(np.float32)
    jcomb = jax.jit(jcombine)(jnp.asarray(expert_out), jgate, jst)
    tcomb = tcombine(torch.from_numpy(expert_out), tgate, tst)
    np.testing.assert_allclose(_np(tcomb), np.asarray(jcomb), **TOL)


@pytest.mark.parametrize("n_tokens,k,ranks,per_rank,cf", [
    (512, 4, 4, 4, 1.25), (1, 4, 4, 4, 4.0), (24, 2, 4, 2, 1.0),
    (7, 8, 32, 12, 1.1)])
def test_unicast_capacities_copy_reference(n_tokens, k, ranks, per_rank, cf):
    base_t = tmoe.balanced_capacities(n_tokens, k, 2, ranks // 2, per_rank,
                                      cf)
    base_j = jmoe.balanced_capacities(n_tokens, k, 2, ranks // 2, per_rank,
                                      cf)
    assert tmoe.unicast_capacities(base_t, n_tokens, k, ranks, per_rank,
                                   cf).__dict__ == jmoe.unicast_capacities(
        base_j, n_tokens, k, ranks, per_rank, cf).__dict__


def test_gather_rows_matches_reference():
    rng = np.random.default_rng(3)
    tok = rng.normal(size=(10, 3)).astype(np.float32)
    idx = np.array([[3, -1, 9], [0, 0, -1]], np.int32)
    got = tcl.gather_rows(torch.from_numpy(tok), torch.from_numpy(idx))
    exp = jcl.gather_rows(jnp.asarray(tok), jnp.asarray(idx))
    np.testing.assert_array_equal(_np(got), np.asarray(exp))


@pytest.mark.parametrize("n_tokens,k,p,d,per_rank,cf", [
    (2048, 4, 1, 1, 16, 1.25), (4, 4, 1, 1, 16, 1.25), (16, 2, 1, 1, 8, 8.0),
    (6, 4, 2, 4, 2, 1.25), (10, 8, 4, 8, 12, 1.1)])
def test_capacities_copy_reference(n_tokens, k, p, d, per_rank, cf):
    assert tmoe.balanced_capacities(n_tokens, k, p, d, per_rank, cf) \
        .__dict__ == jmoe.balanced_capacities(
            n_tokens, k, p, d, per_rank, cf).__dict__


class _RankOf:
    """Just enough of a ParallelContext for the expert sharding: EP rank
    ``index`` of ``ranks`` over (pod, data), with a model axis of 1."""
    pod_axis, data_axis = "pod", "data"
    model_size = 1

    def __init__(self, index: int, ranks: int):
        self.index, self.ranks, self.mesh = index, ranks, self

    def ep_ranks(self, num_experts):
        return True, self.ranks

    def axis_index(self, *names):
        return self.index


def test_rank_shard_draws_the_one_rank_experts():
    """A rank's experts, drawn alone from their own seeds, equal the same
    experts of the one-rank model; the router and attention are whole."""
    from repro_torch.models import transformer as T
    cfg = get_config("dbrx_132b").reduced()

    def init(pctx):
        return T.init_transformer(cfg, generator=torch.Generator().manual_seed(
            3), device="cpu", dtype=torch.float32, pctx=pctx)

    # rank 2 of 4 EP ranks holds experts 4 and 5 of 8
    whole, shard = init(None), init(_RankOf(2, 4))
    for b_whole, b_shard in zip(whole.blocks, shard.blocks):
        if b_whole.moe is None:
            continue
        assert b_shard.moe.first == 4 and b_shard.moe.w1.shape[0] == 2
        for name in ("w1", "w3", "w2"):
            assert torch.equal(getattr(b_shard.moe, name),
                               getattr(b_whole.moe, name)[4:6])
        assert torch.equal(b_shard.moe.router, b_whole.moe.router)
        assert torch.equal(b_shard.attn.wq, b_whole.attn.wq)


@pytest.fixture(scope="module")
def reduced():
    """Reduced DBRX in fp32 and the reference's parameters for it."""
    cfg = get_config("dbrx_132b").reduced()
    jcfg = jax_get_config("dbrx_132b").reduced()
    jmodel = jax_build_model(jcfg, dtype=jnp.float32)
    jparams = jmodel.init(jax.random.key(0))
    np_params = jax.tree_util.tree_map(np.asarray, jparams)
    tparams = params_from_jax(np_params, cfg, device="cpu",
                              dtype=torch.float32)
    return cfg, jcfg, jmodel, jparams, tparams


def test_moe_ffn_matches_reference(reduced):
    cfg, jcfg, _, jparams, tparams = reduced
    rng = np.random.default_rng(11)
    x = rng.normal(size=(2, 8, cfg.d_model)).astype(np.float32)
    jmp = jax.tree_util.tree_map(lambda a: a[0], jparams["layers"]["moe"])
    jout, jaux = jax.jit(jmoe.moe_ffn, static_argnums=(2, 3))(
        jmp, jnp.asarray(x), jcfg, None)
    tout, taux = tmoe.moe_ffn(tparams.blocks[0].moe, torch.from_numpy(x),
                              cfg)
    np.testing.assert_allclose(_np(tout), np.asarray(jout), **TOL)
    np.testing.assert_allclose(float(taux), float(jaux), **TOL)


def test_prefill_and_decode_logits_match_reference(reduced):
    cfg, _, jmodel, jparams, tparams = reduced
    model = build_model(cfg, device="cpu", dtype=torch.float32)
    toks = np.random.default_rng(5).integers(
        0, cfg.vocab, size=(2, 8)).astype(np.int32)
    # fp32 caches: a bf16 cache turns 1e-7 differences that straddle a
    # rounding boundary into one-ulp (4e-3 relative) steps
    jcache = jmodel.init_cache(2, 12, jnp.float32)
    tcache = model.init_cache(2, 12, torch.float32)
    jprefill, jdecode = jax.jit(jmodel.prefill), jax.jit(jmodel.decode)
    jl, jcache = jprefill(jparams, {"tokens": jnp.asarray(toks)}, jcache)
    with torch.inference_mode():
        tl, tcache = model.prefill(tparams,
                                   {"tokens": torch.from_numpy(toks)}, tcache)
    np.testing.assert_allclose(_np(tl), np.asarray(jl), **LOGIT_TOL)
    for li in range(cfg.n_layers):
        np.testing.assert_allclose(_np(tcache["k"][li]),
                                   np.asarray(jcache["k"][li]), **TOL)
    for _ in range(3):
        nxt = np.array(jnp.argmax(jl, axis=-1), np.int32)[:, None]
        jl, jcache = jdecode(jparams, {"tokens": jnp.asarray(nxt)}, jcache)
        with torch.inference_mode():
            tl, tcache = model.decode(tparams,
                                      {"tokens": torch.from_numpy(nxt)},
                                      tcache)
        np.testing.assert_allclose(_np(tl), np.asarray(jl), **LOGIT_TOL)
    assert tcache["len"] == int(jcache["len"]) == 11


def test_converter_keeps_router_and_norms_fp32(reduced):
    cfg, _, _, jparams, _ = reduced
    np_params = jax.tree_util.tree_map(np.asarray, jparams)
    p = params_from_jax(np_params, cfg, device="cpu", dtype=torch.bfloat16)
    blk = p.blocks[0]
    assert blk.moe.router.dtype == blk.ln1.w.dtype == torch.float32
    assert blk.moe.w1.dtype == blk.attn.wq.dtype == torch.bfloat16
    assert p.unembed.dtype == p.embed.emb.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        blk.attn.wq.float().numpy(),
        np.asarray(jnp.asarray(jparams["layers"]["attn"]["wq"][0])
                   .astype(jnp.bfloat16).astype(jnp.float32)))
    assert len(p.blocks) == cfg.n_layers


def test_dense_tied_windowed_model_matches_reference():
    """The dense family: tied embeddings (scaled by sqrt(d)), gated MLPs
    and alternating local/global windows in prefill and decode."""
    import dataclasses
    kw = dict(family="dense", num_experts=0, top_k=0, tie_embeddings=True,
              window=4, local_global_alternating=True)
    cfg = dataclasses.replace(get_config("dbrx_132b").reduced(), **kw)
    jcfg = dataclasses.replace(jax_get_config("dbrx_132b").reduced(), **kw)
    jmodel = jax_build_model(jcfg, dtype=jnp.float32)
    jparams = jmodel.init(jax.random.key(2))
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                              cfg, device="cpu", dtype=torch.float32)
    assert tparams.unembed is None and tparams.blocks[0].mlp is not None
    model = build_model(cfg, device="cpu", dtype=torch.float32)
    toks = np.random.default_rng(9).integers(
        0, cfg.vocab, size=(2, 8)).astype(np.int32)
    jcache = jmodel.init_cache(2, 11, jnp.float32)
    tcache = model.init_cache(2, 11, torch.float32)
    jl, jcache = jax.jit(jmodel.prefill)(
        jparams, {"tokens": jnp.asarray(toks)}, jcache)
    jdecode = jax.jit(jmodel.decode)
    with torch.inference_mode():
        tl, tcache = model.prefill(tparams, {"tokens": torch.from_numpy(toks)},
                                   tcache)
        np.testing.assert_allclose(_np(tl), np.asarray(jl), **LOGIT_TOL)
        for _ in range(2):
            nxt = np.array(jnp.argmax(jl, axis=-1), np.int32)[:, None]
            jl, jcache = jdecode(jparams, {"tokens": jnp.asarray(nxt)}, jcache)
            tl, tcache = model.decode(tparams,
                                      {"tokens": torch.from_numpy(nxt)},
                                      tcache)
            np.testing.assert_allclose(_np(tl), np.asarray(jl), **LOGIT_TOL)


def test_converter_takes_a_rank_shard(reduced):
    """``params_from_jax`` with a pctx keeps the rank's experts of the
    reference's tree and everything else whole."""
    cfg, _, _, jparams, tparams = reduced
    np_params = jax.tree_util.tree_map(np.asarray, jparams)
    shard = params_from_jax(np_params, cfg, device="cpu",
                            dtype=torch.float32, pctx=_RankOf(3, 4))
    for b_whole, b_shard in zip(tparams.blocks, shard.blocks):
        if b_whole.moe is None:
            continue
        for name in ("w1", "w3", "w2"):
            assert torch.equal(getattr(b_shard.moe, name),
                               getattr(b_whole.moe, name)[6:8])
        assert torch.equal(b_shard.moe.router, b_whole.moe.router)
    assert torch.equal(shard.unembed, tparams.unembed)

