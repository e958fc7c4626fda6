"""Kimi-K2-1T's slice of the port against the JAX package: shared experts,
a dense first layer, and EP over 2 pods x 8 ep ranks.

- One rank: the reduced Kimi (8 experts, top-2, one shared expert, a dense
  first layer) with the reference's parameters carried across
  (``params_from_jax``): prefill and decode logits within
  ``test_torch_moe``'s tolerance, greedy tokens equal to the reference
  engine's, and the weights a rank's card shares (``shared_weights``)
  equal to the one-rank draw.
- 4 gloo ranks (2 x 2, 2 experts a rank, each rank drawing its own
  weights): the one-rank engine's tokens under all three scheme pairs.
- 16 gloo ranks (2 x 8) on ``reduced(num_experts=16)`` at capacity factor
  8: the JAX side is this file run as a script in a subprocess with 16
  forced CPU devices; pack maps bit-exact rank by rank, combines and
  ``moe_ffn`` within 1e-5 of the reference's ``shard_map``; the model
  served over the 16 ranks, the non-expert weights made once and shared
  with every rank, gives the one-rank engine's tokens.
"""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[1]
PODS, EPS = 2, 8
WORLD = PODS * EPS
TOL = dict(atol=1e-5, rtol=1e-5)
LOGIT_TOL = dict(atol=1e-4, rtol=1e-4)
PAIRS = ("hierarchical+hierarchical", "hierarchical+baseline",
         "baseline+baseline")
# the Kimi MoE layer's round trip at 2 x 8 on its own: name, dispatch
# scheme, combine; experts scale their rows by (expert + 1) / 100
CASES = (("hier", "hierarchical", "hierarchical"),
         ("unicast", "hierarchical", "unicast"),
         ("baseline", "baseline", "baseline"))
ROWS = 8                          # tokens a rank
SPAWN_TIMEOUT_S = 300


def kimi16(get_config):
    """The reduced Kimi with 16 experts: one a rank over 2 x 8, top-2,
    capacity factor 8 (``reduced``'s: no stage drops a pair)."""
    return get_config("kimi_k2_1t").reduced(num_experts=16)


# ---------------------------------------------------------------------------
# the JAX side at 2 x 8 (run as a script)
# ---------------------------------------------------------------------------

def jax_reference(path: str) -> None:
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from repro.configs.base import get_config
    from repro.core import collectives as cl
    from repro.models import moe as M
    from repro.parallel.compat import shard_map
    from repro.parallel.context import ParallelContext

    assert jax.device_count() == WORLD
    cfg = kimi16(get_config)
    e, k = cfg.num_experts, cfg.top_k
    n = ROWS * WORLD
    rng = np.random.default_rng(17)
    tokens = rng.normal(size=(n, cfg.d_model)).astype(np.float32)
    logits = rng.normal(size=(n, e)).astype(np.float32)
    gates, ids = jax.jit(lambda lg: cl.route_topk(lg, k))(
        jnp.asarray(logits))
    mesh = jax.make_mesh((PODS, EPS), ("pod", "ep"))
    epmesh = cl.EPMesh(pod_axis="pod", ep_axis="ep", num_pods=PODS,
                       ep_per_pod=EPS)
    spec = P(("pod", "ep"))
    dcfg = M.balanced_capacities(ROWS, k, PODS, EPS, 1, cfg.moe_capacity)
    unicast = M.unicast_capacities(dcfg, ROWS, k, WORLD, 1,
                                   cfg.moe_capacity)
    out = {"tokens": tokens, "ids": np.asarray(ids),
           "gates": np.asarray(gates)}
    for name, scheme, combine in CASES:
        dc = dcfg if scheme == "hierarchical" else unicast
        out[f"{name}/dcfg"] = np.array([dc.pod_capacity, dc.ep_capacity,
                                        dc.expert_capacity])

        def step(tok, ids_, gates_, scheme=scheme, combine=combine, dc=dc):
            rank = (jax.lax.axis_index("pod") * EPS
                    + jax.lax.axis_index("ep"))
            if scheme == "hierarchical":
                exp_tok, exp_gate, st = cl.hierarchical_dispatch(
                    tok, ids_, gates_, dc, epmesh)
                maps = (st.map_pod, st.map_ep, st.map_exp, st.recv_src)
            else:
                exp_tok, exp_gate, st = cl.baseline_dispatch(
                    tok, ids_, gates_, dc, epmesh)
                maps = (st.map_rank, st.map_exp)
            exp_tok = exp_tok * ((rank + 1.0) * 0.01)
            fn = {"hierarchical": cl.hierarchical_combine,
                  "unicast": cl.hierarchical_combine_unicast,
                  "baseline": cl.baseline_combine}[combine]
            return (fn(exp_tok, exp_gate, st), exp_gate) + maps

        names = ["out", "exp_gate"] + (
            ["map_pod", "map_ep", "map_exp", "recv_src"]
            if scheme == "hierarchical" else ["map_rank", "map_exp"])
        res = jax.jit(shard_map(step, mesh=mesh, in_specs=(spec,) * 3,
                                out_specs=(spec,) * len(names),
                                check_vma=False))(
            jnp.asarray(tokens), ids, gates)
        for key, val in zip(names, res):
            val = np.asarray(val)
            out[f"{name}/{key}"] = (val if key == "out" else
                                    val.reshape(WORLD, -1, *val.shape[1:]))

    # the whole MoE layer under a fixed context, each scheme pair
    mesh3 = jax.make_mesh((PODS, EPS, 1), ("pod", "data", "model"))
    params = M.init_moe(jax.random.key(0), cfg.d_model, cfg.expert_d_ff, e)
    for key, val in params.items():
        out[f"moe/{key}"] = np.asarray(val)
    x = np.random.default_rng(5).normal(
        size=(WORLD, ROWS, cfg.d_model)).astype(np.float32)
    out["moe/x"] = x
    for pair in PAIRS:
        scheme, combine = pair.split("+")
        pctx = ParallelContext(mesh=mesh3, pod_axis="pod", data_axis="data",
                               model_axis="model", plan_policy="fixed",
                               moe_scheme=scheme, moe_combine=combine)
        assert pctx.ep_ranks(e) == (True, WORLD)
        with mesh3:
            y, aux = jax.jit(lambda xx, p=pctx: M.moe_ffn(params, xx, cfg,
                                                          p))(jnp.asarray(x))
        out[f"moe/{pair}/y"] = np.asarray(y)
        out[f"moe/{pair}/aux"] = np.asarray(aux)
    np.savez(path, **out)


if __name__ == "__main__":
    jax_reference(sys.argv[1])
    raise SystemExit(0)


# ---------------------------------------------------------------------------
# the torch side
# ---------------------------------------------------------------------------

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.configs.base import get_config as jax_get_config  # noqa: E402
from repro.models.api import build_model as jax_build_model  # noqa: E402
from repro.runtime.server import ServeConfig as JaxServeConfig  # noqa: E402
from repro.runtime.server import ServeEngine as JaxServeEngine  # noqa: E402
from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.launch import ranks  # noqa: E402
from repro_torch.launch.serve import build_engine  # noqa: E402
from repro_torch.models.api import build_model  # noqa: E402
from repro_torch.models.transformer import shared_weights  # noqa: E402
from repro_torch.runtime.server import ServeConfig, ServeEngine  # noqa: E402


def _np(x) -> np.ndarray:
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _spec(tmp: Path, world: int, pods: int, ep: int, **kw) -> dict:
    return dict(world=world, pods=pods, ep=ep, backend="gloo", device="cpu",
                init_method=f"file://{tmp / 'store'}", timeout_s=60,
                out_dir=str(tmp / "out"), threads=1, **kw)


@pytest.fixture(scope="module")
def reduced():
    """The reduced Kimi in fp32 and the reference's parameters for it."""
    cfg = get_config("kimi_k2_1t").reduced()
    jmodel = jax_build_model(jax_get_config("kimi_k2_1t").reduced(),
                             dtype=jnp.float32)
    jparams = jmodel.init(jax.random.key(1))
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                              cfg, device="cpu", dtype=torch.float32)
    return cfg, jmodel, jparams, tparams


def test_reduced_kimi_has_the_published_shape():
    """The reduced config keeps the shared expert and the dense first
    layer; the full one is the reference's, and the port serves it."""
    cfg, ref = get_config("kimi-k2-1t"), jax_get_config("kimi_k2_1t")
    assert dataclasses.asdict(cfg) == dataclasses.asdict(ref)
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
            cfg.head_dim, cfg.d_ff, cfg.vocab, cfg.num_experts, cfg.top_k,
            cfg.expert_d_ff, cfg.n_shared_experts, cfg.first_k_dense,
            cfg.tie_embeddings) == (61, 7168, 64, 8, 112, 18432, 163840,
                                    384, 8, 2048, 1, 1, False)
    small = cfg.reduced()
    assert (small.n_shared_experts, small.first_k_dense, small.num_experts,
            small.top_k) == (1, 1, 8, 2)
    params = build_model(small, device="cpu", dtype=torch.float32).init(
        torch.Generator().manual_seed(0))
    dense, moe = params.blocks
    assert dense.moe is None and dense.mlp.w1.shape == (64, 128)
    assert moe.mlp is None and moe.shared_mlp.w1.shape == (64, 128)


def test_prefill_and_decode_logits_match_reference(reduced):
    cfg, jmodel, jparams, tparams = reduced
    model = build_model(cfg, device="cpu", dtype=torch.float32)
    toks = np.random.default_rng(5).integers(
        0, cfg.vocab, size=(2, 8)).astype(np.int32)
    jcache = jmodel.init_cache(2, 12, jnp.float32)
    tcache = model.init_cache(2, 12, torch.float32)
    jl, jcache = jax.jit(jmodel.prefill)(
        jparams, {"tokens": jnp.asarray(toks)}, jcache)
    jdecode = jax.jit(jmodel.decode)
    with torch.inference_mode():
        tl, tcache = model.prefill(tparams,
                                   {"tokens": torch.from_numpy(toks)}, tcache)
        np.testing.assert_allclose(_np(tl), np.asarray(jl), **LOGIT_TOL)
        for _ in range(3):
            nxt = np.array(jnp.argmax(jl, axis=-1), np.int32)[:, None]
            jl, jcache = jdecode(jparams, {"tokens": jnp.asarray(nxt)},
                                 jcache)
            tl, tcache = model.decode(tparams,
                                      {"tokens": torch.from_numpy(nxt)},
                                      tcache)
            np.testing.assert_allclose(_np(tl), np.asarray(jl), **LOGIT_TOL)


def test_shared_expert_is_carried_across_and_adds_to_the_moe(reduced):
    """``shared_mlp`` takes the reference's key; the dense first layer
    (``layers_prefix``) its MLP; dropping the shared expert moves the
    logits, so the comparison above covers it."""
    cfg, _, jparams, tparams = reduced
    blk = tparams.blocks[1]
    np.testing.assert_array_equal(
        blk.shared_mlp.w2.numpy(),
        np.asarray(jparams["layers"]["shared_mlp"]["w2"][0]))
    np.testing.assert_array_equal(
        tparams.blocks[0].mlp.w1.numpy(),
        np.asarray(jparams["layers_prefix"][0]["mlp"]["w1"]))
    model = build_model(cfg, device="cpu", dtype=torch.float32)
    toks = torch.from_numpy(np.random.default_rng(6).integers(
        0, cfg.vocab, size=(1, 8)).astype(np.int32))
    with torch.inference_mode():
        with_shared = model.prefill(tparams, {"tokens": toks},
                                    model.init_cache(1, 8, torch.float32))[0]
        saved, blk.shared_mlp = blk.shared_mlp, None
        try:
            without = model.prefill(tparams, {"tokens": toks},
                                    model.init_cache(1, 8, torch.float32))[0]
        finally:
            blk.shared_mlp = saved
    assert (with_shared - without).abs().max() > 1e-3


def test_greedy_generate_matches_reference(reduced):
    cfg, jmodel, jparams, tparams = reduced
    prompts = np.random.default_rng(2).integers(
        0, cfg.vocab, size=(3, 8)).astype(np.int32)
    jeng = JaxServeEngine(jmodel, jparams, JaxServeConfig(
        max_new_tokens=6, cache_dtype=jnp.float32))
    teng = ServeEngine(build_model(cfg, device="cpu", dtype=torch.float32),
                       tparams, ServeConfig(max_new_tokens=6,
                                            cache_dtype=torch.float32),
                       device="cpu")
    got = teng.generate(prompts)
    np.testing.assert_array_equal(got, jeng.generate(prompts))
    assert teng.stats["nonfinite_logits"] == 0


def test_shared_weights_equal_the_one_rank_draw():
    """The weights a card's ranks share are the one-rank model's
    non-expert weights; a module built around them holds those tensors
    (no copy) and draws its own experts equal to the one-rank model's."""
    cfg = get_config("kimi_k2_1t").reduced()
    model = build_model(cfg, device="cpu", dtype=torch.float32)
    whole = model.init(torch.Generator().manual_seed(3))
    shared = shared_weights(cfg, generator=torch.Generator().manual_seed(3),
                            device="cpu", dtype=torch.float32)
    assert not any(name.endswith(("moe.w1", "moe.w2", "moe.w3"))
                   for name in shared)
    around = model.init(torch.Generator().manual_seed(3), shared=shared)
    assert around.embed.emb.data_ptr() == shared["embed.emb"].data_ptr()
    got = dict(around.named_parameters())
    for name, want in whole.named_parameters():
        assert torch.equal(got[name], want), name
    with pytest.raises(ValueError, match="do not fit"):
        build_model(get_config("dbrx_132b").reduced(), device="cpu",
                    dtype=torch.float32).init(
            torch.Generator().manual_seed(3), shared=shared)


# ---------------------------------------------------------------------------
# 4 ranks (2 x 2) and 16 ranks (2 x 8)
# ---------------------------------------------------------------------------

def _served(tmp, cfg, world, pods, ep, share: bool):
    """``cfg`` (fp32) served over gloo ranks under the three scheme pairs,
    and the one-rank engine's tokens on the same seeded weights."""
    prompts = np.random.default_rng(2).integers(
        0, cfg.vocab, size=(world, 8)).astype(np.int32)
    one = build_engine(cfg, device="cpu", dtype=torch.float32, seed=3,
                       max_new=5, cache_dtype=torch.float32)
    spec = _spec(tmp, world, pods, ep, cfg=cfg, dtype=torch.float32,
                 cache_dtype=torch.float32, seed=3, prompts=prompts,
                 max_new=5, runs=ranks.fixed_runs(), warmup=True)
    shared = ranks.shared_weights(spec) if share else None
    return one.generate(prompts), ranks.run_ranks(
        ranks.serve_worker, spec, timeout_s=SPAWN_TIMEOUT_S, shared=shared)


@pytest.fixture(scope="module")
def served_2x2(tmp_path_factory):
    return _served(tmp_path_factory.mktemp("k4"),
                   get_config("kimi_k2_1t").reduced(), 4, 2, 2, share=False)


@pytest.fixture(scope="module")
def served_2x8(tmp_path_factory):
    return _served(tmp_path_factory.mktemp("k16"), kimi16(get_config),
                   WORLD, PODS, EPS, share=True)


@pytest.mark.parametrize("layout", ["2x2", "2x8"])
def test_generate_over_ranks_equals_one_rank(served_2x2, served_2x8,
                                             layout):
    """Every rank returns the one-rank engine's tokens under all three
    scheme pairs, and every pack of the warm-up equals its plain
    version."""
    expected, results = served_2x2 if layout == "2x2" else served_2x8
    assert len(results) == (4 if layout == "2x2" else WORLD)
    for r in results:
        for pair in PAIRS:
            got = r["runs"][pair]
            np.testing.assert_array_equal(got["tokens"], expected,
                                          err_msg=f"rank {r['rank']} {pair}")
            assert got["nonfinite_logits"] == 0
            assert got["packs"] and all(ok for *_, ok in got["packs"])


@pytest.mark.parametrize("layout", ["2x2", "2x8"])
def test_ranks_hold_their_experts_and_share_the_rest(served_2x2, served_2x8,
                                                     layout):
    """A rank's experts are its share of the layer's (2 of 8 at 2 x 2, 1 of
    16 at 2 x 8).  At 2 x 8 the non-expert weights came from the parent in
    shared memory; at 2 x 2 each rank drew its own."""
    _, results = served_2x2 if layout == "2x2" else served_2x8
    for r in results:
        mem = r["memory"]
        assert mem["weights_shared"] == (layout == "2x8")
        assert 0 < mem["experts_gb"] < mem["all_gb"]


def test_multiwrite_puts_fewer_bytes_on_the_pod_group_at_2x8(served_2x8):
    """From each pod-0 rank's own buffers of the first prefill dispatch:
    occupied rows equal ``dispatch_pod_bytes`` on its expert ids, and
    MultiWrite puts fewer on the pod group than the baseline."""
    _, results = served_2x8
    for r in results:
        hier = r["runs"][PAIRS[0]]
        base = r["runs"][PAIRS[2]]
        assert hier["pod_bytes"]["occupied"] <= base["pod_bytes"]["occupied"]
        if hier["pod"] == 0:
            assert (hier["pod_bytes"]["occupied"]
                    == hier["analytic_pod_bytes"]["multiwrite"])
            assert (base["pod_bytes"]["occupied"]
                    == base["analytic_pod_bytes"]["baseline"])


@pytest.fixture(scope="module", autouse=True)
def jax_side(tmp_path_factory):
    """The JAX subprocess at 2 x 8, started when the module's first test
    runs so that it works beside the tests before :func:`reference`, which
    waits for it."""
    tmp = tmp_path_factory.mktemp("jax16")
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS=f"--xla_force_host_platform_device_count={WORLD}",
               PYTHONPATH=os.pathsep.join(
                   [str(ROOT / "src"), os.environ.get("PYTHONPATH", "")]))
    with open(tmp / "stderr.txt", "w") as err:
        proc = subprocess.Popen([sys.executable, __file__,
                                 str(tmp / "reference.npz")], env=env,
                                cwd=ROOT, stdout=subprocess.DEVNULL,
                                stderr=err)
    yield tmp, proc
    if proc.poll() is None:
        proc.kill()
    proc.wait()


@pytest.fixture(scope="module")
def reference(jax_side):
    tmp, proc = jax_side
    code = proc.wait(timeout=240)
    assert code == 0, (tmp / "stderr.txt").read_text()[-4000:]
    return dict(np.load(tmp / "reference.npz"))


@pytest.fixture(scope="module")
def dispatched_2x8(reference, tmp_path_factory):
    """The cases' round trips and the MoE layer at 2 x 8 on 16 gloo
    ranks."""
    tmp = tmp_path_factory.mktemp("d16")
    np.savez(tmp / "inputs.npz", **{
        f"{name}/{key}": reference[key] for name, *_ in CASES
        for key in ("tokens", "ids", "gates")})
    cfg = kimi16(get_config)
    cases = []
    for name, scheme, combine in CASES:
        pod, ep, expert = (float(v) for v in reference[f"{name}/dcfg"])
        cases.append(dict(name=name, scheme=scheme, combine=combine,
                          scaled=True, dcfg=dict(
                              num_experts=cfg.num_experts, top_k=cfg.top_k,
                              pod_capacity=pod, ep_capacity=ep,
                              expert_capacity=expert)))
    moe = [dict(name="moe", cfg=cfg, x=reference["moe/x"],
                weights={k: reference[f"moe/{k}"]
                         for k in ("router", "w1", "w3", "w2")})]
    spec = _spec(tmp, WORLD, PODS, EPS, inputs=str(tmp / "inputs.npz"),
                 cases=cases, moe=moe)
    return ranks.run_ranks(ranks.dispatch_worker, spec,
                           timeout_s=SPAWN_TIMEOUT_S)


@pytest.mark.parametrize("name", [c[0] for c in CASES])
def test_pack_maps_bit_exact_at_2x8(reference, dispatched_2x8, name):
    keys = ([k for k in ("map_pod", "map_ep", "map_exp", "recv_src",
                         "map_rank") if f"{name}/{k}" in reference]
            + ["exp_gate"])
    for rank, got in enumerate(dispatched_2x8):
        for key in keys:
            np.testing.assert_array_equal(
                got[name][key], reference[f"{name}/{key}"][rank],
                err_msg=f"{name} rank {rank} {key}")
    got = np.concatenate([r[name]["out"] for r in dispatched_2x8])
    np.testing.assert_allclose(got, reference[f"{name}/out"], **TOL)


@pytest.mark.parametrize("pair", PAIRS)
def test_moe_ffn_at_2x8_matches_reference(reference, dispatched_2x8, pair):
    got = np.concatenate([r["moe_ffn"]["moe"][pair]["y"]
                          for r in dispatched_2x8])
    np.testing.assert_allclose(got, reference[f"moe/{pair}/y"], **TOL)
    for r in dispatched_2x8:
        np.testing.assert_allclose(r["moe_ffn"]["moe"][pair]["aux"],
                                   float(reference[f"moe/{pair}/aux"]),
                                   **TOL)


@pytest.mark.parametrize("scheme", ["hierarchical", "baseline"])
def test_combine_sums_in_slot_blocks_equal_one_block(monkeypatch, scheme):
    """The combine sums its slots in blocks of ``SUM_BLOCK_BYTES`` (a Kimi
    layer's stage-2 partials would otherwise need twice 470 MB a rank):
    blocks of a few rows give the one-block sums bit for bit."""
    from repro_torch.core import collectives as cl
    from repro_torch.models.moe import balanced_capacities, unicast_capacities
    rng = np.random.default_rng(8)
    n, h, e, k = 96, 16, 24, 8
    tokens = torch.from_numpy(rng.normal(size=(n, h)).astype(np.float32))
    gates, ids = cl.route_topk(torch.from_numpy(
        rng.normal(size=(n, e)).astype(np.float32)), k)
    mesh = cl.EPMesh(pod_axis=None, ep_axis="_none", num_pods=1,
                     ep_per_pod=1)
    dcfg = balanced_capacities(n, k, 1, 1, e, 1.25)
    dispatch, combine = cl.hierarchical_dispatch, cl.hierarchical_combine
    if scheme == "baseline":
        dcfg = unicast_capacities(dcfg, n, k, 1, e, 1.25)
        dispatch, combine = cl.baseline_dispatch, cl.baseline_combine
    exp_tok, exp_gate, state = dispatch(tokens, ids, gates, dcfg, mesh)
    whole = combine(exp_tok * 0.5, exp_gate, state)
    monkeypatch.setattr(cl, "SUM_BLOCK_BYTES", 3 * h * 4)
    np.testing.assert_array_equal(
        combine(exp_tok * 0.5, exp_gate, state).numpy(), whole.numpy())
