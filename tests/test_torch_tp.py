"""The port's model axis against the JAX package: the split-TP MultiWrite
AllGather, tensor and sequence parallelism, and TP inside the experts.

The counterparts of ``tests/multidev/check_collectives.py``'s
``run_allgather_checks``, ``run_split_tp_layer_checks`` and
``run_split_tp_block_checks``:

- the JAX side is this file run as a script in a subprocess with 8 forced
  CPU devices; it draws the inputs from numpy seeds, runs the reference's
  ``shard_map`` programs and models and writes inputs, parameters and
  results to one ``.npz``;
- the torch side is gloo processes (``repro_torch.launch.ranks``) that read
  them, meeting through a ``file://`` store under the test's temporary
  directory.

(a) The bare gather over 8 ranks: ``allgather_reference``,
``multiwrite_allgather`` (paired and full, at the reference's splits),
``planned_allgather`` (the planner's plan at the datasheet and the ideal
hardware) and ``layers.split_tp_allgather`` (fixed and auto), every rank
bit-exact.  (b) The reduced Mistral-NeMo over 1 x 1 x 4 ranks, in fp32 on
the reference's parameters: prefill and 4 greedy decode steps within the
reference's 1e-4 of its forward on a (1, 4) mesh, at ``tp_subgroups`` 1, 2
and 4 with the decode KV length sharded and not; bit-identical across
``tp_subgroups``.  (c) The reduced DBRX over 1 x 2 x 2 ranks: ``moe_ffn``
within 1e-5 of the reference's with the deferred TP reduction off and on,
and the served tokens equal to the one-rank engine's.  (d) In process: the
split-TP gather site and the serve programs' plans with a model axis of 4
in 2 domains equal the reference's.
"""

import math
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[1]
GATHER_WORLD = 8
TOL = dict(atol=1e-5, rtol=1e-5)
LOGIT_TOL = dict(atol=1e-4, rtol=1e-4)   # the reference's own bound
SPAWN_TIMEOUT_S = 300
# (a): the reference's shapes a rank and its (mode, split) pairs
AG_SHAPES = ((16, 32), (8, 5), (64, 128))
AG_SPLITS = (("paired", 0.5), ("paired", 0.25), ("paired", 0.75),
             ("full", 0.5), ("full", 0.375))
PLANNED_HW = (None, "IDEAL")
STP_SHAPES = ((16, 32), (8, 5))
POLICIES = ("fixed", "auto")
# (b): the reference's reduction of Mistral-NeMo, 2 prompts of 16 tokens,
# 5 tokens greedy (a prefill and 4 decode steps)
TP_PROMPTS, TP_LEN, TP_NEW = 2, 16, 5
TP_RUNS = tuple((nd, ssd) for nd in (1, 2, 4) for ssd in (True, False))
# (c): reduced DBRX over 1 pod x 2 data x 2 model ranks
MOE_MESH = (1, 2, 2)
DEFERRED = (False, True)
MOE_PROMPTS, MOE_LEN, MOE_NEW = 4, 8, 6


def mistral_config(get_config):
    return get_config("mistral_nemo_12b").reduced(
        n_layers=2, d_model=64, n_heads=8, n_kv_heads=8, d_ff=128,
        vocab=256)


def ag_name(rows, feat, what):
    return f"ag/{rows}x{feat}/{what}"


def flatten(tree, prefix: str) -> dict:
    """A nest of dicts of arrays as ``{prefix/a/b: array}``."""
    out = {}
    for key, val in tree.items():
        if isinstance(val, dict):
            out.update(flatten(val, f"{prefix}/{key}"))
        else:
            out[f"{prefix}/{key}"] = np.asarray(val)
    return out


def unflatten(flat: dict, prefix: str) -> dict:
    out: dict = {}
    for key, val in flat.items():
        if not key.startswith(prefix + "/"):
            continue
        node = out
        *path, leaf = key[len(prefix) + 1:].split("/")
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = val
    return out


# ---------------------------------------------------------------------------
# the JAX side (run as a script)
# ---------------------------------------------------------------------------

def jax_reference(path: str) -> None:
    import dataclasses
    import functools

    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, PartitionSpec as P

    from repro.configs.base import get_config
    from repro.core import collectives as cl
    from repro.core import latency_model as lm
    from repro.models import layers as L
    from repro.models.api import build_model
    from repro.models.moe import init_moe, moe_ffn
    from repro.parallel.compat import shard_map
    from repro.parallel.context import ParallelContext

    devices = np.array(jax.devices())
    assert devices.size == GATHER_WORLD
    out = {}

    # (a) the bare gather over 8 devices
    mesh = Mesh(devices, ("x",))

    def run(fn, x):
        return np.asarray(jax.jit(shard_map(
            fn, mesh=mesh, in_specs=P("x"), out_specs=P("x"),
            check_vma=False))(jnp.asarray(x)))

    rng = np.random.default_rng(0)
    for rows, feat in AG_SHAPES:
        x = rng.normal(size=(GATHER_WORLD * rows, feat)).astype(np.float32)
        out[ag_name(rows, feat, "x")] = x
        out[ag_name(rows, feat, "reference")] = run(functools.partial(
            cl.allgather_reference, axis_name="x"), x)
        for mode, split in AG_SPLITS:
            out[ag_name(rows, feat, f"{mode}/{split}")] = run(
                functools.partial(cl.multiwrite_allgather, axis_name="x",
                                  split=split, mode=mode), x)
    x = rng.normal(size=(GATHER_WORLD * 16, 32)).astype(np.float32)
    out[ag_name(16, 32, "planned_x")] = x
    for hw in PLANNED_HW:
        out[ag_name(16, 32, f"planned/{hw}")] = run(functools.partial(
            cl.planned_allgather, axis_name="x",
            hw=getattr(lm, hw) if hw else None), x)
    pctx = ParallelContext(mesh=mesh, pod_axis=None, data_axis="x",
                           model_axis="x", tp_subgroups=2)
    rng = np.random.default_rng(4)
    for rows, feat in STP_SHAPES:
        x = rng.normal(size=(GATHER_WORLD * rows, feat)).astype(np.float32)
        out[f"stp/{rows}x{feat}/x"] = x
        for policy in POLICIES:
            p = dataclasses.replace(pctx, plan_policy=policy)
            out[f"stp/{rows}x{feat}/{policy}"] = run(functools.partial(
                L.split_tp_allgather, pctx=p), x)

    # (b) the reduced Mistral-NeMo on a (1, 4) mesh, fp32
    cfg = mistral_config(get_config)
    mesh = Mesh(devices[:4].reshape(1, 4), ("data", "model"))
    pctx = ParallelContext(mesh=mesh, pod_axis=None, data_axis="data",
                           model_axis="model", fsdp=False, remat="none",
                           seq_parallel=True)
    model = build_model(cfg, pctx, dtype=jnp.float32)
    params = model.init(jax.random.key(0))
    out.update(flatten(jax.tree_util.tree_map(np.asarray, params),
                       "mistral/params"))
    prompts = np.random.default_rng(11).integers(
        0, cfg.vocab, (TP_PROMPTS, TP_LEN)).astype(np.int32)
    out["mistral/prompts"] = prompts
    with mesh:
        cache = model.init_cache(TP_PROMPTS, TP_LEN + TP_NEW, jnp.float32)
        logits, cache = jax.jit(model.prefill)(
            params, {"tokens": jnp.asarray(prompts)}, cache)
        steps, tokens = [np.asarray(logits)], []
        decode = jax.jit(model.decode)
        for _ in range(TP_NEW - 1):
            tok = jnp.argmax(logits, axis=-1).astype(jnp.int32)
            tokens.append(np.asarray(tok))
            logits, cache = decode(params, {"tokens": tok[:, None]}, cache)
            steps.append(np.asarray(logits))
        tokens.append(np.asarray(jnp.argmax(logits, axis=-1)))
    out["mistral/logits"] = np.stack(steps)            # [steps, B, V]
    out["mistral/tokens"] = np.stack(tokens, axis=1)   # [B, TP_NEW]

    # (c) the reduced DBRX MoE layer on a (1, 2, 2) mesh
    cfg = get_config("dbrx_132b").reduced()
    mesh = Mesh(devices[:4].reshape(MOE_MESH), ("pod", "data", "model"))
    params = init_moe(jax.random.key(0), cfg.d_model, cfg.expert_d_ff,
                      cfg.num_experts)
    x = np.random.default_rng(5).normal(
        size=(4, 8, cfg.d_model)).astype(np.float32)
    out.update(flatten({k: np.asarray(v) for k, v in params.items()},
                       "moe/params"))
    out["moe/x"] = x
    for deferred in DEFERRED:
        pctx = ParallelContext(mesh=mesh, pod_axis=None, data_axis="data",
                               model_axis="model", plan_policy="fixed",
                               moe_deferred_tp_reduce=deferred)
        with mesh:
            y, aux = jax.jit(
                lambda xx, p=pctx, w=params: moe_ffn(w, xx, cfg, p)
            )(jnp.asarray(x))
        out[f"moe/{deferred}/y"] = np.asarray(y)
        out[f"moe/{deferred}/aux"] = np.asarray(aux)
    np.savez(path, **out)


if __name__ == "__main__":
    jax_reference(sys.argv[1])
    raise SystemExit(0)


# ---------------------------------------------------------------------------
# the torch side
# ---------------------------------------------------------------------------

import torch  # noqa: E402

from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.launch import ranks  # noqa: E402


def _spec(tmp: Path, world: int, mesh: tuple, **kw) -> dict:
    pods, ep, tp = mesh
    return dict(world=world, pods=pods, ep=ep, tp=tp, backend="gloo",
                device="cpu", init_method=f"file://{tmp / 'store'}",
                timeout_s=60, out_dir=str(tmp / "out"), threads=1, **kw)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    path = tmp_path_factory.mktemp("jax") / "reference.npz"
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS=("--xla_force_host_platform_device_count="
                          f"{GATHER_WORLD}"),
               PYTHONPATH=os.pathsep.join(
                   [str(ROOT / "src"), os.environ.get("PYTHONPATH", "")]))
    res = subprocess.run([sys.executable, __file__, str(path)], env=env,
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=240)
    assert res.returncode == 0, res.stderr[-4000:]
    return dict(np.load(path))


def gather_cases() -> list:
    cases = []
    for rows, feat in AG_SHAPES:
        x = ag_name(rows, feat, "x")
        cases.append(dict(name=ag_name(rows, feat, "reference"), x=x,
                          op="reference"))
        cases += [dict(name=ag_name(rows, feat, f"{mode}/{split}"), x=x,
                       op="multiwrite", mode=mode, split=split)
                  for mode, split in AG_SPLITS]
    cases += [dict(name=ag_name(16, 32, f"planned/{hw}"),
                   x=ag_name(16, 32, "planned_x"), op="planned", hw=hw)
              for hw in PLANNED_HW]
    cases += [dict(name=f"stp/{rows}x{feat}/{policy}",
                   x=f"stp/{rows}x{feat}/x", op="split_tp", policy=policy)
              for rows, feat in STP_SHAPES for policy in POLICIES]
    return cases


@pytest.fixture(scope="module")
def gathered(reference, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("gather")
    np.savez(tmp / "inputs.npz", **{k: v for k, v in reference.items()
                                   if k.endswith("x")})
    spec = _spec(tmp, GATHER_WORLD, (1, 1, GATHER_WORLD),
                 inputs=str(tmp / "inputs.npz"), cases=gather_cases())
    return ranks.run_ranks(ranks.gather_worker, spec,
                           timeout_s=SPAWN_TIMEOUT_S)


def _per_rank(val: np.ndarray, rank: int) -> np.ndarray:
    """Rank ``rank``'s block of a ``shard_map`` output stacked over the 8
    ranks ([8 * domain, rows, ...])."""
    per = val.shape[0] // GATHER_WORLD
    return val[rank * per:(rank + 1) * per]


@pytest.mark.parametrize("rows,feat", AG_SHAPES)
@pytest.mark.parametrize("what", ["reference"] + [
    f"{mode}/{split}" for mode, split in AG_SPLITS])
def test_allgather_bit_exact_per_rank(reference, gathered, rows, feat,
                                      what):
    name = ag_name(rows, feat, what)
    for rank, got in enumerate(gathered):
        assert got[name].shape == (4, rows, feat)
        np.testing.assert_array_equal(got[name],
                                      _per_rank(reference[name], rank),
                                      err_msg=f"rank {rank}")
        np.testing.assert_array_equal(
            got[name], got[ag_name(rows, feat, "reference")])


@pytest.mark.parametrize("hw", PLANNED_HW)
def test_planned_allgather_picks_the_reference_plan(reference, gathered,
                                                    hw):
    """The planner picks the reference's plan for the fragment (the
    baseline at the datasheet hardware, MultiWrite at the ideal one), and
    the gather is bit-exact."""
    from repro.core import latency_model as jlm
    from repro.core.planner import Planner as JPlanner
    from repro.core.topology import split_tp_full_mesh as jmesh

    from repro_torch.core import latency_model as tlm
    from repro_torch.core.planner import Planner as TPlanner
    from repro_torch.core.topology import split_tp_full_mesh as tmesh
    frag = 16 * 32 * 4
    picks = [planner().choose("allgather", frag, mesh(8, tp=4)[0],
                              getattr(lm, hw) if hw else None,
                              executable_only=True).plan
             for planner, mesh, lm in ((JPlanner, jmesh, jlm),
                                       (TPlanner, tmesh, tlm))]
    assert picks[0] == picks[1]
    assert picks[1].startswith("multiwrite") == (hw is not None)
    name = ag_name(16, 32, f"planned/{hw}")
    for rank, got in enumerate(gathered):
        np.testing.assert_array_equal(got[name],
                                      _per_rank(reference[name], rank))


@pytest.mark.parametrize("rows,feat", STP_SHAPES)
@pytest.mark.parametrize("policy", POLICIES)
def test_split_tp_allgather_bit_exact(reference, gathered, rows, feat,
                                      policy):
    name = f"stp/{rows}x{feat}/{policy}"
    for rank, got in enumerate(gathered):
        np.testing.assert_array_equal(got[name],
                                      _per_rank(reference[name], rank))


@pytest.fixture(scope="module")
def mistral(reference, tmp_path_factory):
    """The reduced Mistral-NeMo (fp32, the reference's parameters) served
    over 1 x 1 x 4 ranks under each (tp_subgroups, seq_shard_decode)."""
    tmp = tmp_path_factory.mktemp("mistral")
    runs = [dict(label=f"nd{nd}/{ssd}", tp_subgroups=nd,
                 seq_shard_decode=ssd) for nd, ssd in TP_RUNS]
    spec = _spec(tmp, 4, (1, 1, 4), cfg=mistral_config(get_config),
                 dtype=torch.float32, cache_dtype=torch.float32, seed=0,
                 weights=unflatten(reference, "mistral/params"),
                 prompts=reference["mistral/prompts"], max_new=TP_NEW,
                 runs=runs, keep_logits=True)
    return ranks.run_ranks(ranks.serve_worker, spec,
                           timeout_s=SPAWN_TIMEOUT_S)


@pytest.mark.parametrize("nd,ssd", TP_RUNS)
def test_mistral_over_tp_ranks_matches_reference(reference, mistral, nd,
                                                 ssd):
    """Prefill and 4 greedy decode steps within 1e-4 of the reference's
    forward on a (1, 4) mesh, on every rank; the tokens equal; the decode
    cache in the layout asked for."""
    want = reference["mistral/logits"]
    for r in mistral:
        run = r["runs"][f"nd{nd}/{ssd}"]
        got = np.stack([lg.numpy() for lg in run["step_logits"]])
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, **LOGIT_TOL,
                                   err_msg=f"rank {r['rank']}")
        np.testing.assert_array_equal(run["tokens"],
                                      reference["mistral/tokens"])
        assert run["nonfinite_logits"] == 0


@pytest.mark.parametrize("ssd", [True, False])
def test_mistral_bit_identical_across_tp_subgroups(mistral, ssd):
    """The split-TP gather only moves data: every step's logits of
    ``tp_subgroups`` 2 and 4 are the bits of ``tp_subgroups`` 1."""
    for r in mistral:
        base = r["runs"][f"nd1/{ssd}"]["step_logits"]
        for nd in (2, 4):
            got = r["runs"][f"nd{nd}/{ssd}"]["step_logits"]
            assert all(torch.equal(a, b) for a, b in zip(got, base))


@pytest.fixture(scope="module")
def dbrx_tp(reference, tmp_path_factory):
    """The reduced DBRX over 1 x 2 x 2 ranks: its MoE layer on the
    reference's weights (``moe_ffn``, deferred reduction off and on), and
    the model served on seeded weights; plus the one-rank engine's tokens
    on the same weights."""
    from repro_torch.launch.serve import build_engine
    cfg = get_config("dbrx_132b").reduced()
    prompts = np.random.default_rng(2).integers(
        0, cfg.vocab, size=(MOE_PROMPTS, MOE_LEN)).astype(np.int32)
    one = build_engine(cfg, device="cpu", dtype=torch.float32, seed=3,
                       max_new=MOE_NEW, cache_dtype=torch.float32)
    expected = one.generate(prompts)
    tmp = tmp_path_factory.mktemp("dbrx")
    runs = [dict(label=f"deferred={d}", deferred=d) for d in DEFERRED]
    moe = [dict(name="moe", cfg=cfg, x=reference["moe/x"],
                weights=unflatten(reference, "moe/params"), runs=runs)]
    layer = ranks.run_ranks(ranks.dispatch_worker, _spec(
        tmp / "layer", 4, MOE_MESH, cases=[], moe=moe),
        timeout_s=SPAWN_TIMEOUT_S)
    served = ranks.run_ranks(ranks.serve_worker, _spec(
        tmp / "serve", 4, MOE_MESH, cfg=cfg, dtype=torch.float32,
        cache_dtype=torch.float32, seed=3, prompts=prompts,
        max_new=MOE_NEW, runs=runs), timeout_s=SPAWN_TIMEOUT_S)
    return expected, layer, served


@pytest.mark.parametrize("deferred", DEFERRED)
def test_moe_ffn_with_tp_matches_reference(reference, dbrx_tp, deferred):
    """Each dp rank's rows (the same on both model ranks of a dp group)
    within 1e-5 of the reference's ``shard_map``; the aux too."""
    _, layer, _ = dbrx_tp
    want = reference[f"moe/{deferred}/y"]
    per = want.shape[0] // 2
    for r, got in enumerate(layer):
        run = got["moe_ffn"]["moe"][f"deferred={deferred}"]
        dp = r // 2                      # rank = data * 2 + model
        np.testing.assert_allclose(run["y"], want[dp * per:(dp + 1) * per],
                                   **TOL, err_msg=f"rank {r}")
        np.testing.assert_allclose(run["aux"],
                                   float(reference[f"moe/{deferred}/aux"]),
                                   **TOL)


@pytest.mark.parametrize("deferred", DEFERRED)
def test_dbrx_served_over_tp_equals_one_rank(dbrx_tp, deferred):
    expected, _, served = dbrx_tp
    for r in served:
        run = r["runs"][f"deferred={deferred}"]
        np.testing.assert_array_equal(run["tokens"], expected,
                                      err_msg=f"rank {r['rank']}")
        assert run["nonfinite_logits"] == 0
        assert run["resolved"]["prefill"] == ("hierarchical",
                                              "hierarchical", 1)


# replicated kv heads: Mistral-NeMo's default reduction (4 heads over 2 kv
# heads) over 4 model ranks, one query head a rank; and 12 heads over 4 kv
# heads over 3, where rank 0's heads 0-3 cut kv head 1's group
REPLICATED = {"4-over-2": (dict(), 4, 20),
              "12-over-4": (dict(n_heads=12, n_kv_heads=4, d_model=48,
                                 d_ff=96), 3, 21)}


@pytest.fixture(scope="module", params=list(REPLICATED))
def replicated_kv(request, tmp_path_factory):
    """The model served over ``m`` model ranks with its kv heads
    replicated and the decode KV length sharded, and the one-rank engine
    on the same seed."""
    from repro_torch.launch.serve import build_engine
    kw, m, max_len = REPLICATED[request.param]
    cfg = get_config("mistral_nemo_12b").reduced(**kw)
    prompts = np.random.default_rng(3).integers(
        0, cfg.vocab, size=(2, 8)).astype(np.int32)
    new = max_len - prompts.shape[1]
    one = build_engine(cfg, device="cpu", dtype=torch.float32, seed=4,
                       max_new=new, cache_dtype=torch.float32)
    expected = one.generate(prompts)
    tmp = tmp_path_factory.mktemp("replicated")
    served = ranks.run_ranks(ranks.serve_worker, _spec(
        tmp, m, (1, 1, m), cfg=cfg, dtype=torch.float32,
        cache_dtype=torch.float32, seed=4, prompts=prompts, max_new=new,
        runs=[dict(label="replicated")]), timeout_s=SPAWN_TIMEOUT_S)
    return cfg, m, expected, served


def test_replicated_kv_heads_serve_the_one_rank_tokens(replicated_kv):
    cfg, m, expected, served = replicated_kv
    assert cfg.n_kv_heads % m
    for r in served:
        np.testing.assert_array_equal(r["runs"]["replicated"]["tokens"],
                                      expected, err_msg=f"rank {r['rank']}")


@pytest.mark.parametrize("heads,kv,m,rank,want", [
    (32, 8, 4, 1, (0, 2)),              # kv heads split: this rank's own
    (4, 2, 4, 3, (1, 1)),               # one query head of kv head 1
    (48, 8, 3, 0, [0] * 6 + [1] * 6 + [2] * 4),   # a group cut unevenly
    (48, 8, 3, 1, [2, 2] + [3] * 6 + [4] * 6 + [5, 5])])
def test_local_query_heads_read_their_reference_kv_heads(heads, kv, m, rank,
                                                        want):
    """Query head h reads kv head h // (heads / kv), as the reference's
    GQA does: a rank's heads take whole groups as a slice of its kv heads,
    else one kv head index a query head."""
    from repro_torch.models.layers import Attention, AttnDims
    attn = Attention(AttnDims(64, heads, kv, 16), device="meta",
                     dtype=torch.float32, tp=(m, rank))
    assert attn.kv_of_heads() == want


def test_decode_cache_layout_follows_the_reference_rule():
    """Length-sharded under ``seq_shard_decode`` when the length divides,
    else by kv head when the heads divide; kv heads that do not divide
    with an unsharded length are replicated, all of them on every rank
    (the reference's ``P(dp, None, None, None)``)."""
    import types

    from repro_torch.models.layers import kv_cache_shape, kv_layout
    ctx = types.SimpleNamespace(model_size=4, seq_shard_decode=True)
    assert kv_layout(8, None, 21) == "whole"
    assert kv_layout(8, ctx, 20) == "seq"
    assert kv_layout(8, ctx, 21) == "heads"
    assert kv_cache_shape(8, 16, 2, 20, "seq", 4) == (2, 5, 8, 16)
    assert kv_cache_shape(8, 16, 2, 21, "heads", 4) == (2, 21, 2, 16)
    ctx.seq_shard_decode = False
    assert kv_layout(8, ctx, 20) == "heads"
    assert kv_layout(2, ctx, 20) == "replicated"
    assert kv_cache_shape(2, 16, 2, 20, "replicated", 4) == (2, 20, 2, 16)


# ---------------------------------------------------------------------------
# (d) the plan, in process
# ---------------------------------------------------------------------------

class StandInMesh:
    """The axis sizes of a (pods, data, model) mesh, for both packages'
    contexts (``shape`` as a JAX mesh has it, ``axis_size`` as a RankMesh
    has it)."""

    def __init__(self, pods, data, model):
        self.shape = {"pod": pods, "data": data, "model": model}

    def axis_size(self, *names):
        return math.prod(self.shape[a] for a in names)


def _contexts(**kw):
    from repro.parallel import context as jctx

    from repro_torch.parallel import context as tctx
    mesh = StandInMesh(1, 1, 4)
    return (jctx.ParallelContext(mesh=mesh, tp_subgroups=2, **kw),
            tctx.ParallelContext(mesh, tp_subgroups=2, **kw))


@pytest.mark.parametrize("phase,batch,seq", [
    ("prefill", 4, 512), ("train", 8, 2048), ("decode", 4, 1),
    ("prefill", 3, 512)])
def test_split_tp_gather_site_equals_reference(phase, batch, seq):
    jp, tp = _contexts()
    kw = dict(global_batch=batch, seq_len=seq, d_model=5120)
    want, got = (ctx.split_tp_gather_site(phase, **kw) for ctx in (jp, tp))
    if want is None:
        assert got is None
        return
    assert (got.op, got.role, got.payload_bytes, got.scenario_kw) == (
        want.op, want.role, want.payload_bytes, want.scenario_kw)
    assert got.topo.fingerprint() == want.topo.fingerprint()


@pytest.mark.parametrize("arch", ["mistral_nemo_12b", "dbrx_132b"])
@pytest.mark.parametrize("policy", ["fixed", "auto"])
def test_tp_serve_plan_equals_reference(arch, policy):
    """The serve program of 4 prompts of 512 tokens with a model axis of 4
    in 2 domains: the same sites, fingerprint and split-TP decision, each
    side from a fresh Planner (the port's program priced at the
    reference's TPU peak)."""
    from repro.configs.base import get_config as jget
    from repro.core import planner as jplanner
    from repro.core.topology import TPU_PEAK_FLOPS
    from repro.parallel import context as jctx

    from repro_torch.core import planner as tplanner
    from repro_torch.parallel import context as tctx
    jp, tp = _contexts(plan_policy=policy)
    phases = {"prefill": (4, 512), "decode": (4, 1)}
    jprog = jctx.build_collective_program(jget(arch), jp, "serve", phases)
    tprog = tctx.build_collective_program(get_config(arch), tp, "serve",
                                          phases, peak_flops=TPU_PEAK_FLOPS)
    assert tprog.cache_key() == jprog.cache_key()
    assert "prefill/split_tp_gather" in [s.role for s in tprog.sites]
    plans = []
    for ctx, prog, planner in ((jp, jprog, jplanner), (tp, tprog, tplanner)):
        topo, hw = ctx._plan_topo_hw(16 if arch == "dbrx_132b" else 0)
        plans.append(planner.Planner().plan_program(prog, topo, hw))
    jplan, tplan = plans
    assert tplan.fingerprint == jplan.fingerprint
    jd, td = (p.decision("prefill/split_tp_gather") for p in plans)
    assert (td.plan, dict(td.shard_map_kwargs)) == (
        jd.plan, dict(jd.shard_map_kwargs))
    bound = tp.bind(tplan)
    assert bound.allgather_plan(
        4 * 128 * 5120 * 2).plan == td.plan


def test_split_tp_subgroups_of_the_model_axis():
    from repro_torch.parallel.mesh import split_tp_members
    assert split_tp_members(2) == []
    assert split_tp_members(4) == [(0, 1), (2, 3), (0, 2), (1, 3)]
    got = split_tp_members(8)
    assert got[:6] == [(0, 1, 2, 3), (4, 5, 6, 7), (0, 4), (1, 5), (2, 6),
                       (3, 7)]
    assert got[6:] == [(0, 1), (2, 3), (4, 5), (6, 7), (0, 2, 4, 6),
                       (1, 3, 5, 7)]
