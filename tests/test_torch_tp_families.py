"""The hybrid, rwkv and encoder-decoder families, and a decoder whose kv
heads are replicated over the model axis, served over tensor-parallel
ranks on the CPU.

The reduced Zamba2 (8 SSM heads of 16; its shared block 4 heads over 2
kv heads), RWKV6 (4 heads), SeamlessM4T (MHA, 4 heads) and Qwen2-VL's
backbone (4 q heads over 2 kv heads, M-RoPE, the embeddings input), in
fp32 on the reference's parameters (``convert.params_from_jax``), are
served over 2 or 4 gloo ranks ((1, 1, 2), (1, 1, 4) and (1, 2, 2)), one
spawn a mesh serving all four one after another
(``ranks.serve_worker`` with ``models``), with the decode KV length not
sharded (``seq_shard_decode=False``: Qwen2-VL's 2 kv heads over 4 model
ranks then lie in the "replicated" layout).  Each rank's prefill and
decode logits are held within 1e-4 of max |logit| of the port's one-rank
engine on the same weights, its greedy tokens equal, its decode state in
the shapes of the rank's part; the prefill logits within the families'
one-rank tolerance (1e-4) of the JAX reference's on one device.  In
process: the converter's and the random draw's cut of Mamba2's
``in_proj`` (three column segments) and of every other split parameter
equal the one-rank model's slices.  A ``gpu`` test holds the kernels at
the rank shapes of these models at full width on the card (it skips
here; this file imports JAX only inside its fixtures, so it runs there).
"""

import types

import numpy as np
import pytest
import torch

from repro_torch.configs.base import get_config
from repro_torch.launch import ranks

# family -> (arch, reduced-config overrides)
FAMILIES = {"zamba2": ("zamba2_7b", {}),
            "rwkv6": ("rwkv6_7b", {}),
            "seamless": ("seamless_m4t_medium", {"n_kv_heads": 4}),
            "qwen2_vl": ("qwen2_vl_2b", {})}
MESHES = ((1, 1, 2), (1, 1, 4), (1, 2, 2))
PROMPTS, LEN, NEW = 4, 12, 4
REL = 1e-4                                # of max |logit|, ranks vs one
REF_TOL = dict(atol=1e-4, rtol=1e-4)      # the one-rank tests' bound
SPAWN_TIMEOUT_S = 300


def config(family: str, get=get_config):
    arch, kw = FAMILIES[family]
    return get(arch).reduced(**kw)


def mesh_id(mesh) -> str:
    return "x".join(map(str, mesh))


@pytest.fixture(scope="module")
def reference():
    """Per family: the reference's parameters (numpy) and prefill logits
    on one device, the prompts, and the port's one-rank engine's tokens,
    logits at every step and decode state on those parameters."""
    import jax
    import jax.numpy as jnp

    from repro.configs.base import get_config as jax_get_config
    from repro.data import pipeline as jpipeline
    from repro.models.api import build_model as jax_build_model

    from repro_torch.convert import params_from_jax
    from repro_torch.models.api import build_model
    from repro_torch.runtime.server import ServeConfig
    out = {}
    for i, family in enumerate(FAMILIES):
        cfg, jcfg = config(family), config(family, jax_get_config)
        jmodel = jax_build_model(jcfg, dtype=jnp.float32)
        jparams = jmodel.init(jax.random.key(10 + i))
        weights = jax.tree_util.tree_map(np.asarray, jparams)
        prompts = np.random.default_rng(20 + i).integers(
            0, cfg.vocab, size=(PROMPTS, LEN)).astype(np.int32)
        jbatch = jpipeline.batch_for_model(jcfg, {"tokens": prompts,
                                                  "labels": prompts})
        jbatch.pop("labels")
        logits, _ = jax.jit(jmodel.prefill)(
            jparams, jbatch, jmodel.init_cache(PROMPTS, LEN + NEW,
                                               jnp.float32))
        one = ranks.RecordingEngine(
            build_model(cfg, device="cpu", dtype=torch.float32),
            params_from_jax(weights, cfg, device="cpu", dtype=torch.float32),
            ServeConfig(max_new_tokens=NEW, cache_dtype=torch.float32),
            device="cpu")
        tokens = one.generate(prompts)
        out[family] = dict(weights=weights, prompts=prompts,
                           jax_prefill=np.asarray(logits), tokens=tokens,
                           logits=[lg.numpy() for lg in one.step_logits],
                           state=one.state)
    return out


@pytest.fixture(scope="module")
def served(reference, tmp_path_factory):
    """mesh -> each rank's results, every family served on one spawn."""
    out = {}
    for mesh in MESHES:
        tmp = tmp_path_factory.mktemp(f"mesh{mesh_id(mesh)}")
        pods, ep, tp = mesh
        models = [dict(name=family, cfg=config(family),
                       weights=reference[family]["weights"],
                       prompts=reference[family]["prompts"],
                       runs=[dict(label="served", seq_shard_decode=False)])
                  for family in FAMILIES]
        spec = dict(world=pods * ep * tp, pods=pods, ep=ep, tp=tp,
                    backend="gloo", device="cpu",
                    init_method=f"file://{tmp / 'store'}", timeout_s=60,
                    out_dir=str(tmp / "out"), threads=1, seed=0,
                    dtype=torch.float32, cache_dtype=torch.float32,
                    max_new=NEW, keep_logits=True, models=models)
        out[mesh] = ranks.run_ranks(ranks.serve_worker, spec,
                                    timeout_s=SPAWN_TIMEOUT_S)
    return out


def _runs(served, mesh, family):
    return [(r["rank"], r["models"][family]["runs"]["served"])
            for r in served[mesh]]


def _rows(mesh, rank) -> slice:
    """The global rows a rank serves: its data-parallel block."""
    dp = mesh[0] * mesh[1]
    per = PROMPTS // dp
    at = rank // mesh[2]
    return slice(at * per, (at + 1) * per)


CASES = [pytest.param(f, m, id=f"{f}-{mesh_id(m)}")
         for f in FAMILIES for m in MESHES]


@pytest.mark.parametrize("family,mesh", CASES)
def test_logits_within_one_rank(reference, served, family, mesh):
    """Prefill and every decode step's logits of each rank's rows within
    1e-4 of max |logit| of the one-rank engine's."""
    want = reference[family]["logits"]
    for rank, run in _runs(served, mesh, family):
        got = run["step_logits"]
        assert len(got) == len(want) == NEW
        for step, (g, w) in enumerate(zip(got, want)):
            w = w[_rows(mesh, rank)]
            rel = np.abs(g.numpy() - w).max() / np.abs(w).max()
            assert rel < REL, (rank, step, rel)
        assert run["nonfinite_logits"] == 0


@pytest.mark.parametrize("family,mesh", CASES)
def test_greedy_tokens_equal_one_rank(reference, served, family, mesh):
    for rank, run in _runs(served, mesh, family):
        np.testing.assert_array_equal(run["tokens"],
                                      reference[family]["tokens"],
                                      err_msg=f"rank {rank}")


# the dim of each decode-state entry cut over the data axes, and the dim
# cut over the model axis (None: whole on every model rank)
STATE_DIMS = {"conv": (1, 3), "ssd": (1, 2), "wkv": (1, 2),
              "tshift": (1, None), "cshift": (1, None),
              "k": (1, 3), "v": (1, 3), "enc_out": (0, None),
              "valid": (0, None), "pos": (None, None)}


@pytest.mark.parametrize("family,mesh", CASES)
def test_rank_state_is_its_part(reference, served, family, mesh):
    """Each rank's decode state: its rows of every entry, 1/m of the
    split ones (conv channels, SSD and WKV heads, kv heads where they
    divide; Qwen2-VL's 2 kv heads over 4 model ranks are replicated, all
    of them on every rank), the rest whole; and its bytes below one
    rank's accordingly."""
    one = reference[family]["state"]["shapes"]
    dp, m = mesh[0] * mesh[1], mesh[2]
    cfg = config(family)
    for rank, run in _runs(served, mesh, family):
        shapes = run["state"]["shapes"]
        assert set(shapes) == set(one)
        for name, shape in one.items():
            want = list(shape)
            data_dim, model_dim = STATE_DIMS[name]
            if data_dim is not None:
                want[data_dim] //= dp
            replicated = name in ("k", "v") and cfg.n_kv_heads % m
            if model_dim is not None and not replicated:
                want[model_dim] //= m
            assert shapes[name] == tuple(want), (rank, name, shapes[name])
        one_bytes = reference[family]["state"]["bytes"]
        if shapes == one:                 # every entry whole: replicated
            assert run["state"]["bytes"] == one_bytes
        else:
            assert run["state"]["bytes"] < one_bytes


@pytest.mark.parametrize("family,mesh", CASES)
def test_prefill_matches_jax_reference(reference, served, family, mesh):
    """The ranks' prefill logits (and the one rank's) within 1e-4 of the
    reference's on one device, as the families' one-rank tests hold."""
    want = reference[family]["jax_prefill"]
    np.testing.assert_allclose(reference[family]["logits"][0], want,
                               **REF_TOL)
    for rank, run in _runs(served, mesh, family):
        np.testing.assert_allclose(run["step_logits"][0].numpy(),
                                   want[_rows(mesh, rank)], **REF_TOL,
                                   err_msg=f"rank {rank}")


def _stand_in(m: int, r: int):
    """The model-axis part of a context: ``m`` ranks, this one ``r``."""
    return types.SimpleNamespace(
        model_size=m, model_axis="model", seq_shard_decode=False,
        mesh=types.SimpleNamespace(axis_index=lambda *axes: r))


@pytest.mark.parametrize("rank", range(4))
def test_in_proj_segment_cut_equals_one_rank_slices(reference, rank):
    """``params_from_jax``'s cut of Mamba2's ``in_proj`` over 4 model
    ranks is the rank's z, x and dt columns with B and C whole, in that
    order, sliced from the whole array; every other split parameter is
    its block."""
    from repro_torch.convert import block_of, params_from_jax
    from repro_torch.models.ssm import in_proj_segments
    cfg = config("zamba2")
    weights = reference["zamba2"]["weights"]
    p = params_from_jax(weights, cfg, device="cpu", dtype=torch.float32,
                        pctx=_stand_in(4, rank))
    d_inner, ds = 2 * cfg.d_model, cfg.ssm_state
    heads = d_inner // cfg.ssm_head_dim
    di, hl = d_inner // 4, heads // 4
    for i, blk in enumerate(p.mamba):
        whole = np.asarray(weights["mamba"]["in_proj"][i])
        cols = np.concatenate([
            whole[:, rank * di:(rank + 1) * di],
            whole[:, d_inner + rank * di:d_inner + (rank + 1) * di],
            whole[:, 2 * d_inner:2 * d_inner + 2 * ds],
            whole[:, 2 * d_inner + 2 * ds + rank * hl:
                  2 * d_inner + 2 * ds + (rank + 1) * hl]], axis=1)
        np.testing.assert_array_equal(blk.in_proj.numpy(), cols)
        np.testing.assert_array_equal(
            block_of(whole, blk.shards["in_proj"]), cols)
        assert blk.shards["in_proj"][2] == in_proj_segments(cfg, 4, rank)
        np.testing.assert_array_equal(
            blk.out_proj.numpy(),
            np.asarray(weights["mamba"]["out_proj"][i])[rank * di:
                                                        (rank + 1) * di])
        np.testing.assert_array_equal(
            blk.dt_bias.numpy(),
            np.asarray(weights["mamba"]["dt_bias"][i])[rank * hl:
                                                       (rank + 1) * hl])


@pytest.mark.parametrize("family", ["zamba2", "rwkv6", "seamless"])
@pytest.mark.parametrize("rank", [0, 3])
def test_random_draws_keep_the_rank_part(family, rank):
    """A rank's seeded draw equals the one-rank draw's cut of every split
    parameter (each tensor drawn whole, the generator advancing as on one
    rank), and its whole parameters equal the one rank's."""
    from repro_torch.convert import block_of
    from repro_torch.models.api import build_model
    cfg = config(family)
    whole = build_model(cfg, device="cpu", dtype=torch.float32).init(
        torch.Generator().manual_seed(5))
    mine = build_model(cfg, device="cpu", dtype=torch.float32,
                       pctx=_stand_in(4, rank)).init(
        torch.Generator().manual_seed(5))
    shards = {f"{prefix}.{name}".lstrip("."): shard
              for prefix, sub in mine.named_modules()
              for name, shard in getattr(sub, "shards", {}).items()}
    ref = dict(whole.named_parameters())
    for name, t in mine.named_parameters():
        want = ref[name].numpy()
        if name in shards:
            want = block_of(want, shards[name])
        np.testing.assert_array_equal(t.numpy(), want, err_msg=name)
    assert shards


# the kernels at a rank's shapes over 4 model ranks at full width, 4
# prompts x 512 tokens (chip_smoke's phase 14): q heads, kv heads, head
# dim and the mask of attention; the scans' rows
RANK_ATTENTION = (("seamless-enc", 4, 4, 64, False),
                  ("seamless-dec", 4, 4, 64, True),
                  ("zamba2-shared", 8, 8, 112, True),
                  ("qwen2_vl", 3, 1, 128, True))


@pytest.mark.gpu
@pytest.mark.parametrize("label,hq,g,d,causal", RANK_ATTENTION)
def test_attention_kernel_at_rank_shapes_on_card(label, hq, g, d, causal):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_attention import flash_attention_plain
    gen = torch.Generator(device="cuda").manual_seed(11)
    q = torch.randn((4, 512, hq, d), generator=gen, device="cuda")
    k = torch.randn((4, 512, g, d), generator=gen, device="cuda")
    v = torch.randn((4, 512, g, d), generator=gen, device="cuda")
    q, k, v = (x.to(torch.bfloat16).transpose(1, 2) for x in (q, k, v))
    got = ops.flash_attention(q, k, v, causal=causal).float()
    exp = flash_attention_plain(q.float(), k.float(), v.float(),
                                causal=causal)
    torch.testing.assert_close(got, exp, atol=2e-2, rtol=2e-2)


@pytest.mark.gpu
@pytest.mark.parametrize("scan", ["mamba2", "rwkv6"])
def test_scan_kernels_at_rank_rows_on_card(scan):
    """Zamba2's rank: 4 x 28 heads of 64 over one group of B, C a
    sequence; RWKV6's: 4 x 16 heads of 64; 512 steps, against the fp32
    per-step recurrence."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    from repro_torch.kernels import ops
    from repro_torch.kernels import ref as tref
    from repro_torch.kernels.mamba2_scan import expand_groups
    gen = torch.Generator(device="cuda").manual_seed(12)

    def rn(*shape):
        return torch.randn(shape, generator=gen, device="cuda")
    s = 512
    if scan == "mamba2":
        rows = 4 * 28
        x = rn(rows, s, 64).to(torch.bfloat16)
        dt = torch.nn.functional.softplus(rn(rows, s) - 1.0)
        a = -torch.exp(rn(rows) * 0.5)
        d = rn(rows)
        b, c = (rn(4, s, 64).to(torch.bfloat16) for _ in range(2))
        y, h = ops.mamba2_scan(x, dt, a, b, c, d)
        ey, eh = tref.mamba2_ref(x.float(), dt, a,
                                 expand_groups(b, rows).float(),
                                 expand_groups(c, rows).float(), d,
                                 return_final=True)
    else:
        rows = 4 * 16
        r, k, v = (rn(rows, s, 64).to(torch.bfloat16) for _ in range(3))
        logw = -torch.exp(rn(rows, s, 64) * 0.5 - 1.0)
        u = rn(rows, 64) * 0.3
        y, h = ops.rwkv6_scan(r, k, v, logw, u)
        ey, eh = tref.rwkv6_ref(r.float(), k.float(), v.float(), logw, u,
                                return_final=True)
    torch.testing.assert_close(y.float(), ey, atol=5e-2, rtol=5e-2)
    torch.testing.assert_close(h, eh, atol=5e-2, rtol=5e-2)


@pytest.mark.parametrize("family", ["zamba2", "rwkv6"])
def test_scans_get_contiguous_rows_at_one_sequence(family, monkeypatch):
    """A prefill of one sequence hands the scan contiguous rows (the CUDA
    kernels refuse strided ones; a reshape of one sequence's transpose is
    a strided view), here by a wrapper that checks before the plain
    version runs."""
    from repro_torch.kernels import ops
    from repro_torch.models.api import build_model
    name = "mamba2_scan" if family == "zamba2" else "rwkv6_scan"
    scan = getattr(ops, name)
    seen = []

    def checked(*args):
        seen.append(all(t.is_contiguous() for t in args))
        return scan(*args)
    monkeypatch.setattr(ops, name, checked)
    cfg = config(family)
    model = build_model(cfg, device="cpu", dtype=torch.float32)
    params = model.init(torch.Generator().manual_seed(0))
    tokens = torch.arange(12, dtype=torch.int32)[None]
    with torch.inference_mode():
        model.prefill(params, {"tokens": tokens}, model.init_cache(1, 16))
    assert seen and all(seen)


def test_zamba2_deep_stack_rounds_past_the_card_gate(tmp_path):
    """Why the card's phase 14 holds Zamba2 at 24 blocks to its own
    rounding yardstick: the reference's random-weight Zamba2 at 24 blocks
    (width 256) moves its prefill logits by more than the card's gate
    (5e-2 of max |logit|) between bf16 and fp32 alone, while in fp32 the
    port on one rank and over 4 model ranks agree with it within 1e-4."""
    import dataclasses

    import jax
    import jax.numpy as jnp

    from repro.configs.base import get_config as jax_get_config
    from repro.models.api import build_model as jax_build_model

    from repro_torch.convert import params_from_jax
    from repro_torch.models.api import build_model
    shape = dict(n_layers=24, d_model=256, d_ff=1024, vocab=2048,
                 n_heads=4, n_kv_heads=4, d_head=None)
    jcfg = dataclasses.replace(jax_get_config("zamba2_7b"), **shape)
    cfg = dataclasses.replace(get_config("zamba2_7b"), **shape)
    toks = np.random.default_rng(3).integers(
        0, cfg.vocab, size=(2, 32)).astype(np.int32)
    logits = {}
    for name, dt in (("fp32", jnp.float32), ("bf16", jnp.bfloat16)):
        jmodel = jax_build_model(jcfg, dtype=dt)
        jparams = jmodel.init(jax.random.key(0))
        lg, _ = jax.jit(jmodel.prefill)(
            jparams, {"tokens": jnp.asarray(toks)},
            jmodel.init_cache(2, 36, dt))
        logits[name] = np.asarray(lg.astype(jnp.float32))
        if name == "fp32":
            weights = jax.tree_util.tree_map(np.asarray, jparams)

    def rel(a, b):
        return np.abs(a - b).max() / np.abs(b).max()
    assert rel(logits["bf16"], logits["fp32"]) > 5e-2
    params = params_from_jax(weights, cfg, device="cpu", dtype=torch.float32)
    model = build_model(cfg, device="cpu", dtype=torch.float32)
    with torch.inference_mode():
        one, _ = model.prefill(params, {"tokens": torch.from_numpy(toks)},
                               model.init_cache(2, 36, torch.float32))
    assert rel(one.numpy(), logits["fp32"]) < 1e-4
    spec = dict(world=4, pods=1, ep=1, tp=4, backend="gloo", device="cpu",
                init_method=f"file://{tmp_path / 'store'}", timeout_s=60,
                out_dir=str(tmp_path / "out"), threads=1, cfg=cfg, seed=0,
                dtype=torch.float32, cache_dtype=torch.float32,
                weights=weights, prompts=toks, max_new=2,
                runs=[dict(label="tp4")])
    for r in ranks.run_ranks(ranks.serve_worker, spec,
                             timeout_s=SPAWN_TIMEOUT_S):
        got = r["runs"]["tp4"]["prefill_logits"].numpy()
        assert rel(got, one.numpy()) < 1e-4, r["rank"]
