"""Training the hybrid (Zamba2), rwkv (RWKV6) and encoder-decoder
(SeamlessM4T) families over a model axis: 2 gloo ranks, (1, 1, 2), the
reduced configs in fp32, on the CPU.

- From the reference's weights (``convert.params_from_jax``): the step-0
  loss within 1e-5 relative and every gradient, gathered to its global
  shape through ``ShardLayout`` (Mamba2's ``in_proj`` by its column
  segments), within 1e-5 of one rank's (absolute: every gradient's
  largest element is below 1; the reduced Zamba2's first ``out_proj``
  differs by 3.0e-6, 1.3e-5 of its largest, in the two ranks' fp32 sum
  order); the same gradients within 1e-4 of the reference's ``jax.grad``
  on one device;
  3 ``Trainer`` steps' losses within 1e-5 relative of one rank's; every
  replicated leaf bit-identical over the model ranks after them, and one
  gradient norm on both ranks.
- The three faults this slice repairs, each on its own, against one
  rank: ``layers.rmsnorm_over_model``'s gradient (the sum of squares
  summed backward too), Mamba2's B/C columns of ``in_proj`` (their
  gradient summed over the axis, ``ln(x)``'s cotangent counted once) and
  ``GradSync.global_norm`` (the B/C segment, whole on every model rank,
  counted once).
"""

import numpy as np
import pytest
import torch

from repro_torch.configs.base import get_config
from repro_torch.launch import ranks

FAMILIES = ["zamba2_7b", "rwkv6_7b", "seamless_m4t_medium"]
WORLD = 2
BATCH, SEQ, STEPS, LR = 4, 32, 3, 3e-3
SEED = 7
SPAWN_TIMEOUT_S = 180


def _spec(tmp, **kw) -> dict:
    return dict(world=WORLD, pods=1, ep=1, tp=WORLD, backend="gloo",
                device="cpu", init_method=f"file://{tmp / 'store'}",
                timeout_s=60, out_dir=str(tmp / "out"), threads=1,
                dtype=torch.float32, batch=BATCH, seq=SEQ, steps=STEPS,
                lr=LR, **kw)


def _weights(arch: str):
    import jax
    import jax.numpy as jnp

    from repro.configs.base import get_config as jax_get_config
    from repro.models.api import build_model as jax_build_model
    params = jax_build_model(jax_get_config(arch).reduced(), None,
                             dtype=jnp.float32).init(jax.random.key(SEED))
    return jax.tree_util.tree_map(np.asarray, params)


def _jax_grads(arch: str, weights) -> dict:
    """The reference's ``jax.grad`` of its loss on one device, carried to
    the port's parameter names."""
    import jax
    import jax.numpy as jnp

    from repro.configs.base import get_config as jax_get_config
    from repro.data import pipeline as jdata
    from repro.models.api import build_model as jax_build_model
    from repro_torch.convert import params_from_jax
    jcfg = jax_get_config(arch).reduced()
    jmodel = jax_build_model(jcfg, None, dtype=jnp.float32)
    raw = jdata.SyntheticLM(jdata.DataConfig(
        vocab=jcfg.vocab, seq_len=SEQ, global_batch=BATCH, seed=0)).batch(0)
    grads = jax.jit(jax.grad(lambda p, b: jmodel.loss(p, b)[0]))(
        jax.tree_util.tree_map(jnp.asarray, weights),
        jdata.batch_for_model(jcfg, raw))
    tree = params_from_jax(jax.tree_util.tree_map(np.asarray, grads),
                           get_config(arch).reduced(), device="cpu",
                           dtype=torch.float32)
    return {n: p.detach().numpy() for n, p in tree.named_parameters()}


def _one_rank(cfg, weights) -> tuple:
    """(step-0 loss, {name: gradient}, the 3 steps' history) on one rank,
    set up as ``ranks.train_worker`` sets up a run."""
    from repro_torch.data.pipeline import DataConfig, SyntheticLM, \
        batch_for_model
    from repro_torch.launch.train import build_training
    from repro_torch.runtime.trainer import Trainer, TrainerConfig, \
        trainable
    built = build_training(cfg, None, batch=BATCH, seq=SEQ,
                           dtype=torch.float32, device="cpu", lr=LR,
                           steps=STEPS, warmup=1, weights=weights)
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=SEQ,
                                  global_batch=BATCH, seed=0))

    def make_batch(step):
        return batch_for_model(cfg, data.batch(step), device="cpu")
    named = trainable(built.params)
    loss, _ = built.model.loss(built.params, make_batch(0))
    loss.backward()
    grads = {n: p.grad.numpy().copy() for n, p in named.items()}
    for p in named.values():
        p.grad = None
    hist = Trainer(built.model, built.opt, make_batch,
                   TrainerConfig(total_steps=STEPS, log_every=1 << 30),
                   params=built.params, train_step=built.train_step).run()
    return loss.item(), grads, hist


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("train_tp_families")
    weights = {arch: _weights(arch) for arch in FAMILIES}
    runs = [dict(label=arch, cfg=get_config(arch).reduced(),
                 weights=weights[arch], grads=True) for arch in FAMILIES]
    # the card script's checks: seed-0 draws, each backward kernel against
    # its plain version, rank 0 against one rank of the same draws
    runs += [dict(label=f"{arch} checked", cfg=get_config(arch).reduced(),
                  check_kernels=True, one_rank=0, steps=1)
             for arch in ("zamba2_7b", "rwkv6_7b")]
    got = ranks.run_ranks(ranks.train_worker,
                          _spec(tmp, cfg=runs[0]["cfg"], runs=runs),
                          timeout_s=SPAWN_TIMEOUT_S)
    return got, weights


@pytest.fixture(scope="module")
def one_rank(trained):
    _, weights = trained
    return {arch: _one_rank(get_config(arch).reduced(), weights[arch])
            for arch in FAMILIES}


def _close(got: dict, want: dict, tol: float) -> None:
    """Each gradient within ``tol`` of the other's: absolute where its
    largest element is below 1 (as every one here), else relative to it."""
    assert set(got) == set(want)
    for name, g in want.items():
        assert got[name].shape == g.shape, name
        err = float(np.abs(got[name] - g).max())
        big = float(np.abs(g).max())
        assert err <= tol * max(big, 1.0), f"{name}: {err:.3e} of {big:.3e}"


@pytest.mark.parametrize("arch", FAMILIES)
def test_loss_and_gradients_match_one_rank(trained, one_rank, arch):
    got, _ = trained
    loss, grads, _ = one_rank[arch]
    run = got[0]["runs"][arch]
    assert run["step0"]["loss"] == pytest.approx(loss, rel=1e-5)
    _close(run["grads"], grads, 1e-5)


@pytest.mark.parametrize("arch", FAMILIES)
def test_gradients_match_jax_grad(trained, arch):
    got, weights = trained
    _close(got[0]["runs"][arch]["grads"], _jax_grads(arch, weights[arch]),
           1e-4)


@pytest.mark.parametrize("arch", FAMILIES)
def test_trainer_steps_match_one_rank(trained, one_rank, arch):
    got, _ = trained
    hist = one_rank[arch][2]
    for r in got:
        mine = r["runs"][arch]["history"]
        assert [h["step"] for h in mine] == list(range(STEPS))
        for a, b in zip(mine, hist):
            assert a["loss"] == pytest.approx(b["loss"], rel=1e-5), a["step"]


@pytest.mark.parametrize("arch", FAMILIES)
def test_replicated_leaves_identical_over_model_ranks(trained, arch):
    got, _ = trained
    runs = [r["runs"][arch] for r in got]
    assert "final_norm.w" in runs[0]["replicated"]
    # Mamba2's in_proj B/C columns, whole on every model rank
    assert any("in_proj[" in n for n in runs[0]["replicated"]) == (
        arch == "zamba2_7b")
    for name in runs[0]["replicated"]:
        assert runs[1]["digest"][name] == runs[0]["digest"][name], name
    assert [h["grad_norm"] for h in runs[1]["history"]] == \
        [h["grad_norm"] for h in runs[0]["history"]]


@pytest.mark.parametrize("arch,kernels", [
    ("zamba2_7b", {"mamba2_scan_bwd", "flash_attention_bwd"}),
    ("rwkv6_7b", {"rwkv6_scan_bwd"})])
def test_card_checks_of_a_rank_run(trained, arch, kernels):
    """What the card script's phase 14 gates, here in fp32 on the CPU:
    each backward kernel (its plain version here) held against the plain
    backward at the rank's shapes, and rank 0's one-rank step 0 of the
    same draws: the loss, every gathered gradient's cosine, its
    conditioning (one rank against fp32 through the plain versions) and
    the ranks' fp32 gradients' cosine."""
    got, _ = trained
    run = got[0]["runs"][f"{arch} checked"]
    checks = {c[0]: c for c in run["kernel_checks"]}
    assert set(checks) == kernels
    assert all(c[3] and c[4] < 1e-5 for c in checks.values()), checks
    one = run["one_rank"]
    assert run["step0"]["loss"] == pytest.approx(one["loss"], rel=1e-5)
    # every leaf reached (the reduced Zamba2 calls its shared block once):
    # none zero on both sides, so every one is compared
    leaves = {n for n in run["digest"] if "[" not in n}    # no segments
    for key in ("cosines", "conditioning", "cosines_fp32"):
        assert set(one[key]) == leaves, key
        assert None not in one[key].values(), key
    assert min(one["cosines"].values()) > 1 - 1e-6
    # fp32 here: one rank against the same weights through the plain
    # versions in fp32 is the same computation, and the ranks' fp32
    # copies are the ranks' own run
    assert min(one["conditioning"].values()) > 1 - 1e-6
    assert min(one["cosines_fp32"].values()) > 1 - 1e-6
    assert one["fp32_loss"] == pytest.approx(one["loss"], rel=1e-6)
    assert "one_rank" not in got[1]["runs"][f"{arch} checked"]


# ---------------------------------------------------------------------------
# the three faults, each on its own
# ---------------------------------------------------------------------------

def fault_checks(mesh, dev, spec) -> dict:
    """Run on each of the 2 ranks: the rank's gradients of an RMSNorm over
    split channels and of a Mamba2 block, and GradSync's norm of a known
    gradient; rank 0 also the one-rank values."""
    from repro_torch.checkpoint.store import ShardLayout
    from repro_torch.models import layers as L
    from repro_torch.models import ssm
    from repro_torch.parallel.context import ParallelContext
    from repro_torch.runtime.trainer import GradSync, trainable
    pctx = ParallelContext(mesh)
    m, r = WORLD, mesh.axis_index("model")
    out = {}

    # the norm: x and w of this rank's channels
    rng = np.random.default_rng(0)
    width = 16
    x, w, cot = (torch.tensor(a, dtype=torch.float32) for a in (
        rng.normal(size=(2, 3, width)), 0.1 * rng.normal(size=width),
        rng.normal(size=(2, 3, width))))
    cut = slice(r * width // m, (r + 1) * width // m)
    xs, ws = (t[..., cut].clone().requires_grad_(True) for t in (x, w))
    (L.rmsnorm_over_model(ws, xs, width, pctx) * cot[..., cut]).sum() \
        .backward()
    out["norm"] = {"x": xs.grad.numpy(), "w": ws.grad.numpy()}
    if r == 0:
        xw = [t.clone().requires_grad_(True) for t in (x, w)]
        (L.rmsnorm(xw[1], xw[0]) * cot).sum().backward()
        out["norm_one"] = {"x": xw[0].grad.numpy(), "w": xw[1].grad.numpy()}

    # a Mamba2 block: in_proj's gradient and the input's
    cfg = get_config("zamba2_7b").reduced()

    def block(tp):
        gen = torch.Generator().manual_seed(3)
        blk = ssm.Mamba2Block(cfg, device="cpu", dtype=torch.float32,
                              tp=tp).reset_parameters(gen)
        with torch.no_grad():
            blk.ln.w.normal_(0.0, 0.1, generator=gen)
        trainable(blk)
        return blk
    xin = torch.tensor(rng.normal(size=(2, 8, cfg.d_model)),
                       dtype=torch.float32)
    ycot = torch.tensor(rng.normal(size=(2, 8, cfg.d_model)),
                        dtype=torch.float32)

    def grads(blk, ctx):
        xr = xin.clone().requires_grad_(True)
        (ssm.mamba2_block_prefill(blk, xr, cfg, ctx)[0] * ycot).sum() \
            .backward()
        return xr.grad.numpy(), blk
    gx, blk = grads(block((m, r)), pctx)
    layout = ShardLayout(blk, pctx)
    segs = ssm.in_proj_segments(cfg, m, r)
    at = sum(hi - lo for lo, hi in segs[:2])          # past z and x
    out["mamba"] = {"x": gx, "in_proj": layout.gather(
        "params/in_proj", blk.in_proj.grad), "bc": blk.in_proj.grad[
            :, at:at + segs[2][1] - segs[2][0]].numpy()}
    if r == 0:
        gx1, blk1 = grads(block((1, 0)), None)
        out["mamba_one"] = {"x": gx1, "in_proj": blk1.in_proj.grad}

    # GradSync's norm of a known global gradient, cut to the rank
    model = ssm.Zamba2(cfg, device="cpu", dtype=torch.float32, pctx=pctx)
    layout = ShardLayout(model, pctx)
    whole = {}
    g = {}
    for i, (name, p) in enumerate(model.named_parameters()):
        shape = layout.global_shape(f"params/{name}", p.shape)
        whole[name] = torch.tensor(np.random.default_rng(i).normal(
            size=shape), dtype=torch.float32)
        g[name] = layout.cut(f"params/{name}", whole[name], p.shape)
    out["norm_of_grads"] = float(GradSync(pctx, model).global_norm(g))
    out["norm_of_whole"] = float(torch.sqrt(sum(
        (t.double() ** 2).sum() for t in whole.values())))
    return out


@pytest.fixture(scope="module")
def faults(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tp_faults")
    return ranks.run_ranks(ranks.call_worker, _spec(tmp, call=fault_checks),
                           timeout_s=SPAWN_TIMEOUT_S)


def test_rmsnorm_over_model_gradient_sums_every_rank(faults):
    """Each rank scales only its channels by the summed squares, so the
    gradient of its partial sum is every rank's cotangent: the x and w
    gradients of the 2 ranks' channels, side by side, are one rank's."""
    for key in ("x", "w"):
        got = np.concatenate([r["norm"][key] for r in faults], axis=-1)
        np.testing.assert_allclose(got, faults[0]["norm_one"][key],
                                   rtol=1e-5, atol=1e-6)


def test_mamba2_bc_columns_gradient_summed_over_the_axis(faults):
    """B and C are whole on both ranks and read by each rank's heads: the
    in_proj gradient gathered by its segments (B/C from rank 0) and the
    input's gradient are one rank's, and the input's and B/C's columns
    are the same bits on both ranks (the gather takes B/C from one)."""
    for key in ("x", "in_proj"):
        want = faults[0]["mamba_one"][key]
        got = faults[0]["mamba"][key]
        err = float(np.abs(np.asarray(got) - np.asarray(want)).max())
        assert err <= 1e-5 * float(np.abs(np.asarray(want)).max()), key
    assert faults[0]["mamba"]["bc"].shape[1] == 2 * get_config(
        "zamba2_7b").reduced().ssm_state
    for r in faults:
        for key in ("x", "bc"):
            np.testing.assert_array_equal(r["mamba"][key],
                                          faults[0]["mamba"][key],
                                          err_msg=key)


def test_global_norm_counts_whole_segments_once(faults):
    """The norm of a known global gradient, each rank holding its cut:
    in_proj's B/C segment, the same on both model ranks, counts once."""
    for r in faults:
        assert r["norm_of_grads"] == pytest.approx(
            faults[0]["norm_of_whole"], rel=1e-6)


def test_unreached_parameters_train_as_the_reference():
    """Zamba2 cut below its first shared-block call leaves the shared
    block unused: its gradients are zeros, as ``jax.grad`` gives them (the
    step raised on their None before), so the port's 2 ``Trainer`` steps
    equal the reference's: the losses within 1e-5 relative, the unused
    block's weights (weight decay alone) within 1e-6."""
    import dataclasses

    import jax
    import jax.numpy as jnp

    from repro.configs.base import get_config as jax_get_config
    from repro.data import pipeline as jdata
    from repro.models.api import build_model as jax_build_model
    from repro.optim import adamw as jadamw
    from repro.optim import cosine_schedule as jcosine
    from repro.runtime.trainer import Trainer as JTrainer
    from repro.runtime.trainer import TrainerConfig as JTrainerConfig
    from repro_torch.convert import params_from_jax
    from repro_torch.data.pipeline import DataConfig, SyntheticLM, \
        batch_for_model
    from repro_torch.models.api import build_model
    from repro_torch.optim import adamw, cosine_schedule
    from repro_torch.runtime.trainer import Trainer, TrainerConfig
    steps = 2
    jcfg = dataclasses.replace(jax_get_config("zamba2_7b").reduced(),
                               n_layers=1)
    cfg = get_config("zamba2_7b").reduced().with_depth(1)
    jmodel = jax_build_model(jcfg, None, dtype=jnp.float32)
    jdata_ = jdata.SyntheticLM(jdata.DataConfig(
        vocab=cfg.vocab, seq_len=SEQ, global_batch=BATCH, seed=0))
    jtr = JTrainer(jmodel, jadamw(lr=jcosine(LR, warmup=1, total=steps),
                                  weight_decay=0.01),
                   lambda s: jdata.batch_for_model(jcfg, jdata_.batch(s)),
                   JTrainerConfig(total_steps=steps, log_every=1000),
                   init_rng=jax.random.key(SEED))
    start = jax.tree_util.tree_map(np.asarray, jtr.state.params)
    jhist = jtr.run()
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=SEQ,
                                  global_batch=BATCH, seed=0))
    params = params_from_jax(start, cfg, device="cpu", dtype=torch.float32)
    tr = Trainer(build_model(cfg, device="cpu", dtype=torch.float32),
                 adamw(lr=cosine_schedule(LR, warmup=1, total=steps),
                       weight_decay=0.01),
                 lambda s: batch_for_model(cfg, data.batch(s), device="cpu"),
                 TrainerConfig(total_steps=steps, log_every=1000),
                 params=params)
    hist = tr.run()
    for mine, theirs in zip(hist, jhist):
        assert mine["loss"] == pytest.approx(theirs["loss"], rel=1e-5)
    end = params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                 jtr.state.params),
                          cfg, device="cpu", dtype=torch.float32)
    for name, p in params.shared.named_parameters():
        want = dict(end.shared.named_parameters())[name]
        np.testing.assert_allclose(p.detach().numpy(),
                                   want.detach().numpy(), rtol=0,
                                   atol=1e-6, err_msg=name)
