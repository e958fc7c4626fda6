"""Training the reduced DBRX over 2 pods x 2 ep ranks (4 gloo ranks on the
CPU), against one rank and against the JAX package.

- ``moe_ffn``'s gradients over 2 x 2 (capacity factor 4, so nothing is
  dropped; fp32) for a cotangent of the output: the input's rows, the
  router's (summed over the ranks, as the data-parallel sum of the ranks'
  objectives) and each rank's experts' within rtol 1e-4 / atol 1e-6 of
  the one-rank layer's, under the three scheme pairs; the pipeline at
  G = 4 chunks bit-exact forward and within 1e-5 relative backward of
  G = 1;
- the model's step-0 cross-entropy and its gradients (synced by the
  planner's ``grad_sync`` verdict through ``planned_psum``, gathered to
  their global shapes) within 1e-4 of the largest of each gradient, against
  one rank; the aux loss is a per-rank estimate averaged over the dp ranks,
  so the whole loss is held against the reference instead:
- the 5-step ``Trainer`` loss and gradient-norm curve against the
  reference's ``make_train_step`` on a (2, 2, 1) mesh of 4 forced CPU
  devices (``sharding.param_specs`` / ``batch_specs`` on real arrays, as
  ``launch/dryrun.py`` builds them), within 1e-5 relative, from the same
  weights (``convert.params_from_jax``); the ce curve against one rank
  within 3e-3 after step 0 (within 1e-6 there; the aux's gradient differs
  from one rank's, and moves the runs apart by a measured 1.65e-3
  relative at step 4); every replicated leaf
  bit-identical on the 4 ranks after the run, and the grad norm the same
  on every rank;
- with every expert active (so the aux has no gradient and one rank
  follows the ranks' updates), a checkpoint written over 2 x 2 after step
  1, restored onto one rank (steps 1, 2, then saved) and back onto 2 x 2
  (steps 3, 4): every loss within 1e-6 relative of the uninterrupted
  2 x 2 run's.
"""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[1]
WORLD, PODS, EPS = 4, 2, 2
BATCH, SEQ, STEPS, LR, CF = 4, 32, 5, 3e-3, 4.0
SEED = 7
SPAWN_TIMEOUT_S = 180
PAIRS = ("hierarchical+hierarchical", "hierarchical+baseline",
         "baseline+baseline")
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)


def reduced(get_config):
    return dataclasses.replace(get_config("dbrx_132b").reduced(),
                               moe_capacity=CF)


# ---------------------------------------------------------------------------
# the JAX side (run as a script)
# ---------------------------------------------------------------------------

def jax_train(path: str) -> None:
    """The reference's train step on a (2, 2, 1) mesh of 4 CPU devices:
    parameters and AdamW state placed by ``param_specs``, each batch by
    ``batch_specs``, 5 steps."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding

    from repro.configs.base import get_config
    from repro.data import pipeline as jdata
    from repro.launch.mesh import make_test_mesh
    from repro.models.api import build_model
    from repro.optim import adamw, cosine_schedule
    from repro.parallel import sharding as shd
    from repro.parallel.context import ParallelContext
    from repro.runtime.trainer import TrainState, make_train_step

    assert jax.device_count() == WORLD
    cfg = reduced(get_config)
    mesh = make_test_mesh((PODS, EPS, 1))
    pctx = ParallelContext(mesh=mesh, pod_axis="pod", plan_policy="fixed",
                           remat="none")
    model = build_model(cfg, pctx, dtype=jnp.float32)
    params = model.init(jax.random.key(SEED))

    def place(tree, specs):
        return jax.tree_util.tree_map(
            lambda x, sp: jax.device_put(x, NamedSharding(mesh, sp)), tree,
            specs)
    opt = adamw(lr=cosine_schedule(LR, warmup=1, total=STEPS),
                weight_decay=0.01)
    opt_state = opt.init(params)
    state = TrainState(place(params, shd.param_specs(params, cfg, pctx)),
                       place(opt_state, shd.param_specs(opt_state, cfg,
                                                        pctx)),
                       jnp.zeros((), jnp.int32))
    step = make_train_step(model, opt, donate=False)
    data = jdata.SyntheticLM(jdata.DataConfig(vocab=cfg.vocab, seq_len=SEQ,
                                              global_batch=BATCH, seed=0))
    hist = {"loss": [], "grad_norm": [], "ce": []}
    with mesh:
        for s in range(STEPS):
            b = jdata.batch_for_model(cfg, data.batch(s))
            state, m = step(state, place(b, shd.batch_specs(b, pctx)))
            for key in hist:
                hist[key].append(float(m[key]))
    np.savez(path, **{k: np.array(v) for k, v in hist.items()})


if __name__ == "__main__":
    jax_train(sys.argv[1])
    raise SystemExit(0)


# ---------------------------------------------------------------------------
# the torch side
# ---------------------------------------------------------------------------

import torch  # noqa: E402

from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.launch import ranks  # noqa: E402


def _spec(tmp: Path, **kw) -> dict:
    return dict(world=WORLD, pods=PODS, ep=EPS, backend="gloo",
                device="cpu", init_method=f"file://{tmp / 'store'}",
                timeout_s=60, out_dir=str(tmp / "out"), threads=1,
                dp_servers=(2,), **kw)


@pytest.fixture(scope="module")
def ref_run(tmp_path_factory):
    """The reference's run, started in a subprocess at once (it compiles
    while the ranks run), and its initial parameters, drawn here."""
    import jax
    import jax.numpy as jnp

    from repro.configs.base import get_config as jax_get_config
    from repro.models.api import build_model as jax_build_model
    path = tmp_path_factory.mktemp("jax") / "train.npz"
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS=f"--xla_force_host_platform_device_count={WORLD}",
               PYTHONPATH=os.pathsep.join(
                   [str(ROOT / "src"), os.environ.get("PYTHONPATH", "")]))
    proc = subprocess.Popen([sys.executable, __file__, str(path)], env=env,
                            cwd=ROOT, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    jcfg = reduced(jax_get_config)
    params = jax_build_model(jcfg, None, dtype=jnp.float32).init(
        jax.random.key(SEED))
    weights = jax.tree_util.tree_map(np.asarray, params)
    yield weights, proc, path
    if proc.poll() is None:
        proc.kill()


def _reference_curve(ref_run) -> dict:
    _, proc, path = ref_run
    _, err = proc.communicate(timeout=300)
    assert proc.returncode == 0, err[-4000:]
    return dict(np.load(path))


def _one_rank(cfg, weights):
    from repro_torch.convert import params_from_jax
    from repro_torch.models.api import build_model
    model = build_model(cfg, device="cpu", dtype=torch.float32)
    params = params_from_jax(weights, cfg, device="cpu",
                             dtype=torch.float32)
    return model, params


def _trainer(cfg, weights, steps: int, ckpt_dir=None):
    from repro_torch.data.pipeline import DataConfig, SyntheticLM, \
        batch_for_model
    from repro_torch.optim import adamw, cosine_schedule
    from repro_torch.runtime.trainer import Trainer, TrainerConfig
    model, params = _one_rank(cfg, weights)
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=SEQ,
                                  global_batch=BATCH, seed=0))
    return Trainer(model, adamw(lr=cosine_schedule(LR, warmup=1,
                                                   total=STEPS),
                                weight_decay=0.01),
                   lambda s: batch_for_model(cfg, data.batch(s),
                                             device="cpu"),
                   TrainerConfig(total_steps=steps, log_every=1 << 30,
                                 checkpoint_every=1 << 30,
                                 checkpoint_dir=ckpt_dir),
                   params=params)


def all_active(cfg):
    """The config with every expert routed to every token: the aux loss is
    then the constant E with no gradient, so a run on one rank and a run
    over ranks follow the same updates (the checkpoint test)."""
    return dataclasses.replace(cfg, top_k=cfg.num_experts)


@pytest.fixture(scope="module")
def trained(ref_run, tmp_path_factory):
    """Over 2 x 2: the planned run (the train program's plan bound, its
    grad_sync verdict running; step-0 ce gradients recorded, then 5
    steps); with every expert active, 5 steps uninterrupted and a 1-step
    run that checkpoints; one rank resumes that for 2 steps and saves;
    2 x 2 resumes that for the last 2."""
    import jax
    import jax.numpy as jnp

    from repro.configs.base import get_config as jax_get_config
    from repro.models.api import build_model as jax_build_model
    weights = ref_run[0]
    cfg = reduced(get_config)
    active = all_active(cfg)
    active_weights = jax.tree_util.tree_map(np.asarray, jax_build_model(
        all_active(reduced(jax_get_config)), None, dtype=jnp.float32).init(
            jax.random.key(SEED + 1)))
    tmp = tmp_path_factory.mktemp("train")
    ckpt = str(tmp / "ckpt")
    kw = dict(dtype=torch.float32, batch=BATCH, seq=SEQ, steps=STEPS, lr=LR)
    spec = _spec(tmp, cfg=cfg, weights=weights, **kw,
                 runs=[dict(label="planned", policy="auto",
                            grads=True, grad_of="ce", check_kernels=True,
                            schemes=["blocks.0.attn.wq", "blocks.0.attn.wo"]),
                       dict(label="full", cfg=active,
                            weights=active_weights),
                       dict(label="ckpt", steps=1, cfg=active,
                            weights=active_weights,
                            ckpt={"dir": ckpt, "every": 1})])
    first = ranks.run_ranks(ranks.train_worker, spec,
                            timeout_s=SPAWN_TIMEOUT_S)
    one = _trainer(active, active_weights, 3, ckpt)
    assert one.state.step == 1
    one_hist = one.run()
    tmp2 = tmp_path_factory.mktemp("train_back")
    back = ranks.run_ranks(ranks.train_worker, _spec(
        tmp2, cfg=active, weights=active_weights, **kw,
        runs=[dict(label="back", restore=ckpt)]), timeout_s=SPAWN_TIMEOUT_S)
    return cfg, weights, first, one_hist, back


def test_step0_ce_and_gradients_match_one_rank(trained):
    from repro_torch.runtime.trainer import trainable
    from repro_torch.data.pipeline import DataConfig, SyntheticLM, \
        batch_for_model
    cfg, weights, first, _, _ = trained
    model, params = _one_rank(cfg, weights)
    trainable(params)
    raw = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=SEQ,
                                 global_batch=BATCH, seed=0)).batch(0)
    _, met = model.loss(params, batch_for_model(cfg, raw, device="cpu"))
    met["ce"].backward()
    run = first[0]["runs"]["planned"]
    assert run["step0"]["ce"] == pytest.approx(met["ce"].item(), rel=1e-6)
    got = run["grads"]
    assert set(got) == {n for n, _ in params.named_parameters()}
    for name, p in params.named_parameters():
        want = p.grad.numpy()
        err = np.abs(got[name] - want).max()
        assert err <= 1e-4 * np.abs(want).max(), name


def test_planned_gradient_sync_runs_its_verdict(trained):
    """The bound plan has a ``train/grad_sync`` site; its scheme is the one
    that ran, over the 4 ranks' fp32 replicated gradients."""
    _, _, first, _, _ = trained
    for r in first:
        run = r["runs"]["planned"]
        assert run["decision"] is not None
        assert run["scheme"] in ("ring", "tree", "hierarchical",
                                 "multiwrite")
        assert run["sync_bytes"] > 0
        assert run["scheme"] == first[0]["runs"]["planned"]["scheme"]


def test_trainer_curve_matches_reference_and_one_rank(trained, ref_run):
    cfg, weights, first, _, _ = trained
    ref = _reference_curve(ref_run)
    hist = first[0]["runs"]["planned"]["history"]
    assert [h["step"] for h in hist] == list(range(STEPS))
    for key in ("loss", "grad_norm"):
        got = np.array([h[key] for h in hist])
        np.testing.assert_allclose(got, ref[key], rtol=1e-5, err_msg=key)
    # one rank's aux is the estimate of the whole batch, the ranks' the mean
    # of their own rows' estimates: its gradient (weight 0.01) moves the two
    # runs apart after step 0 (measured: 1.65e-3 relative at step 4)
    one = _trainer(cfg, weights, STEPS).run()
    assert hist[0]["ce"] == pytest.approx(one[0]["ce"], rel=1e-6)
    np.testing.assert_allclose([h["ce"] for h in hist],
                               [h["ce"] for h in one], rtol=3e-3)
    assert hist[-1]["loss"] < hist[0]["loss"]


def test_step0_schemes_and_backward_checks(trained):
    """The first step's gradients of two leaves reduced by every scheme
    over the 4 ranks: the lossless ones within fp32 sum order of the fp64
    mean, ``compressed`` within its int8 bound; each backward of the step
    recorded against its plain version (on the CPU the plain version runs
    on both sides, so this holds the bookkeeping phase 11 reads)."""
    _, _, first, _, _ = trained
    for r in first:
        run = r["runs"]["planned"]
        assert set(run["schemes"]) == set(ranks.REDUCE_SCHEMES)
        for scheme, got in run["schemes"].items():
            assert got["gap"] <= got["bound"], scheme
        kinds = {c[0] for c in run["kernel_checks"]}
        assert kinds == {"dispatch_pack_bwd", "flash_attention_bwd"}
        assert all(c[3] for c in run["kernel_checks"])


def _planted(fault):
    """Wrap attention's autograd backward so it returns ``fault``(dq, dk,
    dv) in place of its gradients."""
    from unittest import mock

    from repro_torch.kernels import flash_attention as fa
    honest = fa._Attention.backward

    def backward(ctx, grad_out):
        dq, dk, dv, none = honest(ctx, grad_out)
        return (*fault(dq, dk, dv), none)
    return mock.patch.object(fa._Attention, "backward",
                             staticmethod(backward))


@pytest.mark.parametrize("fault", ["none", "zero_dq", "swap_dk_dv",
                                   "scaled_dv"])
def test_attention_backward_check_catches_a_planted_fault(fault):
    """The check phase 11 holds attention's backward to at the ranks'
    shapes, on a loss whose gradients are far below phase 10's atol of
    2e-2 (as the real loss's are): a backward that zeroes dq, swaps dk
    and dv or scales dv by 1.1 is caught, the honest one holds."""
    from repro_torch.kernels import flash_attention as fa
    faults = {"none": None,
              "zero_dq": lambda dq, dk, dv: (torch.zeros_like(dq), dk, dv),
              "swap_dk_dv": lambda dq, dk, dv: (dq, dv, dk),
              "scaled_dv": lambda dq, dk, dv: (dq, dk, 1.1 * dv)}
    rng = np.random.default_rng(3)
    q, k, v = (torch.from_numpy(rng.normal(size=shape).astype(np.float32))
               .requires_grad_(True) for shape in
               ((1, 4, 16, 32), (1, 2, 16, 32), (1, 2, 16, 32)))
    weight = torch.from_numpy(rng.normal(size=(1, 4, 16, 32))
                              .astype(np.float32))
    record: list = []
    planted = _planted(faults[fault]) if faults[fault] else None
    if planted:
        planted.start()
    patches = ranks._checked_backwards(record)
    for patch in patches:
        patch.start()
    try:
        (1e-4 * (fa.flash_attention(q, k, v) * weight).sum()).backward()
    finally:
        for patch in reversed(patches):
            patch.stop()
        if planted:
            planted.stop()
    assert float(q.grad.abs().max()) < 2e-2     # under the old atol
    ((name, shape, _, held, _),) = record
    assert (name, shape) == ("flash_attention_bwd", (1, 4, 16, 32, 2))
    assert held == (fault == "none")


def test_replicas_stay_bit_identical(trained):
    """Every leaf but the experts is the same bits on the 4 ranks after the
    run, and every rank clipped by the same global norm."""
    _, _, first, _, _ = trained
    runs = [r["runs"]["planned"] for r in first]
    assert runs[0]["replicated"]
    for run in runs[1:]:
        for name in runs[0]["replicated"]:
            assert run["digest"][name] == runs[0]["digest"][name], name
        assert [h["grad_norm"] for h in run["history"]] == \
            [h["grad_norm"] for h in runs[0]["history"]]


def test_checkpoint_moves_between_meshes(trained):
    """Every expert active: written over 2 x 2 after step 1 (global
    leaves), resumed on one rank for steps 1 and 2 and saved, resumed over
    2 x 2 for steps 3 and 4: each loss within 1e-6 relative of the
    uninterrupted 2 x 2 run's."""
    _, _, first, one_hist, back = trained
    full = [h["loss"] for h in first[0]["runs"]["full"]["history"]]
    assert first[0]["runs"]["ckpt"]["history"][0]["loss"] == full[0]
    assert [h["step"] for h in one_hist] == [1, 2]
    np.testing.assert_allclose([h["loss"] for h in one_hist], full[1:3],
                               rtol=1e-6)
    run = back[0]["runs"]["back"]
    assert run["start_step"] == 3
    np.testing.assert_allclose([h["loss"] for h in run["history"]],
                               full[3:], rtol=1e-6)


# ---------------------------------------------------------------------------
# moe_ffn's gradients over 2 x 2
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def moe_grads(tmp_path_factory):
    """One reduced DBRX layer (capacity factor 4) on [4, 8, D] tokens and a
    cotangent of its output, over 2 x 2 (the three pairs, and the
    hierarchical pair at G = 4) and on one rank."""
    from repro_torch.models import moe as M
    cfg = reduced(get_config)
    gen = torch.Generator().manual_seed(5)
    layer = M.init_moe(cfg.d_model, cfg.expert_d_ff, cfg.num_experts,
                       generator=gen, device="cpu", dtype=torch.float32)
    rng = np.random.default_rng(6)
    x = rng.normal(size=(WORLD, 8, cfg.d_model)).astype(np.float32)
    ct = rng.normal(size=x.shape).astype(np.float32)
    weights = {k: p.detach().numpy().copy()
               for k, p in layer.named_parameters()}
    tmp = tmp_path_factory.mktemp("moe")
    runs = ranks.fixed_runs() + ranks.fixed_runs(microbatch=4)
    spec = _spec(tmp, cases=[], moe=[dict(name="moe", cfg=cfg, x=x, ct=ct,
                                          weights=weights, runs=runs)])
    got = ranks.run_ranks(ranks.dispatch_worker, spec,
                          timeout_s=SPAWN_TIMEOUT_S)
    for p in layer.parameters():
        p.requires_grad_(True)
    xt = torch.from_numpy(x).requires_grad_(True)
    y, _ = M.moe_ffn(layer, xt, cfg, None)
    (y * torch.from_numpy(ct)).sum().backward()
    want = {"x": xt.grad.numpy(), **{k: p.grad.numpy()
                                     for k, p in layer.named_parameters()}}
    return [r["moe_ffn"]["moe"] for r in got], want


@pytest.mark.parametrize("pair", PAIRS)
def test_moe_ffn_gradients_match_one_rank(moe_grads, pair):
    got, want = moe_grads
    np.testing.assert_allclose(
        np.concatenate([r[pair]["grads"]["x"] for r in got]), want["x"],
        **GRAD_TOL)
    np.testing.assert_allclose(sum(r[pair]["grads"]["router"] for r in got),
                               want["router"], **GRAD_TOL)
    for r in got:
        first, local = r[pair]["experts"]
        for key in ("w1", "w3", "w2"):
            np.testing.assert_allclose(r[pair]["grads"][key],
                                       want[key][first:first + local],
                                       **GRAD_TOL, err_msg=key)


@pytest.mark.parametrize("pair", PAIRS)
def test_moe_ffn_pipeline_gradients_match_one_chunk(moe_grads, pair):
    """G = 4 chunks: the forward bit-exact, every gradient within 1e-5
    relative (of its largest) of G = 1."""
    got, _ = moe_grads
    for r in got:
        one, four = r[pair], r[f"{pair}@G4"]
        assert four["resolved"]["microbatch"] == 4
        np.testing.assert_array_equal(four["y"], one["y"])
        for key, g in one["grads"].items():
            err = np.abs(four["grads"][key] - g).max()
            assert err <= 1e-5 * np.abs(g).max(), key
