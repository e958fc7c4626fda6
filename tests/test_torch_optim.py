"""The port's optimizers, data pipeline and checkpoint store against the
JAX package.

The same numpy parameters and gradients go through both packages' update
rules (within 1e-6 in fp32; bf16 AdamW state bit-equal); the reference's
own checks of ``tests/test_substrates.py`` re-run on the port's copies; the
token stream equals the reference's bit for bit; checkpoints round-trip
bf16 leaves bit-exact and keep the reference's guarantees.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import pipeline as jdata
from repro.optim import optimizers as jopt
from repro_torch.checkpoint.store import CheckpointManager
from repro_torch.configs.base import get_config
from repro_torch.data.pipeline import (DataConfig, SyntheticLM, _stub_embed,
                                       batch_for_model)
from repro_torch.optim import (adafactor, adamw, chain_clip, cosine_schedule,
                               lion, sgd)
from repro_torch.optim import optimizers as topt
from repro_torch.optim.optimizers import apply_updates, global_norm


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy() if x.dtype == torch.bfloat16 \
            else x.detach().numpy()
    return np.asarray(x.astype(jnp.float32) if x.dtype == jnp.bfloat16
                      else x)


def _tensors(tree):
    return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


# ---------------------------------------------------------------------------
# the reference's own checks on the port's copies
# ---------------------------------------------------------------------------

def quadratic_params():
    return {"a": torch.tensor([2.0, -3.0]), "b.c": torch.tensor([[1.5]])}


@pytest.mark.parametrize("make_opt,steps,tol", [
    (lambda: adamw(lr=0.1), 200, 1e-2),
    (lambda: adafactor(lr=0.3), 800, 5e-2),   # relative-update optimizer
    (lambda: lion(lr=0.05), 200, 1e-2),
    (lambda: sgd(lr=0.3, momentum=0.9), 200, 1e-2),
])
def test_optimizers_minimize_quadratic(make_opt, steps, tol):
    opt = make_opt()
    params = quadratic_params()
    state = opt.init(params)
    for step in range(steps):
        g = {k: 2 * p for k, p in params.items()}
        upd, state = opt.update(g, state, params, step)
        params = apply_updates(params, upd)
    assert sum(float((p * p).sum()) for p in params.values()) < tol


def test_adamw_bf16_state():
    opt = adamw(lr=0.1, opt_dtype=torch.bfloat16)
    params = quadratic_params()
    state = opt.init(params)
    assert state["m"]["a"].dtype == torch.bfloat16
    g = {k: torch.ones_like(p) for k, p in params.items()}
    upd, state = opt.update(g, state, params, 0)
    assert torch.isfinite(upd["a"]).all()


def test_clip_and_schedule():
    lr = cosine_schedule(1.0, warmup=10, total=100)
    assert float(lr(0)) == 0.0
    assert float(lr(10)) == pytest.approx(1.0)
    assert float(lr(100)) == pytest.approx(0.1, abs=1e-6)
    opt = chain_clip(sgd(lr=1.0), max_norm=1.0)
    params = {"a": torch.zeros(4)}
    state = opt.init(params)
    upd, _ = opt.update({"a": torch.full((4,), 100.0)}, state, params, 0)
    assert float(global_norm(upd)) == pytest.approx(1.0, rel=1e-4)


# ---------------------------------------------------------------------------
# against the reference's arithmetic, step by step
# ---------------------------------------------------------------------------

def _leaves(seed, shapes):
    rng = np.random.default_rng(seed)
    return {k: rng.normal(size=s).astype(np.float32)
            for k, s in shapes.items()}


SHAPES = {"w": (6, 5), "e": (3, 4, 7), "n": (9,)}
OPTS = {
    "adamw": (lambda m, sched: m.adamw(lr=sched, weight_decay=0.1), 1),
    "adamw_const": (lambda m, sched: m.adamw(lr=3e-3), 1),
    "adafactor": (lambda m, sched: m.adafactor(lr=sched, weight_decay=0.01),
                  1),
    "lion": (lambda m, sched: m.lion(lr=sched), 1),
    "sgd_momentum": (lambda m, sched: m.sgd(lr=sched, momentum=0.9), 1),
    "sgd": (lambda m, sched: m.sgd(lr=1e-2), 1),
    "adamw_clip": (lambda m, sched: m.chain_clip(m.adamw(lr=sched), 0.5), 1),
}


@pytest.mark.parametrize("name", sorted(OPTS))
@pytest.mark.parametrize("in_place", [False, True])
def test_optimizer_steps_match_reference(name, in_place, monkeypatch):
    """Five steps on the same fp32 parameters and gradients: the port's
    update (``update``, or ``apply`` in place over slices smaller than a
    leaf) equals the reference's within 1e-6, state included."""
    make, _ = OPTS[name]
    if in_place:                    # slices cut every leaf but the smallest
        monkeypatch.setattr(topt, "CHUNK", 8)
    jsched = jopt.cosine_schedule(1e-2, warmup=2, total=5)
    tsched = topt.cosine_schedule(1e-2, warmup=2, total=5)
    jo, to = make(jopt, jsched), make(topt, tsched)
    p0 = _leaves(0, SHAPES)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    tp = _tensors(p0)
    js, ts = jo.init(jp), to.init(tp)
    for step in range(5):
        g = _leaves(step + 10, SHAPES)
        ju, js = jo.update({k: jnp.asarray(v) for k, v in g.items()}, js, jp,
                           step)
        jp = jopt.apply_updates(jp, ju)
        if in_place:
            to.apply(_tensors(g), ts, tp, step)
        else:
            tu, ts = to.update(_tensors(g), ts, tp, step)
            tp = apply_updates(tp, tu)
        for k in SHAPES:
            np.testing.assert_allclose(_np(tp[k]), _np(jp[k]), rtol=1e-6,
                                       atol=1e-6)
    for (path, jl), tl in zip(
            jax.tree_util.tree_flatten_with_path(js)[0],
            jax.tree_util.tree_leaves(ts)):
        np.testing.assert_allclose(_np(tl), _np(jl), rtol=1e-6, atol=1e-7,
                                   err_msg=str(path))


@pytest.mark.parametrize("in_place", [False, True])
def test_adamw_bf16_state_bit_equal_to_reference(in_place, monkeypatch):
    """AdamW with bf16 moments on bf16 parameters (``opt_dtype=None`` takes
    the parameters' dtype): after three steps the bf16 m and v and the
    parameters are the reference's bits."""
    if in_place:
        monkeypatch.setattr(topt, "CHUNK", 16)
    p0 = _leaves(1, SHAPES)
    jp = {k: jnp.asarray(v, jnp.bfloat16) for k, v in p0.items()}
    tp = {k: torch.from_numpy(v).to(torch.bfloat16) for k, v in p0.items()}
    jo, to = jopt.adamw(lr=1e-2), topt.adamw(lr=1e-2)
    js, ts = jo.init(jp), to.init(tp)
    assert ts["m"]["w"].dtype == torch.bfloat16
    for step in range(3):
        g = _leaves(step + 20, SHAPES)
        jg = {k: jnp.asarray(v, jnp.bfloat16) for k, v in g.items()}
        tg = {k: torch.from_numpy(v).to(torch.bfloat16)
              for k, v in g.items()}
        ju, js = jo.update(jg, js, jp, step)
        jp = jopt.apply_updates(jp, ju)
        if in_place:
            to.apply(tg, ts, tp, step)
        else:
            tu, ts = to.update(tg, ts, tp, step)
            tp = apply_updates(tp, tu)
    for k in SHAPES:
        for key in ("m", "v"):
            np.testing.assert_array_equal(_np(ts[key][k]), _np(js[key][k]))
        np.testing.assert_array_equal(_np(tp[k]), _np(jp[k]))


def test_clip_and_norm_match_reference():
    g = _leaves(5, SHAPES)
    jg, jn = jopt.clip_by_global_norm({k: jnp.asarray(v) for k, v in
                                       g.items()}, 1.0)
    tg, tn = topt.clip_by_global_norm(_tensors(g), 1.0)
    np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
    for k in SHAPES:
        np.testing.assert_allclose(_np(tg[k]), _np(jg[k]), rtol=1e-6,
                                   atol=1e-7)
    inplace = _tensors(g)
    norm = topt.clip_by_global_norm_(inplace, 1.0)
    assert float(norm) == float(tn)
    for k in SHAPES:
        np.testing.assert_array_equal(inplace[k].numpy(), tg[k].numpy())


def test_cosine_schedule_matches_reference():
    js = jopt.cosine_schedule(3e-4, warmup=10, total=100)
    ts = topt.cosine_schedule(3e-4, warmup=10, total=100)
    for step in (0, 1, 5, 10, 11, 50, 99, 100, 130):
        assert float(ts(step)) == pytest.approx(float(js(step)), rel=1e-6,
                                                abs=1e-12)


# ---------------------------------------------------------------------------
# data pipeline
# ---------------------------------------------------------------------------

class TestData:
    def test_deterministic_in_step(self):
        d = SyntheticLM(DataConfig(vocab=100, seq_len=16, global_batch=4))
        np.testing.assert_array_equal(d.batch(7)["tokens"],
                                      d.batch(7)["tokens"])

    def test_host_sharding_reconstructs_global(self):
        d = SyntheticLM(DataConfig(vocab=100, seq_len=16, global_batch=8))
        full = d.batch(3, 0, 1)
        parts = [d.batch(3, h, 4)["tokens"] for h in range(4)]
        np.testing.assert_array_equal(np.concatenate(parts), full["tokens"])

    def test_labels_are_shifted_tokens(self):
        b = SyntheticLM(DataConfig(vocab=100, seq_len=16,
                                   global_batch=2)).batch(0)
        np.testing.assert_array_equal(b["tokens"][:, 1:], b["labels"][:, :-1])

    @pytest.mark.parametrize("seed,step", [(0, 0), (0, 5), (3, 11)])
    def test_stream_equals_reference(self, seed, step):
        cfg = dict(vocab=512, seq_len=64, global_batch=4, seed=seed)
        mine = SyntheticLM(DataConfig(**cfg)).batch(step, 1, 2)
        theirs = jdata.SyntheticLM(jdata.DataConfig(**cfg)).batch(step, 1, 2)
        for key in ("tokens", "labels"):
            np.testing.assert_array_equal(mine[key], theirs[key])

    def test_model_batch_on_device(self):
        d = SyntheticLM(DataConfig(vocab=512, seq_len=8, global_batch=2))
        batch = batch_for_model(get_config("dbrx_132b").reduced(),
                                d.batch(0), device="cpu")
        assert batch["tokens"].dtype == torch.int32
        assert batch["labels"].device.type == "cpu"

    def test_stub_embed_equals_reference(self):
        toks = np.random.default_rng(0).integers(0, 1000, size=(2, 5))
        np.testing.assert_array_equal(_stub_embed(toks, 16),
                                      jdata._stub_embed(toks, 16))


# ---------------------------------------------------------------------------
# checkpointing
# ---------------------------------------------------------------------------

class TestCheckpoint:
    def make_tree(self, x=0.0):
        return {"w": torch.full((4, 3), x), "nested": {"b": torch.arange(5.0)},
                "h": torch.full((2, 3), x, dtype=torch.bfloat16),
                "step": torch.tensor(7, dtype=torch.int32)}

    def test_save_restore_roundtrip(self, tmp_path):
        cm = CheckpointManager(str(tmp_path))
        tree = self.make_tree(1.5)
        cm.save(10, tree, extra={"note": "hi"})
        got, extra = cm.restore(10, self.make_tree())
        assert extra["note"] == "hi"
        assert got["h"].dtype == torch.bfloat16
        for key in ("w", "h", "step"):
            assert torch.equal(got[key], tree[key])
        assert torch.equal(got["nested"]["b"], tree["nested"]["b"])

    def test_bf16_roundtrip_bit_exact(self, tmp_path):
        """Every bf16 bit pattern but the NaNs comes back as it was."""
        bits = torch.arange(-(1 << 15), 1 << 15, dtype=torch.int32).to(
            torch.int16)
        leaf = bits.view(torch.bfloat16)
        leaf = leaf[~torch.isnan(leaf)]
        cm = CheckpointManager(str(tmp_path))
        cm.save(1, {"x": leaf})
        into = {"x": torch.zeros_like(leaf)}
        cm.restore_into(1, into)
        assert torch.equal(into["x"].view(torch.int16), leaf.view(torch.int16))

    def test_atomic_commit_no_partial_visible(self, tmp_path):
        cm = CheckpointManager(str(tmp_path))
        cm.save(1, self.make_tree())
        assert os.listdir(tmp_path) == ["step_00000001"]

    def test_keep_last_k_gc(self, tmp_path):
        cm = CheckpointManager(str(tmp_path), keep_last_k=2)
        for s in (1, 2, 3, 4):
            cm.save(s, self.make_tree())
        assert cm.all_steps() == [3, 4]

    def test_corruption_detected(self, tmp_path):
        cm = CheckpointManager(str(tmp_path))
        cm.save(5, self.make_tree())
        shard = tmp_path / "step_00000005" / "shard_00000.npz"
        data = dict(np.load(shard))
        data["w"] = data["w"] + 1
        np.savez(shard, **data)
        with pytest.raises(IOError):
            cm.restore(5, self.make_tree())

    def test_async_write(self, tmp_path):
        cm = CheckpointManager(str(tmp_path), async_write=True)
        cm.save(2, self.make_tree())
        cm.wait()
        assert cm.all_steps() == [2]

    def test_reads_what_the_reference_reads(self, tmp_path):
        """The archive is the reference's layout: its ``np.load`` finds the
        fp32 leaves by path with the crc its manifest records."""
        from repro.checkpoint.store import CheckpointManager as JCM
        cm = CheckpointManager(str(tmp_path))
        tree = {"w": torch.full((4, 3), 2.5), "n": {"b": torch.arange(5.0)}}
        cm.save(3, tree)
        got, _ = JCM(str(tmp_path)).restore(
            3, {"w": jnp.zeros((4, 3)), "n": {"b": jnp.zeros(5)}})
        np.testing.assert_array_equal(np.asarray(got["w"]), tree["w"].numpy())
        np.testing.assert_array_equal(np.asarray(got["n"]["b"]),
                                      tree["n"]["b"].numpy())
