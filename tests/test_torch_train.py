"""The port's training pieces on one rank against the JAX package: the
losses and the gradients of the two kernels of the DBRX path, of
``moe_ffn``, and the fault-tolerant trainer's behaviours.

Same numpy inputs through both packages on the CPU, where each kernel
wrapper runs its plain version: the chunked cross-entropy's value and
gradient within 1e-5 of ``jax.value_and_grad``; attention's gradient (the
explicit backward behind ``ops.flash_attention``, and autograd of
``flash_attention_plain``) within 1e-4 of ``jax.grad`` of the reference's
``flash_attention_jnp``; the pack's plain backward bit-exact against
``jax.grad`` of the reference's ``pack_by_bitmap``; ``moe_ffn``'s gradients
within 1e-4 of max |grad|.
"""

import dataclasses
import os
import subprocess
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jax_get_config
from repro.core import collectives as jcl
from repro.models import layers as jL
from repro.models import moe as jmoe
from repro_torch.configs.base import get_config
from repro_torch.convert import params_from_jax
from repro_torch.core import collectives as tcl
from repro_torch.data.pipeline import DataConfig, SyntheticLM, batch_for_model
from repro_torch.kernels import ops, ref
from repro_torch.kernels.flash_attention import (bwd_stats_shape,
                                                 dkdv_blocks,
                                                 flash_attention_plain)
from repro_torch.models import layers as L
from repro_torch.models import moe as tmoe
from repro_torch.models import transformer as T
from repro_torch.models.api import build_model, param_count
from repro_torch.optim import adamw, sgd
from repro_torch.runtime.trainer import (StragglerLedger, Trainer,
                                         TrainerConfig, TransientFault)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _np(x) -> np.ndarray:
    return x.detach().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _close_to_max(got, exp, frac, label=""):
    """|got - exp| within ``frac`` of max |exp| (the whole tensor's)."""
    got, exp = _np(got), _np(exp)
    scale = max(float(np.abs(exp).max()), 1e-30)
    err = float(np.abs(got - exp).max())
    assert err <= frac * scale, f"{label}: {err:.3e} > {frac} x {scale:.3e}"


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tied,softcap,s,chunk", [
    (True, None, 24, 8),        # three chunks
    (False, None, 20, 8),       # padded to three
    (False, 30.0, 16, 512),     # one chunk, final softcap
])
def test_chunked_cross_entropy_value_and_grad(tied, softcap, s, chunk):
    rng = np.random.default_rng(0)
    b, d, v = 2, 16, 40
    h = rng.normal(size=(b, s, d)).astype(np.float32)
    emb = rng.normal(size=(v, d) if tied else (d, v)).astype(np.float32)
    labels = rng.integers(0, v, size=(b, s)).astype(np.int32)
    labels[0, 3] = labels[1, -1] = -1                    # ignored

    def jloss(h_, e_):
        return jL.chunked_cross_entropy(h_, e_, jnp.asarray(labels),
                                        tied=tied, chunk=chunk,
                                        final_softcap=softcap)
    jval, (jgh, jge) = jax.value_and_grad(jloss, argnums=(0, 1))(
        jnp.asarray(h), jnp.asarray(emb))
    th = torch.from_numpy(h).requires_grad_(True)
    te = torch.from_numpy(emb).requires_grad_(True)
    tval = L.chunked_cross_entropy(th, te, torch.from_numpy(labels),
                                   tied=tied, chunk=chunk,
                                   final_softcap=softcap)
    tval.backward()
    np.testing.assert_allclose(tval.item(), float(jval), rtol=1e-5)
    np.testing.assert_allclose(_np(th.grad), np.asarray(jgh), atol=1e-5)
    np.testing.assert_allclose(_np(te.grad), np.asarray(jge), atol=1e-5)
    # the unchunked CE on the full logits: the same mean
    logits = th @ (te.T if tied else te)
    if softcap is not None:
        logits = softcap * torch.tanh(logits / softcap)
    full = L.cross_entropy(logits, torch.from_numpy(labels))
    np.testing.assert_allclose(full.item(), float(jL.cross_entropy(
        jnp.asarray(_np(logits)), jnp.asarray(labels))), rtol=1e-5)


# ---------------------------------------------------------------------------
# the kernels' gradients (plain versions on the CPU)
# ---------------------------------------------------------------------------

ATTN_CASES = [  # b, heads, kv heads, S, T, D, causal, window, softcap
    ((2, 4, 2, 24, 24, 16), True, None, None),
    ((1, 6, 2, 20, 20, 8), True, 5, None),
    ((2, 4, 1, 16, 16, 16), True, None, 20.0),
    ((1, 4, 2, 12, 18, 8), False, None, None),
    ((1, 4, 4, 30, 30, 16), True, 7, 10.0),
]


@pytest.mark.parametrize("shape,causal,window,softcap", ATTN_CASES)
def test_attention_grad_matches_reference(shape, causal, window, softcap):
    """The wrapper's backward (``ops.flash_attention`` on CPU tensors: the
    plain forward with its log-sum-exp, then ``ref.attention_bwd_ref``'s
    explicit arithmetic) and autograd of ``flash_attention_plain`` against
    ``jax.grad`` of the reference's ``flash_attention_jnp``, within 1e-4."""
    b, h, g, s, t, d = shape
    rng = np.random.default_rng(sum(shape))
    q, k, v = (rng.normal(size=sz).astype(np.float32)
               for sz in ((b, h, s, d), (b, g, t, d), (b, g, t, d)))
    do = rng.normal(size=(b, h, s, d)).astype(np.float32)
    kw = dict(causal=causal, window=window, softcap=softcap)

    def jf(q_, k_, v_):
        return jnp.sum(jL.flash_attention_jnp(q_, k_, v_, **kw)
                       * jnp.asarray(do))
    jg = jax.grad(jf, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    for fn in (ops.flash_attention, flash_attention_plain):
        tq, tk, tv = (torch.from_numpy(x).requires_grad_(True)
                      for x in (q, k, v))
        out = fn(tq, tk, tv, **kw)
        out.backward(torch.from_numpy(do))
        for got, exp in zip((tq.grad, tk.grad, tv.grad), jg):
            np.testing.assert_allclose(_np(got), np.asarray(exp), atol=1e-4,
                                       rtol=1e-4)


def test_attention_lse_and_bwd_against_autograd():
    """``ref.attention_lse`` is the logsumexp of the masked scores (+inf on
    a row that attends nothing), and ``ref.attention_bwd_ref`` equals
    autograd of the plain forward in float64."""
    rng = np.random.default_rng(4)
    q = torch.from_numpy(rng.normal(size=(1, 4, 10, 8)))
    k = torch.from_numpy(rng.normal(size=(1, 2, 10, 8)))
    v = torch.from_numpy(rng.normal(size=(1, 2, 10, 8)))
    do = torch.from_numpy(rng.normal(size=(1, 4, 10, 8)))
    kw = dict(causal=True, window=3, softcap=4.0)
    lse = ref.attention_lse(q, k, **kw)
    s, mask, _, _ = ref._grouped_scores(q, k, scale=None, **kw)
    exp = torch.logsumexp(s.masked_fill(~mask, -torch.inf), dim=-1)
    torch.testing.assert_close(lse, exp)
    # rows 4 on attend keys past the 3 there are: nothing
    short = ref.attention_lse(q, k[:, :, :3], causal=True, window=2)
    assert torch.isinf(short[..., 4:]).all()
    assert torch.isfinite(short[..., :4]).all()
    qq, kk, vv = (x.clone().requires_grad_(True) for x in (q, k, v))
    out = flash_attention_plain(qq, kk, vv, **kw)
    out.backward(do)
    got = ref.attention_bwd_ref(q, k, v, out.detach(), do, lse, **kw)
    for a, e in zip(got, (qq.grad, kk.grad, vv.grad)):
        torch.testing.assert_close(a.double(), e, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("shape,causal,blocks", [
    ((4, 8, 512), True, 128),      # DBRX's prefill: 8 kv tiles, 4 pairs
    ((1, 8, 4096), True, 256),     # DBRX's kv heads at train_4k
    ((2, 2, 300), True, 12),       # 5 kv tiles: the middle one alone
    ((2, 1, 133), False, 6),       # cross: one block a kv tile
    ((1, 2, 64), True, 2),
])
def test_attention_bwd_dkdv_blocks(shape, causal, blocks):
    """The dK/dV pass's blocks, which size the kernel's record: a block per
    pair of 64-row kv tiles under a causal mask (the middle tile of an odd
    count alone), else per kv tile; for each batch row and kv head."""
    assert dkdv_blocks(*shape, causal=causal) == blocks


def test_attention_bwd_record_needs_the_card():
    """The dK/dV pass's record has no plain version: on the CPU asking for
    it raises, while the backward alone runs the plain one."""
    q, k, v, do = (torch.randn(1, h, 64, 64, dtype=torch.bfloat16)
                   for h in (2, 1, 1, 2))
    out, lse = ops.flash_attention(q, k, v), ref.attention_lse(q, k)
    assert len(ops.flash_attention_bwd(q, k, v, out, do, lse)) == 3
    with pytest.raises(ValueError, match="no kernel for device cpu"):
        ops.flash_attention_bwd(q, k, v, out, do, lse,
                                record=torch.zeros((1, 2, 2), dtype=torch.int64))


@pytest.mark.parametrize("q_len,rows", [(1, 64), (64, 64), (77, 128),
                                        (512, 512), (4097, 4160)])
def test_attention_bwd_stats_scratch(q_len, rows):
    """The backward's fp32 stats scratch: lse log2(e) and delta for every
    q row, padded to whole 64-row steps (the dK/dV pass bulk-loads a step
    of each at once)."""
    assert bwd_stats_shape(3, 5, q_len) == (2, 3, 5, rows)


@pytest.mark.parametrize("n,h,d,c,dtype", [
    (50, 6, 5, 12, np.float32),     # a row in several slots, overflow
    (40, 8, 3, 30, np.float32),     # empty slots
    (64, 4, 1, 64, np.float32),
    (33, 16, 7, 9, jnp.bfloat16),   # bf16: sums in fp32, rounded once
])
def test_pack_backward_matches_reference(n, h, d, c, dtype):
    """The pack's plain backward against ``jax.grad`` of the reference's
    ``pack_by_bitmap`` through an arbitrary output gradient: bit-exact
    (invalid rows and rows past capacity get zeros).  In bf16 JAX rounds
    after every add of its scatter; the port sums in fp32 and rounds once,
    so there it equals the reference's fp32 gradient rounded to bf16."""
    rng = np.random.default_rng(n)
    tokens = rng.normal(size=(n, h)).astype(np.float32)
    bitmap = rng.integers(0, 1 << d, size=n).astype(np.int32)
    valid = rng.random(n) > 0.2
    g = rng.normal(size=(d, c, h)).astype(np.float32)
    if dtype == jnp.bfloat16:       # values that bf16 holds exactly
        tokens = np.asarray(jnp.asarray(tokens, dtype).astype(jnp.float32))
        g = np.asarray(jnp.asarray(g, dtype).astype(jnp.float32))
    jg = jax.grad(lambda x: jnp.sum(
        jcl.pack_by_bitmap(x, jnp.asarray(bitmap), jnp.asarray(valid), d,
                           c)[0] * jnp.asarray(g)))(jnp.asarray(tokens))
    jg = jg.astype(dtype)
    tdt = torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32
    tt = torch.from_numpy(tokens).to(tdt).requires_grad_(True)
    out, idx = ops.dispatch_pack(tt, torch.from_numpy(bitmap),
                                 torch.from_numpy(valid), num_dests=d,
                                 capacity=c)
    out.backward(torch.from_numpy(g).to(tdt))
    assert tt.grad.dtype == tdt
    np.testing.assert_array_equal(tt.grad.float().numpy(),
                                  np.asarray(jg.astype(jnp.float32)))
    # the plain backward directly, on the map the pack made
    direct = ref.pack_bwd_ref(torch.from_numpy(g).to(tdt), idx, n)
    assert torch.equal(direct, tt.grad)


def _moe_inputs(seed=0):
    jcfg = jax_get_config("dbrx_132b").reduced()
    tcfg = get_config("dbrx_132b").reduced()
    rng = np.random.default_rng(seed)
    d, e, f = jcfg.d_model, jcfg.num_experts, jcfg.expert_d_ff
    p = {"router": rng.normal(size=(d, e)).astype(np.float32) * 0.3,
         "w1": rng.normal(size=(e, d, f)).astype(np.float32) * d ** -0.5,
         "w3": rng.normal(size=(e, d, f)).astype(np.float32) * d ** -0.5,
         "w2": rng.normal(size=(e, f, d)).astype(np.float32) * f ** -0.5}
    x = rng.normal(size=(2, 8, d)).astype(np.float32)
    dy = rng.normal(size=(2, 8, d)).astype(np.float32)
    return jcfg, tcfg, p, x, dy


@pytest.mark.parametrize("capacity", [None, 1.25])
def test_moe_ffn_grads_match_reference(capacity):
    """The gradient of ``moe_ffn`` on reduced DBRX (one rank, the
    hierarchical pair) in its input, router and experts, through the three
    packs' backward, the gathers, the gates and the fp32 combine, plus the
    aux loss: within 1e-4 of each gradient's max |grad|.  At capacity 1.25
    tokens overflow, so the backward sees dropped pairs."""
    jcfg, tcfg, p, x, dy = _moe_inputs()
    if capacity is not None:
        jcfg = dataclasses.replace(jcfg, moe_capacity=capacity)
        tcfg = dataclasses.replace(tcfg, moe_capacity=capacity)

    def jf(p_, x_):
        out, aux = jmoe.moe_ffn(p_, x_, jcfg, None)
        return jnp.sum(out * jnp.asarray(dy)) + 3.0 * aux
    jgp, jgx = jax.jit(jax.grad(jf, argnums=(0, 1)))(
        {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x))

    moe = tmoe.MoE(tcfg.d_model, tcfg.expert_d_ff, tcfg.num_experts,
                   device="cpu", dtype=torch.float32)
    with torch.no_grad():
        for name, val in p.items():
            getattr(moe, name).copy_(torch.from_numpy(val))
    for prm in moe.parameters():
        prm.requires_grad_(True)
    tx = torch.from_numpy(x).requires_grad_(True)
    out, aux = tmoe.moe_ffn(moe, tx, tcfg)
    (torch.sum(out * torch.from_numpy(dy)) + 3.0 * aux).backward()
    _close_to_max(tx.grad, jgx, 1e-4, "x")
    for name in p:
        _close_to_max(getattr(moe, name).grad, jgp[name], 1e-4, name)


def test_dispatch_combine_let_the_gradient_through():
    """``gather_rows`` (a fill in place) and ``_sum_rows_into`` (``copy_``
    and ``+=`` into slices of a fresh fp32 buffer) are differentiable: the
    round trip's gradient in the tokens and the gates equals that of the
    dense sum it computes, sum_k gate_k * f(token), with f the identity."""
    rng = np.random.default_rng(1)
    n, h, e, k = 24, 8, 8, 2
    tokens = torch.from_numpy(rng.normal(size=(n, h)).astype(np.float32))
    logits = torch.from_numpy(rng.normal(size=(n, e)).astype(np.float32))
    tokens.requires_grad_(True)
    logits.requires_grad_(True)
    mesh = tcl.EPMesh(pod_axis=None, ep_axis="_none", num_pods=1,
                      ep_per_pod=1)
    dcfg = tmoe.balanced_capacities(n, k, 1, 1, e, 8.0)
    gates, ids = tcl.route_topk(logits, k)
    exp_tok, exp_gate, st = tcl.hierarchical_dispatch(tokens, ids, gates,
                                                      dcfg, mesh)
    out = tcl.hierarchical_combine(exp_tok, exp_gate, st)
    w = torch.from_numpy(rng.normal(size=(n, h)).astype(np.float32))
    (out * w).sum().backward()
    g_tok, g_log = tokens.grad.clone(), logits.grad.clone()
    tokens.grad = logits.grad = None
    gates2, _ = tcl.route_topk(logits, k)
    dense = gates2.sum(-1, keepdim=True) * tokens
    (dense * w).sum().backward()
    torch.testing.assert_close(g_tok, tokens.grad)
    torch.testing.assert_close(g_log, logits.grad, atol=1e-6, rtol=1e-5)


def test_remat_recomputes_the_same_gradients():
    """``_remat`` under a context that asks for remat (a stand-in with the
    reference's ``remat`` field) wraps a block in
    ``torch.utils.checkpoint``: the same values and gradients."""
    cfg = get_config("dbrx_132b").reduced(n_layers=1)
    gen = torch.Generator().manual_seed(0)
    params = build_model(cfg, device="cpu", dtype=torch.float32).init(gen)
    for prm in params.parameters():
        prm.requires_grad_(True)
    x = torch.randn(2, 6, cfg.d_model, generator=gen)
    pos = torch.arange(6).expand(2, 6)
    blk = params.blocks[0]

    def run(pctx):
        fn = T._remat(lambda x_: T._train_block(blk, x_, pos, cfg, None,
                                                None), pctx)
        y, aux = fn(x)
        (y.square().sum() + aux).backward()
        grads = [prm.grad.clone() for prm in blk.parameters()]
        params.zero_grad(set_to_none=True)
        return y.detach(), grads
    assert T._remat(len, None) is len
    plain = run(None)
    remat = run(types.SimpleNamespace(remat="full"))
    torch.testing.assert_close(remat[0], plain[0])
    for a, b in zip(remat[1], plain[1]):
        torch.testing.assert_close(a, b)


# ---------------------------------------------------------------------------
# the trainer's behaviours (the reference's checks, on the port)
# ---------------------------------------------------------------------------

def tiny_setup(tmp_path=None, total=12, ckpt_every=4, arch="mistral_nemo_12b"):
    cfg = get_config(arch).reduced(n_layers=1, d_model=32, n_heads=2,
                                   d_ff=64, vocab=128)
    model = build_model(cfg, device="cpu", dtype=torch.float32)
    data = SyntheticLM(DataConfig(vocab=128, seq_len=16, global_batch=4))
    tcfg = TrainerConfig(total_steps=total, checkpoint_every=ckpt_every,
                         checkpoint_dir=str(tmp_path) if tmp_path else None,
                         log_every=1000)

    def make_batch(s):
        return batch_for_model(cfg, data.batch(s), device="cpu")
    return model, tcfg, make_batch


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def _params(tr):
    return [p.detach().clone() for p in tr.state.params.parameters()]


class TestTrainer:
    def test_loss_decreases(self, tmp_path):
        model, tcfg, mb = tiny_setup(tmp_path, total=30, arch="dbrx_132b")
        tr = Trainer(model, adamw(lr=3e-3), mb, tcfg)
        hist = tr.run()
        first = np.mean([h["loss"] for h in hist[:5]])
        last = np.mean([h["loss"] for h in hist[-5:]])
        assert last < first - 0.1, (first, last)
        assert param_count(tr.state.params) == sum(
            p.numel() for p in tr.state.named().values())

    def test_checkpoint_resume_bitexact(self, tmp_path):
        model, tcfg, mb = tiny_setup(tmp_path, total=8, ckpt_every=4)
        tr1 = Trainer(model, adamw(lr=1e-3), mb, tcfg, generator=_gen(1))
        tr1.run()
        # a second trainer resumes from the step 8 checkpoint, 0 more steps
        tr2 = Trainer(model, adamw(lr=1e-3), mb, tcfg, generator=_gen(999))
        assert tr2.state.step == 8
        for a, b in zip(_params(tr1), _params(tr2)):
            assert torch.equal(a, b)
        for key in ("m", "v"):
            for name, t in tr1.state.opt_state[key].items():
                assert torch.equal(t, tr2.state.opt_state[key][name])

    def test_interrupted_run_resumes_and_matches_uninterrupted(self,
                                                               tmp_path):
        """Crash at step 6, resume in a fresh trainer: the final parameters
        equal those of a run that never crashed, bit for bit."""
        model, tcfg, mb = tiny_setup(tmp_path / "a", total=10, ckpt_every=2)

        class Crash(Exception):
            pass

        boom = {"armed": True}

        def fault(step):
            if step == 6 and boom["armed"]:
                boom["armed"] = False
                raise Crash()

        tr = Trainer(model, sgd(lr=1e-2), mb, tcfg, generator=_gen(3),
                     fault_hook=fault)
        with pytest.raises(Crash):
            tr.run()
        tr2 = Trainer(model, sgd(lr=1e-2), mb, tcfg, generator=_gen(3))
        assert tr2.state.step == 6
        tr2.run()
        model3, tcfg3, mb3 = tiny_setup(tmp_path / "b", total=10,
                                        ckpt_every=2)
        tr3 = Trainer(model3, sgd(lr=1e-2), mb3, tcfg3, generator=_gen(3))
        tr3.run()
        for a, b in zip(_params(tr2), _params(tr3)):
            assert torch.equal(a, b)

    def test_transient_fault_retried(self, tmp_path):
        model, tcfg, mb = tiny_setup(tmp_path, total=6, ckpt_every=2)
        fails = {"n": 0}

        def flaky(step):
            if step == 3 and fails["n"] < 1:
                fails["n"] += 1
                raise TransientFault("injected")

        tr = Trainer(model, sgd(lr=1e-2), mb, tcfg, fault_hook=flaky)
        hist = tr.run()
        assert fails["n"] == 1
        assert len(hist) == 6          # all steps completed

    def test_persistent_fault_rolls_back(self, tmp_path):
        """A step that keeps failing past ``max_retries`` rolls the trainer
        back to the last checkpoint, whose steps then run again: the run
        ends where an unfaulted one does, with the same parameters."""
        model, tcfg, mb = tiny_setup(tmp_path / "a", total=6, ckpt_every=2)
        tries = {"n": 0}

        def stuck(step):
            if step == 3 and tries["n"] < 3:     # max_retries = 2
                tries["n"] += 1
                raise TransientFault("injected")

        tr = Trainer(model, sgd(lr=1e-2), mb, tcfg, generator=_gen(5),
                     fault_hook=stuck)
        hist = tr.run()
        assert tries["n"] == 3
        assert [h["step"] for h in hist] == [0, 1, 2, 2, 3, 4, 5]
        _, tcfg2, mb2 = tiny_setup(tmp_path / "b", total=6, ckpt_every=2)
        clean = Trainer(model, sgd(lr=1e-2), mb2, tcfg2, generator=_gen(5))
        clean.run()
        for a, b in zip(_params(tr), _params(clean)):
            assert torch.equal(a, b)

    def test_grad_accum_equals_one_batch_for_sgd(self):
        """Two micro-batches of 2 rows: fp32 gradients summed and halved,
        the loss the mean of the two, so plain SGD lands where one batch of
        4 rows does (the reduced model's token mean is per micro-batch, and
        both halves hold the same count of labels)."""
        from repro_torch.launch.train import micro_batches
        from repro_torch.runtime.trainer import make_train_step
        model, tcfg, mb = tiny_setup(total=2)
        runs = []
        for accum in (1, 2):
            tr = Trainer(model, sgd(lr=1e-1), lambda s, a=accum:
                         micro_batches(mb(s), a), tcfg, generator=_gen(2),
                         train_step=make_train_step(model, sgd(lr=1e-1),
                                                    grad_accum=accum))
            runs.append((tr.run(), _params(tr)))
        for a, b in zip(runs[0][1], runs[1][1]):
            torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-5)
        assert runs[0][0][0]["loss"] == pytest.approx(runs[1][0][0]["loss"],
                                                      rel=1e-5)

    def test_straggler_detection(self):
        led = StragglerLedger(threshold=3.0)
        outliers = []
        for step in range(30):
            dt = 0.1 if step != 20 else 2.0
            if led.record(step, dt):
                outliers.append(step)
        assert outliers == [20]

    def test_step_hook_and_straggler_hook(self):
        model, tcfg, mb = tiny_setup(total=3)
        rows, slow = [], []
        tr = Trainer(model, sgd(lr=1e-2), mb, tcfg,
                     step_hook=lambda s, row: rows.append(row),
                     straggler_hook=lambda s, dt: slow.append(s))
        tr.run()
        assert [r["step"] for r in rows] == [0, 1, 2]
        assert set(rows[0]) >= {"loss", "grad_norm", "ce", "aux", "wall"}
        assert slow == []


def test_device_rule():
    """``device=None`` means CUDA: without a card the model, the batch
    adapter and the launcher raise rather than run on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg = get_config("dbrx_132b").reduced()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_model(cfg)
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=8,
                                  global_batch=2))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        batch_for_model(cfg, data.batch(0))
    from repro_torch.launch import train
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(["--arch", "dbrx_132b", "--smoke", "--steps", "1"])
    with pytest.raises(NotImplementedError, match="item 8b"):
        train.main(["--arch", "dbrx_132b", "--smoke", "--device", "cpu",
                    "--multi-pod"])


@pytest.mark.parametrize("arch", ["zamba2_7b", "rwkv6_7b"])
def test_recurrent_families_train_on_the_cpu(arch):
    """The hybrid and rwkv families take a gradient on the CPU through
    their plain scans (one that raises on the card: the gpu tests hold
    that), and their loss equals the reference's on the same weights."""
    import jax.random as jr

    from repro.models.api import build_model as jax_build_model
    jcfg = jax_get_config(arch).reduced()
    cfg = get_config(arch).reduced()
    jmodel = jax_build_model(jcfg, None, dtype=jnp.float32)
    jparams = jmodel.init(jr.key(0))
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=16,
                                  global_batch=2))
    raw = data.batch(0)
    jloss, _ = jax.jit(jmodel.loss)(jparams, {k: jnp.asarray(v)
                                              for k, v in raw.items()})
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                             cfg, device="cpu", dtype=torch.float32)
    model = build_model(cfg, device="cpu", dtype=torch.float32)
    for prm in params.parameters():
        prm.requires_grad_(True)
    loss, metrics = model.loss(params, batch_for_model(cfg, raw,
                                                       device="cpu"))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-4)
    assert float(metrics["aux"]) == 0.0
    assert all(torch.isfinite(p.grad).all() for p in params.parameters()
               if p.grad is not None)


def test_launch_train_smoke_subprocess(tmp_path):
    """``python -m repro_torch.launch.train --smoke --device cpu`` trains
    and prints the reference's final-loss line; its checkpoint directory
    then holds the last step."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "dbrx_132b", "--smoke", "--device", "cpu", "--steps", "3",
         "--ckpt-dir", str(tmp_path), "--ckpt-every", "2"],
        capture_output=True, text=True, env=env, timeout=120, check=True)
    assert "final loss" in out.stdout and "over 3 steps" in out.stdout
    assert sorted(os.listdir(tmp_path)) == ["step_00000002",
                                            "step_00000003"]
