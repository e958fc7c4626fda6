"""The attention backward at head_dim 256 (Gemma2's) against ``jax.vjp`` of
the reference's dense attention.

The same numpy inputs (made from a seed) go through ``jax.vjp`` of
``repro.kernels.ref.attention_ref`` over the kv heads repeated to every q
head (the kv gradients summed back over each group's q heads) and through
the port's ``ref.attention_bwd_ref``, the plain backward that the CUDA
kernel is held to on the card, fed the port's log-sum-exp.  The softcap of
50 bites (the q rows are scaled so that scores reach it) and the window
masks keys inside the causal triangle.  Tolerance: 1e-4 of each gradient's
largest |value|, fp32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref
from repro_torch.kernels.flash_attention import bwd256_schedule

D = 256
REL = 1e-4


def _inputs(b, h, g, s, t, seed, q_scale):
    rng = np.random.default_rng(seed)
    q = (rng.normal(size=(b, h, s, D)) * q_scale).astype(np.float32)
    k, v = (rng.normal(size=(b, g, t, D)).astype(np.float32)
            for _ in range(2))
    do = rng.normal(size=(b, h, s, D)).astype(np.float32)
    return q, k, v, do


def _reference(q, k, v, do, kw):
    b, h, s, _ = q.shape
    g, t = k.shape[1], k.shape[2]
    rep = h // g

    def f(q, k, v):
        kx = jnp.repeat(k, rep, axis=1).reshape(b * h, t, D)
        vx = jnp.repeat(v, rep, axis=1).reshape(b * h, t, D)
        return jref.attention_ref(q.reshape(b * h, s, D), kx, vx,
                                  **kw).reshape(b, h, s, D)
    out, vjp = jax.vjp(f, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    return np.array(out), [np.asarray(x) for x in vjp(jnp.asarray(do))]


CASES = [  # b, heads, kv heads, Sq, Sk, causal, window, softcap, q scale
    (1, 4, 2, 48, 48, True, 16, 50.0, 30.0),     # Gemma2's windowed layer
    (2, 2, 1, 40, 40, True, None, 50.0, 30.0),   # its global layer
    (1, 2, 2, 33, 33, True, 8, None, 1.0),       # the window alone
    (1, 4, 1, 17, 29, False, None, 50.0, 30.0),  # no mask, lengths apart
]


@pytest.mark.parametrize("b,h,g,s,t,causal,window,softcap,q_scale", CASES)
def test_attention_backward_256_matches_reference(b, h, g, s, t, causal,
                                                  window, softcap, q_scale):
    q, k, v, do = _inputs(b, h, g, s, t, 11, q_scale)
    kw = dict(causal=causal, window=window, softcap=softcap)
    out, exp = _reference(q, k, v, do, kw)
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))
    if softcap is not None:   # the cap bites: the uncapped scores differ
        plain = dict(kw, softcap=None)
        assert not np.allclose(
            ops.flash_attention(tq, tk, tv, **plain).numpy(), out, atol=1e-2)
    lse = tref.attention_lse(tq, tk, **kw)
    got = tref.attention_bwd_ref(tq, tk, tv, torch.from_numpy(out), tdo, lse,
                                 **kw)
    for name, gr, e in zip("qkv", got, exp):
        scale = float(np.abs(e).max())
        err = float(np.abs(gr.numpy() - e).max())
        assert err <= REL * scale, f"d{name}: {err} > {REL} x {scale}"


def test_attention_256_differentiates_on_the_cpu():
    """``ops.flash_attention`` at head_dim 256 with inputs that need a
    gradient runs its autograd Function (no raise at 256), and autograd
    gives the reference's gradients."""
    b, h, g, s, t, causal, window, softcap, q_scale = CASES[0]
    q, k, v, do = _inputs(b, h, g, s, t, 12, q_scale)
    kw = dict(causal=causal, window=window, softcap=softcap)
    _, exp = _reference(q, k, v, do, kw)
    leaves = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    got = torch.autograd.grad(ops.flash_attention(*leaves, **kw), leaves,
                              torch.from_numpy(do))
    for name, gr, e in zip("qkv", got, exp):
        scale = float(np.abs(e).max())
        assert float(np.abs(gr.numpy() - e).max()) <= REL * scale, name


def test_plain_backward_rounds_p_and_ds_where_asked():
    """``attention_bwd_ref(operands=bf16)`` rounds P and dS before the
    products that take them (the kernel's rounding points): without it the
    result is the fp32 one bit for bit, with it the result moves by about
    bf16's rounding and no more."""
    b, h, g, s, t, causal, window, softcap, q_scale = CASES[0]
    q, k, v, do = (torch.from_numpy(x) for x in
                   _inputs(b, h, g, s, t, 13, q_scale))
    kw = dict(causal=causal, window=window, softcap=softcap)
    out = ops.flash_attention(q, k, v, **kw)
    lse = tref.attention_lse(q, k, **kw)
    exact = tref.attention_bwd_ref(q, k, v, out, do, lse, **kw)
    same = tref.attention_bwd_ref(q, k, v, out, do, lse, **kw,
                                  operands=None)
    rounded = tref.attention_bwd_ref(q, k, v, out, do, lse, **kw,
                                     operands=torch.bfloat16)
    for e, a, r in zip(exact, same, rounded):
        assert torch.equal(e, a)
        gap = float((r - e).abs().max() / e.abs().max())
        assert 0 < gap < 2e-2


def _attending_tiles(q_len, kv_len, causal, window):
    """{(q tile, kv tile)} of 64-row tiles holding a (q row, key) pair the
    mask lets attend, by the tiles' ranges of q row - key."""
    out = set()
    for i in range(-(-q_len // 64)):
        r0, r1 = 64 * i, min(64 * i + 63, q_len - 1)
        for j in range(-(-kv_len // 64)):
            c0, c1 = 64 * j, min(64 * j + 63, kv_len - 1)
            lo, hi = r0 - c1, r1 - c0          # q row - key over the pair
            if causal:
                lo = max(lo, 0)
            if window:
                hi = min(hi, window - 1)
            if lo <= hi:
                out.add((i, j))
    return out


SCHEDULE_CASES = [  # Sq, Sk, causal, window
    (8160, 8160, True, None),    # Gemma2's served prompt, global
    (8160, 8160, True, 4096),    # and its windowed layers
    (8192, 8192, True, None),    # phase 15's training sequence
    (8192, 8192, True, 4096),
    (200, 200, True, 20),        # ragged, a window under a tile
    (77, 333, False, None),      # no mask, lengths apart
    (300, 150, True, 64),        # more q rows than keys
]


@pytest.mark.parametrize("sq,sk,causal,window", SCHEDULE_CASES)
def test_backward_256_schedule_walks_each_attending_pair_once(sq, sk, causal,
                                                              window):
    """The head_dim 256 backward's two passes (``bwd256_schedule``, the
    kernels' index arithmetic): the dQ blocks walk each (q tile, kv tile)
    pair of each (batch, head) that the mask lets attend exactly once, and
    no other; so do the dK/dV blocks over each kv head's q heads; every
    block is launched once; and under self-attention the blocks run
    heaviest first (their walks never lengthen in launch order), so no
    long block starts last."""
    b, h, g = 2, 4, 2
    dq, dkdv = bwd256_schedule(b, h, g, sq, sk, causal=causal, window=window)
    want = _attending_tiles(sq, sk, causal, window)
    walked = {}
    for bb, hh, qt, kv in dq:
        assert len(set(kv)) == len(kv)
        walked.setdefault((bb, hh), []).extend((qt, kt) for kt in kv)
    assert len(dq) == b * h * -(-sq // 64)
    assert sorted(walked) == [(bb, hh) for bb in range(b) for hh in range(h)]
    for pairs in walked.values():
        assert len(pairs) == len(set(pairs)) and set(pairs) == want
    walked = {}
    for bb, gg, kt, units in dkdv:
        for hh, qt in units:
            assert hh // (h // g) == gg
            walked.setdefault((bb, hh), []).append((qt, kt))
    assert len(dkdv) == b * g * -(-sk // 64)
    for bb in range(b):
        for hh in range(h):
            pairs = walked.get((bb, hh), [])
            assert len(pairs) == len(set(pairs)) and set(pairs) == want
    if sq == sk:   # self-attention; past the keys q rows walk nothing
        for blocks in (dq, dkdv):
            steps = [len(x[-1]) for x in blocks]
            assert steps == sorted(steps, reverse=True)
