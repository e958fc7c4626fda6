"""The gradients of the port's two scans against ``jax.vjp`` of the
reference's chunked jnp twins.

The same numpy inputs (made from a seed) go through ``jax.vjp`` of
``repro.kernels.ref.mamba2_chunked_jnp`` / ``rwkv6_chunked_jnp`` and
through the port on the CPU: the scan wrappers' backward (``mamba2_scan_bwd``
/ ``rwkv6_scan_bwd``, which run their plain versions, the gradients of the
chunked scans) and ``ref.mamba2_bwd_chunks`` / ``ref.rwkv6_bwd_chunks``,
plain models of the CUDA backward kernels' own algorithm (the reverse walk
over 64-step chunks, and RWKV-6's log-decay gradient as a running sum),
both also with the kernels' tensor-core operands (bf16 inputs, hi + lo
pairs of bf16, or three parts, for the operands made in fp32), the RWKV-6
one also around the kernel's sub-chunk reference points (``sub=16``).
For the reference, B and C are broadcast to every head and their gradients
summed over each group's rows.  Every gradient is held within 1e-4 of its
largest |value| in fp32.

The reference's masked upper triangle (``jnp.where(tri, exp(cum_i -
cum_j), 0)`` in the Mamba2 twin, ``k exp(-cum)`` in the RWKV-6 one) takes
exp of a positive exponent; where that overflows fp32 its gradient is not
finite (0 x inf), so the decays drawn here keep it in range, and the
kernel algorithms are held to autograd of the per-step recurrences at
decays where the twins' gradients are not finite.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref
from repro_torch.kernels.mamba2_scan import (expand_groups, mamba2_scan_bwd,
                                             sum_groups)
from repro_torch.kernels.rwkv6_scan import rwkv6_scan_bwd

REL = 1e-4


def _close(name, got, exp):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got)
    scale = float(np.abs(exp).max())
    err = float(np.abs(got - exp).max())
    assert np.isfinite(got).all(), f"{name}: not finite"
    assert err <= REL * scale, f"{name}: max|err| {err} > {REL} x {scale}"


def _t(x):
    return None if x is None else torch.from_numpy(x)


def _mamba2_inputs(batch, heads, s, groups, final, seed, dh=16, ds=8,
                   dt_shift=-2.5):
    rng = np.random.default_rng(seed)
    rows = batch * heads
    g = {"shared": batch, "per-head": rows}[groups]
    x = rng.normal(size=(rows, s, dh)).astype(np.float32)
    dt = np.log1p(np.exp(rng.normal(size=(rows, s)) + dt_shift)).astype(
        np.float32)
    a = (-np.exp(rng.normal(size=(rows,)) * 0.3)).astype(np.float32)
    b, c = (rng.normal(size=(g, s, ds)).astype(np.float32) for _ in range(2))
    d = rng.normal(size=(rows,)).astype(np.float32)
    dy = rng.normal(size=(rows, s, dh)).astype(np.float32)
    dh_final = (rng.normal(size=(rows, ds, dh)).astype(np.float32)
                if final else None)
    return (x, dt, a, b, c, d), dy, dh_final


def _mamba2_reference_grads(args, dy, dh_final):
    """jax.vjp of the twin with B/C broadcast per head, their gradients
    summed back over each group's rows."""
    x, dt, a, b, c, d = args
    rows, g = x.shape[0], b.shape[0]
    rep = rows // g
    bh, ch = np.repeat(b, rep, 0), np.repeat(c, rep, 0)
    (_, hf), vjp = jax.vjp(
        lambda *t: jref.mamba2_chunked_jnp(*t, return_final=True),
        *(jnp.asarray(t) for t in (x, dt, a, bh, ch, d)))
    grads = [np.asarray(t) for t in vjp((
        jnp.asarray(dy), jnp.zeros_like(hf) if dh_final is None
        else jnp.asarray(dh_final)))]
    for i in (3, 4):
        grads[i] = grads[i].reshape(g, rep, *grads[i].shape[1:]).sum(1)
    return grads


MAMBA2_CASES = [  # batch, heads, S, groups, final-state gradient
    (2, 2, 128, "shared", True),      # S a multiple of 64, 2 groups of 2
    (1, 3, 100, "per-head", False),   # a ragged last chunk, G = BH
    (2, 3, 37, "shared", True),       # one short chunk, 3 heads a group
    (1, 2, 200, "per-head", True),    # four chunks, the last ragged
]


@pytest.mark.parametrize("batch,heads,s,groups,final", MAMBA2_CASES)
def test_mamba2_plain_backward_matches_reference(batch, heads, s, groups,
                                                 final):
    args, dy, dh_final = _mamba2_inputs(batch, heads, s, groups, final, 1)
    exp = _mamba2_reference_grads(args, dy, dh_final)
    got = mamba2_scan_bwd(*map(_t, args), _t(dy), _t(dh_final))
    for name, gr, e in zip("x dt a b c d".split(), got, exp):
        _close(f"d{name}", gr, e)


@pytest.mark.parametrize("batch,heads,s,groups,final", MAMBA2_CASES)
def test_mamba2_kernel_algorithm_matches_reference(batch, heads, s, groups,
                                                   final):
    args, dy, dh_final = _mamba2_inputs(batch, heads, s, groups, final, 2)
    exp = _mamba2_reference_grads(args, dy, dh_final)
    x, dt, a, b, c, d = map(_t, args)
    rows, g = x.shape[0], b.shape[0]
    got = list(tref.mamba2_bwd_chunks(
        x, dt, a, expand_groups(b, rows), expand_groups(c, rows), d, _t(dy),
        _t(dh_final)))
    got[3], got[4] = sum_groups(got[3], g), sum_groups(got[4], g)
    for name, gr, e in zip("x dt a b c d".split(), got, exp):
        _close(f"d{name}", gr, e)


def test_mamba2_kernel_algorithm_where_the_twin_overflows():
    """Decays whose masked upper triangle overflows fp32 in the twin (its
    gradient is not finite there): the kernel's algorithm, whose exponents
    are all <= 0, against autograd of the fp32 per-step recurrence."""
    args, dy, dh_final = _mamba2_inputs(1, 2, 128, "per-head", True, 3,
                                        dt_shift=3.0)
    exp = _mamba2_reference_grads(args, dy, dh_final)
    assert not all(np.isfinite(e).all() for e in exp)
    x, dt, a, b, c, d = map(_t, args)
    per_step = tref.grads_of(
        lambda *t: tref.mamba2_ref(*t, return_final=True),
        (x, dt, a, b, c, d), _t(dy), _t(dh_final))
    got = tref.mamba2_bwd_chunks(x, dt, a, b, c, d, _t(dy), _t(dh_final))
    for name, gr, e in zip("x dt a b c d".split(), got, per_step):
        _close(f"d{name}", gr, e.numpy())


def _bf16_values(x):
    """``x`` rounded to the nearest bf16 values, kept as fp32 numpy: the
    inputs the CUDA kernel reads exactly."""
    return torch.from_numpy(x).to(torch.bfloat16).float().numpy()


def _bf16_inputs(args, dy):
    """x, B, C and dy at bf16 values; dt, a, D left in fp32."""
    return (tuple(_bf16_values(t) if i in (0, 3, 4) else t
                  for i, t in enumerate(args)), _bf16_values(dy))


@pytest.mark.parametrize("batch,heads,s,groups,final", MAMBA2_CASES)
def test_mamba2_tensor_core_operands_match_reference(batch, heads, s, groups,
                                                     final):
    """The kernel's algorithm with its tensor-core operands
    (``ref.mamba2_bwd_chunks(operands=bf16)``: bf16 inputs exact, each
    operand made in fp32 as a hi + lo pair of bf16 or three parts) against
    ``jax.vjp`` of the twin at realistic decays, on inputs at bf16 values:
    within 1e-4 of each gradient's max |value|, and not the fp32 result bit
    for bit."""
    args, dy, dh_final = _mamba2_inputs(batch, heads, s, groups, final, 11)
    args, dy = _bf16_inputs(args, dy)
    exp = _mamba2_reference_grads(args, dy, dh_final)
    x, dt, a, b, c, d = map(_t, args)
    rows, g = x.shape[0], b.shape[0]
    full = (x, dt, a, expand_groups(b, rows), expand_groups(c, rows), d,
            _t(dy), _t(dh_final))
    got = list(tref.mamba2_bwd_chunks(*full, operands=torch.bfloat16))
    exact = tref.mamba2_bwd_chunks(*full)
    assert any(not torch.equal(a_, e_) for a_, e_ in zip(got, exact))
    got[3], got[4] = sum_groups(got[3], g), sum_groups(got[4], g)
    for name, gr, e in zip("x dt a b c d".split(), got, exp):
        _close(f"d{name}", gr, e)


@pytest.mark.parametrize("s,final", [(200, True), (128, False)])
def test_mamba2_tensor_core_operands_at_served_widths(s, final):
    """The same at Zamba2's widths (dh = ds = 64, two heads of one B/C
    group) against autograd of the fp32 per-step recurrence: within 1e-4
    of each gradient's max |value|."""
    args, dy, dh_final = _mamba2_inputs(1, 2, s, "shared", final, 12, dh=64,
                                        ds=64)
    args, dy = _bf16_inputs(args, dy)
    x, dt, a, b, c, d = map(_t, args)
    rows = x.shape[0]
    full = (x, dt, a, expand_groups(b, rows), expand_groups(c, rows), d)
    per_step = tref.grads_of(
        lambda *t: tref.mamba2_ref(*t, return_final=True), full, _t(dy),
        _t(dh_final))
    got = tref.mamba2_bwd_chunks(*full, _t(dy), _t(dh_final),
                                 operands=torch.bfloat16)
    for name, gr, e in zip("x dt a b c d".split(), got, per_step):
        _close(f"d{name}", gr, e.numpy())


# dt's, a's and D's gradients (they reach A_log, dt_bias and D) against the
# per-step recurrence: within this share of their max |value|
SCALAR_GRAD_REL = 1e-5


@pytest.mark.parametrize("seed,final", [(1, True), (2, False)])
def test_mamba2_tensor_core_operands_keep_scalar_grads_near_fp32(seed,
                                                                 final):
    """The kernel's algorithm with its tensor-core operands at Zamba2's
    widths over 512 steps, its decays drawn as the card script draws them
    (dt a softplus of a unit normal less 1, a = -exp(0.5 z)): ddt, da and
    dD within ``SCALAR_GRAD_REL`` of their max |value| from autograd of the
    fp32 per-step recurrence.  dcum's terms cancel, so da is the gradient
    that an operand taken as a pair hi + lo instead of three parts moves
    (to 2.3e-5 and 1.9e-5 of max |da| at these seeds)."""
    rng = np.random.default_rng(seed)
    rows, s = 4, 512

    def bf16(*shape):
        return _t(_bf16_values(rng.normal(size=shape).astype(np.float32)))
    x = bf16(rows, s, 64)
    dt = torch.nn.functional.softplus(_t(rng.normal(size=(rows, s)).astype(
        np.float32)) - 1.0)
    a = -torch.exp(_t(rng.normal(size=(rows,)).astype(np.float32)) * 0.5)
    b, c = bf16(rows, s, 64), bf16(rows, s, 64)
    d = _t(rng.normal(size=(rows,)).astype(np.float32))
    dy = bf16(rows, s, 64)
    dh_final = (_t(rng.normal(size=(rows, 64, 64)).astype(np.float32))
                if final else None)
    full = (x, dt, a, b, c, d)
    per_step = tref.grads_of(
        lambda *t: tref.mamba2_ref(*t, return_final=True), full, dy, dh_final)
    got = tref.mamba2_bwd_chunks(*full, dy, dh_final, operands=torch.bfloat16)
    for name, i in (("ddt", 1), ("da", 2), ("dD", 5)):
        scale = per_step[i].abs().max().item()
        err = (got[i] - per_step[i]).abs().max().item()
        assert err <= SCALAR_GRAD_REL * scale, \
            f"{name}: max|err| {err} > {SCALAR_GRAD_REL} x {scale}"


def _rwkv6_inputs(rows, s, final, seed, dk=16, dv=8, spread=0.5,
                  shift=-1.0):
    rng = np.random.default_rng(seed)
    r, k = (rng.normal(size=(rows, s, dk)).astype(np.float32)
            for _ in range(2))
    v = rng.normal(size=(rows, s, dv)).astype(np.float32)
    logw = (-np.exp(rng.normal(size=(rows, s, dk)) * spread + shift)).astype(
        np.float32)
    u = (rng.normal(size=(rows, dk)) * 0.3).astype(np.float32)
    dy = rng.normal(size=(rows, s, dv)).astype(np.float32)
    dstate = (rng.normal(size=(rows, dk, dv)).astype(np.float32)
              if final else None)
    return (r, k, v, logw, u), dy, dstate


def _rwkv6_reference_grads(args, dy, dstate):
    (_, st), vjp = jax.vjp(
        lambda *t: jref.rwkv6_chunked_jnp(*t, return_final=True),
        *(jnp.asarray(t) for t in args))
    return [np.asarray(t) for t in vjp((
        jnp.asarray(dy), jnp.zeros_like(st) if dstate is None
        else jnp.asarray(dstate)))]


RWKV6_CASES = [  # rows, S, final-state gradient
    (3, 128, True),       # S a multiple of 64
    (2, 100, False),      # a ragged last chunk
    (2, 37, True),        # one short chunk
    (1, 200, True),       # four chunks of the kernel, seven of the twin
]


@pytest.mark.parametrize("rows,s,final", RWKV6_CASES)
def test_rwkv6_plain_backward_matches_reference(rows, s, final):
    args, dy, dstate = _rwkv6_inputs(rows, s, final, 4)
    exp = _rwkv6_reference_grads(args, dy, dstate)
    got = rwkv6_scan_bwd(*map(_t, args), _t(dy), _t(dstate))
    for name, gr, e in zip("r k v logw u".split(), got, exp):
        _close(f"d{name}", gr, e)


@pytest.mark.parametrize("rows,s,final", RWKV6_CASES)
def test_rwkv6_kernel_algorithm_matches_reference(rows, s, final):
    args, dy, dstate = _rwkv6_inputs(rows, s, final, 5)
    exp = _rwkv6_reference_grads(args, dy, dstate)
    got = tref.rwkv6_bwd_chunks(*map(_t, args), _t(dy), _t(dstate))
    for name, gr, e in zip("r k v logw u".split(), got, exp):
        _close(f"d{name}", gr, e)


def test_rwkv6_kernel_algorithm_survives_chunk_sums_below_minus_88():
    """Fast decays (a 32-step chunk of logw sums far below -88): the twin's
    gradient is not finite, the kernel's algorithm equals autograd of the
    fp32 per-step recurrence."""
    args, dy, dstate = _rwkv6_inputs(2, 100, True, 6, spread=1.5, shift=0.0)
    cum = np.cumsum(args[3][:, :32], axis=1)[:, -1]
    assert cum.min() < -88
    exp = _rwkv6_reference_grads(args, dy, dstate)
    assert not all(np.isfinite(e).all() for e in exp)
    targs = tuple(map(_t, args))
    per_step = tref.grads_of(
        lambda *t: tref.rwkv6_ref(*t, return_final=True), targs, _t(dy),
        _t(dstate))
    got = tref.rwkv6_bwd_chunks(*targs, _t(dy), _t(dstate))
    for name, gr, e in zip("r k v logw u".split(), got, per_step):
        _close(f"d{name}", gr, e.numpy())


@pytest.mark.parametrize("rows,s,final", RWKV6_CASES)
def test_rwkv6_subchunk_algorithm_matches_reference(rows, s, final):
    """The kernel's algorithm around its sub-chunk reference points
    (``sub=16``), in fp32, against ``jax.vjp`` of the twin."""
    args, dy, dstate = _rwkv6_inputs(rows, s, final, 13)
    exp = _rwkv6_reference_grads(args, dy, dstate)
    got = tref.rwkv6_bwd_chunks(*map(_t, args), _t(dy), _t(dstate), sub=16)
    for name, gr, e in zip("r k v logw u".split(), got, exp):
        _close(f"d{name}", gr, e)


def _rwkv6_bf16_inputs(args, dy):
    """r, k, v and dy at bf16 values; logw and u left in fp32."""
    return (tuple(_bf16_values(t) if i < 3 else t
                  for i, t in enumerate(args)), _bf16_values(dy))


@pytest.mark.parametrize("rows,s,final", RWKV6_CASES)
def test_rwkv6_tensor_core_operands_match_reference(rows, s, final):
    """The kernel's algorithm with its sub-chunk reference points and its
    tensor-core operands (``ref.rwkv6_bwd_chunks(sub=16,
    operands=bf16)``: bf16 inputs exact, each operand made in fp32 as a hi
    + lo pair of bf16) against ``jax.vjp`` of the twin at realistic
    decays, on inputs at bf16 values: within 1e-4 of each gradient's max
    |value|, and not the fp32 result bit for bit."""
    args, dy, dstate = _rwkv6_inputs(rows, s, final, 14)
    args, dy = _rwkv6_bf16_inputs(args, dy)
    exp = _rwkv6_reference_grads(args, dy, dstate)
    full = (*map(_t, args), _t(dy), _t(dstate))
    got = tref.rwkv6_bwd_chunks(*full, sub=16, operands=torch.bfloat16)
    exact = tref.rwkv6_bwd_chunks(*full, sub=16)
    assert any(not torch.equal(a_, e_) for a_, e_ in zip(got, exact))
    for name, gr, e in zip("r k v logw u".split(), got, exp):
        _close(f"d{name}", gr, e)


@pytest.mark.parametrize("operands", [None, torch.bfloat16])
def test_rwkv6_subchunk_algorithm_survives_chunk_sums_below_minus_88(
        operands):
    """Fast decays (a 32-step chunk of logw sums far below -88): the
    kernel's algorithm around its reference points, in fp32 and with its
    tensor-core operands, against autograd of the fp32 per-step
    recurrence, every gradient finite."""
    args, dy, dstate = _rwkv6_inputs(2, 100, True, 15, spread=1.5, shift=0.0)
    assert np.cumsum(args[3][:, :32], axis=1)[:, -1].min() < -88
    if operands is not None:
        args, dy = _rwkv6_bf16_inputs(args, dy)
    targs = tuple(map(_t, args))
    per_step = tref.grads_of(
        lambda *t: tref.rwkv6_ref(*t, return_final=True), targs, _t(dy),
        _t(dstate))
    got = tref.rwkv6_bwd_chunks(*targs, _t(dy), _t(dstate), sub=16,
                                operands=operands)
    for name, gr, e in zip("r k v logw u".split(), got, per_step):
        _close(f"d{name}", gr, e.numpy())


def _rwkv6_served_inputs(seed, final):
    """RWKV6-7B's widths (dk = dv = 64) over 512 steps, 4 rows: r, k, v,
    dy at bf16 values, u of scale 0.3, and logw made as the card script
    makes it from the model's decay LoRA (``-exp(tanh(x wa) wb)``, the
    reference's init scales), so one 32-step chunk sums to about -50."""
    rng = np.random.default_rng(seed)
    rows, s, d, lora = 4, 512, 64, 64

    def tn(*shape):
        return np.clip(rng.normal(size=shape), -2, 2)
    wa, wb = tn(rows * d, lora) * (rows * d) ** -0.5, tn(lora, rows * d) \
        * lora ** -0.5
    logw = -np.exp(np.tanh(rng.normal(size=(s, rows * d)) @ wa) @ wb)
    logw = logw.reshape(s, rows, d).transpose(1, 0, 2).astype(np.float32)
    r, k, v, dy = (_bf16_values(rng.normal(size=(rows, s, d)).astype(
        np.float32)) for _ in range(4))
    u = (rng.normal(size=(rows, d)) * 0.3).astype(np.float32)
    dstate = (rng.normal(size=(rows, d, d)).astype(np.float32) if final
              else None)
    return tuple(map(_t, (r, k, v, logw, u))), _t(dy), _t(dstate)


@pytest.mark.parametrize("seed,final", [(1, True), (2, False)])
def test_rwkv6_tensor_core_operands_keep_dlogw_and_du_near_fp32(
        seed, final, monkeypatch):
    """The kernel's algorithm with its tensor-core operands at RWKV6's
    widths over 512 steps: dlogw and du within ``SCALAR_GRAD_REL`` of their
    max |value| from autograd of the fp32 per-step recurrence (dlogw is a
    running sum over the steps of r drs - k dks).  Every operand made in
    fp32 is a hi + lo pair, none takes three parts: pairs keep dlogw within
    5.3e-6 and 6.5e-6 of its max at these seeds (three parts everywhere
    2.4e-6 and 3.6e-6, no one operand ahead of the others).  With one part
    (bf16 alone) in place of each pair dlogw lies outside the limit (3.5e-3
    and 4.7e-3)."""
    args, dy, dstate = _rwkv6_served_inputs(seed, final)
    per_step = tref.grads_of(
        lambda *t: tref.rwkv6_ref(*t, return_final=True), args, dy, dstate)

    def errs():
        got = tref.rwkv6_bwd_chunks(*args, dy, dstate, sub=16,
                                    operands=torch.bfloat16)
        return {name: ((got[i] - per_step[i]).abs().max()
                       / per_step[i].abs().max()).item()
                for name, i in (("dlogw", 3), ("du", 4))}
    for name, err in errs().items():
        assert err <= SCALAR_GRAD_REL, f"{name}: {err} > {SCALAR_GRAD_REL}"
    monkeypatch.setattr(tref, "split_pair",
                        lambda t, dtype=torch.bfloat16: t.to(dtype).float())
    assert errs()["dlogw"] > SCALAR_GRAD_REL


def test_scans_differentiate_through_their_autograd_functions():
    """``ops.mamba2_scan`` and ``ops.rwkv6_scan`` on inputs that need a
    gradient: autograd reaches every input through the wrappers' backward
    (the final state's gradient None when the state is not used, as in
    training), equal to the backward called with the same dy."""
    args, dy, _ = _mamba2_inputs(2, 2, 70, "shared", False, 7)
    leaves = [_t(t).requires_grad_(True) for t in args]
    y, _ = ops.mamba2_scan(*leaves)
    got = torch.autograd.grad(y, leaves, _t(dy))
    exp = mamba2_scan_bwd(*map(_t, args), _t(dy))
    for g_, e in zip(got, exp):
        torch.testing.assert_close(g_, e, rtol=0, atol=0)
    args, dy, _ = _rwkv6_inputs(2, 70, False, 8)
    leaves = [_t(t).requires_grad_(True) for t in args]
    y, _ = ops.rwkv6_scan(*leaves)
    got = torch.autograd.grad(y, leaves, _t(dy))
    exp = rwkv6_scan_bwd(*map(_t, args), _t(dy))
    for g_, e in zip(got, exp):
        torch.testing.assert_close(g_, e, rtol=0, atol=0)


def test_backward_wrappers_check_their_inputs():
    args, dy, _ = _mamba2_inputs(1, 2, 16, "per-head", False, 9)
    with pytest.raises(ValueError, match="dy"):
        mamba2_scan_bwd(*map(_t, args), _t(dy[:, :8]))
    with pytest.raises(ValueError, match="do not match"):
        mamba2_scan_bwd(*map(_t, args[:5]), _t(args[5][:1]), _t(dy))
    args, dy, _ = _rwkv6_inputs(2, 16, False, 10)
    with pytest.raises(ValueError, match="dstate"):
        rwkv6_scan_bwd(*map(_t, args), _t(dy), torch.zeros(2, 3, 3))
