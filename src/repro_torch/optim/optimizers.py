"""Optimizers on dicts of tensors: AdamW, Adafactor, Lion, SGD.

Port of ``src/repro/optim/optimizers.py``.  An :class:`Optimizer` keeps the
reference's functional shape over a parameter dict ``{name: tensor}``
(``dict(module.named_parameters())``):

    state = opt.init(params)
    updates, state = opt.update(grads, state, params, step)
    params = apply_updates(params, updates)

and adds ``opt.apply(grads, state, params, step)``, the same arithmetic
written in place: the parameters and the state tensors are overwritten,
nothing of a parameter's size is allocated.  The elementwise optimizers
(AdamW, Lion, SGD) run it over flat slices of ``CHUNK`` elements, so their
fp32 temporaries stay a slice's size: one DBRX expert weight [16, 6144,
10752] is 1.06 G elements, 4.2 GB a temporary in fp32, and the AdamW update
makes about six.  An update is elementwise, so the slicing changes no bit.

The arithmetic is the reference's, operation for operation, in fp32:
moments are stored in ``opt_dtype`` (the parameters' dtype when None) and
read back to fp32 at each step; an update is applied as ``p + u`` in the
parameter's dtype.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import torch

Tree = dict          # {name: tensor}

CHUNK = 1 << 25      # elements of one slice of the in-place update


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable[[Tree], Any]
    update: Callable[..., tuple[Tree, Any]]   # (grads, state, params, step)
    apply: Callable[..., None]                # (grads, state, params, step)


def apply_updates(params: Tree, updates: Tree) -> Tree:
    return {k: p + updates[k].to(p.dtype) for k, p in params.items()}


def tree_zeros_like(params: Tree, dtype=None) -> Tree:
    return {k: torch.zeros_like(p, dtype=dtype or p.dtype)
            for k, p in params.items()}


def _slices(t: torch.Tensor):
    """Flat slices of at most ``CHUNK`` elements of a contiguous tensor
    (views: writes to them land in ``t``)."""
    flat = t.view(-1)
    for lo in range(0, flat.numel(), CHUNK):
        yield flat[lo:lo + CHUNK]


def global_norm(tree: Tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in fp32 (a 0-d tensor on
    the leaves' device), summed a slice at a time."""
    total = None
    for x in tree.values():
        for part in _slices(x.reshape(-1)):
            sq = torch.sum(torch.square(part.float()))
            total = sq if total is None else total + sq
    return torch.sqrt(total)


def _clip_scale(norm: torch.Tensor, max_norm: float) -> torch.Tensor:
    return torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)


def clip_by_global_norm(grads: Tree, max_norm: float):
    """(grads scaled to a global norm of at most ``max_norm``, the norm
    before clipping)."""
    norm = global_norm(grads)
    scale = _clip_scale(norm, max_norm)
    return {k: (g.float() * scale).to(g.dtype)
            for k, g in grads.items()}, norm


def clip_by_global_norm_(grads: Tree, max_norm: float,
                         norm: torch.Tensor | None = None) -> torch.Tensor:
    """:func:`clip_by_global_norm` in place, a slice at a time; returns the
    norm before clipping.  ``norm``: the norm to clip by, when the tree is
    one rank's part of a larger one (over ranks every rank must clip its
    part by the global gradient's norm); :func:`global_norm` of ``grads``
    when None."""
    if norm is None:
        norm = global_norm(grads)
    scale = _clip_scale(norm, max_norm)
    for g in grads.values():
        for part in _slices(g):
            part.copy_(part.float() * scale)
    return norm


def cosine_schedule(base_lr: float, warmup: int, total: int,
                    min_frac: float = 0.1):
    def lr(step):
        step = torch.as_tensor(step, dtype=torch.float32)
        warm = base_lr * step / max(warmup, 1)
        prog = torch.clamp((step - warmup) / max(total - warmup, 1),
                           0.0, 1.0)
        cos = base_lr * (min_frac + (1 - min_frac)
                         * 0.5 * (1 + torch.cos(math.pi * prog)))
        return torch.where(step < warmup, warm, cos)
    return lr


def _optimizer(init, scalars, leaf_state, leaf_update, *,
               elementwise: bool) -> Optimizer:
    """An :class:`Optimizer` from its per-leaf parts: ``scalars(step)``
    (the step's learning rate and corrections), ``leaf_state(state, name)``
    (the leaf's state tensors as a dict; the state's own tensors), and
    ``leaf_update(g, s, p, scalars) -> (u, new s)``."""

    def update(grads, state, params, step):
        sc = scalars(step)
        new_state = _empty_like_state(state)
        updates = {}
        for name, g in grads.items():
            u, s = leaf_update(g, leaf_state(state, name), params[name], sc)
            updates[name] = u
            for key, t in s.items():
                _put(new_state, state, name, key, t)
        return updates, new_state

    def apply(grads, state, params, step):
        sc = scalars(step)
        for name, g in grads.items():
            p, s = params[name], leaf_state(state, name)
            if not elementwise:
                u, new = leaf_update(g, s, p, sc)
                for key, t in new.items():
                    s[key].copy_(t)
                p.add_(u.to(p.dtype))
                continue
            parts = zip(_slices(g.reshape(-1)), _slices(p),
                        *(_slices(t) for t in s.values()))
            for gs, ps, *states in parts:
                u, new = leaf_update(gs, dict(zip(s, states)), ps, sc)
                for dst, t in zip(states, new.values()):
                    dst.copy_(t)
                ps.add_(u.to(ps.dtype))

    return Optimizer(init, update, apply)


def _empty_like_state(state):
    """A state tree of the same nesting with empty leaf dicts."""
    return {k: {} for k in state} if isinstance(state, dict) else {}


def _put(new_state, state, name, key, t):
    """Set leaf ``name``'s state ``key`` in a tree nested as ``state``:
    ``{key: {name: t}}`` (AdamW, Lion, SGD) or ``{name: {key: t}}``
    (Adafactor)."""
    if key in state:
        new_state[key][name] = t
    else:
        new_state[name][key] = t


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------

def adamw(lr=1e-3, b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1,
          opt_dtype=None) -> Optimizer:
    lr_fn = lr if callable(lr) else (lambda _: lr)

    def init(params):
        return {"m": tree_zeros_like(params, opt_dtype),
                "v": tree_zeros_like(params, opt_dtype)}

    def scalars(step):
        step = torch.as_tensor(step, dtype=torch.float32) + 1.0
        return lr_fn(step), 1 - b1 ** step, 1 - b2 ** step

    def upd(g, s, p, sc):
        lr_t, bc1, bc2 = sc
        m, v = s["m"], s["v"]
        gf = g.float()
        m_new = b1 * m.float() + (1 - b1) * gf
        v_new = b2 * v.float() + (1 - b2) * gf * gf
        mhat = m_new / bc1
        vhat = v_new / bc2
        u = -lr_t * (mhat / (torch.sqrt(vhat) + eps)
                     + weight_decay * p.float())
        return u, {"m": m_new.to(m.dtype), "v": v_new.to(v.dtype)}

    return _optimizer(init, scalars,
                      lambda st, n: {"m": st["m"][n], "v": st["v"][n]}, upd,
                      elementwise=True)


# ---------------------------------------------------------------------------
# Adafactor (factored second moment)
# ---------------------------------------------------------------------------

def adafactor(lr=1e-2, decay=0.8, eps=1e-30, clip_threshold=1.0,
              weight_decay=0.0) -> Optimizer:
    lr_fn = lr if callable(lr) else (lambda _: lr)

    def init(params):
        def per_leaf(p):
            if p.dim() >= 2:
                return {"vr": torch.zeros(p.shape[:-1], dtype=torch.float32,
                                          device=p.device),
                        "vc": torch.zeros(p.shape[:-2] + p.shape[-1:],
                                          dtype=torch.float32,
                                          device=p.device)}
            return {"v": torch.zeros_like(p, dtype=torch.float32)}
        return {k: per_leaf(p) for k, p in params.items()}

    def scalars(step):
        step = torch.as_tensor(step, dtype=torch.float32) + 1.0
        return lr_fn(step), 1.0 - step ** (-decay)

    def upd(g, s, p, sc):
        lr_t, rho = sc
        gf = g.float()
        g2 = gf * gf + eps
        if "vr" in s:
            vr = rho * s["vr"] + (1 - rho) * torch.mean(g2, dim=-1)
            vc = rho * s["vc"] + (1 - rho) * torch.mean(g2, dim=-2)
            denom = torch.clamp(torch.mean(vr, dim=-1, keepdim=True),
                                min=eps)
            vhat = (vr[..., None] / denom[..., None]) * vc[..., None, :]
            u = gf / torch.sqrt(vhat + eps)
            new_s = {"vr": vr, "vc": vc}
        else:
            v = rho * s["v"] + (1 - rho) * g2
            u = gf / torch.sqrt(v + eps)
            new_s = {"v": v}
        rms = torch.sqrt(torch.mean(u * u))
        u = u / torch.clamp(rms / clip_threshold, min=1.0)
        u = -lr_t * (u + weight_decay * p.float())
        return u, new_s

    return _optimizer(init, scalars, lambda st, n: st[n], upd,
                      elementwise=False)


# ---------------------------------------------------------------------------
# Lion
# ---------------------------------------------------------------------------

def lion(lr=1e-4, b1=0.9, b2=0.99, weight_decay=0.1,
         opt_dtype=None) -> Optimizer:
    lr_fn = lr if callable(lr) else (lambda _: lr)

    def init(params):
        return {"m": tree_zeros_like(params, opt_dtype)}

    def scalars(step):
        return (lr_fn(torch.as_tensor(step, dtype=torch.float32)),)

    def upd(g, s, p, sc):
        (lr_t,) = sc
        m = s["m"]
        gf = g.float()
        m32 = m.float()
        u = -lr_t * (torch.sign(b1 * m32 + (1 - b1) * gf)
                     + weight_decay * p.float())
        m_new = b2 * m32 + (1 - b2) * gf
        return u, {"m": m_new.to(m.dtype)}

    return _optimizer(init, scalars, lambda st, n: {"m": st["m"][n]}, upd,
                      elementwise=True)


# ---------------------------------------------------------------------------
# SGD (baseline / tests)
# ---------------------------------------------------------------------------

def sgd(lr=1e-2, momentum=0.0) -> Optimizer:
    lr_fn = lr if callable(lr) else (lambda _: lr)

    def init(params):
        if momentum:
            return {"m": tree_zeros_like(params, torch.float32)}
        return {}

    def scalars(step):
        return (lr_fn(torch.as_tensor(step, dtype=torch.float32)),)

    def upd(g, s, p, sc):
        (lr_t,) = sc
        if momentum:
            m = momentum * s["m"] + g.float()
            return -lr_t * m, {"m": m}
        return -lr_t * g.float(), {}

    return _optimizer(
        init, scalars,
        lambda st, n: {"m": st["m"][n]} if momentum else {}, upd,
        elementwise=True)


def chain_clip(opt: Optimizer, max_norm: float) -> Optimizer:
    """Wrap an optimizer with global-norm gradient clipping (``apply``
    clips the gradients in place)."""
    def update(grads, state, params, step):
        grads, _ = clip_by_global_norm(grads, max_norm)
        return opt.update(grads, state, params, step)

    def apply(grads, state, params, step):
        clip_by_global_norm_(grads, max_norm)
        opt.apply(grads, state, params, step)
    return Optimizer(opt.init, update, apply)
