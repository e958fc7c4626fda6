"""Mamba2 (SSD) chunked scan: the wrapper of ``csrc/mamba2_scan.cu``.

Replaces the Pallas TPU kernel ``src/repro/kernels/mamba2_scan.py``
(``mamba2_scan`` / ``_mamba2_kernel``), the sequence mixer of every Zamba2
Mamba2 block at prefill (``models/ssm.py::mamba2_block_prefill``).  Unlike
the TPU kernel it also returns the final state, which the prefill hands to
decode (the reference's serving path runs its chunked jnp twin for that).

What bounds it on an H100: bytes.  At the Zamba2-7B prefill shape (x
[448, 512, 64] bf16, dt fp32, B/C one group of [4, 512, 64]) it reads x, dt
and B/C once and writes y and the final state, about 68 MB (0.020 ms at
3.35 TB/s), against 7.5 GFLOP of chunk products.

Design: a block owns two heads of one sequence (one where the heads of a
group do not pair up), one warpgroup each, and walks their 64-step chunks
with the [ds, dh] states in shared memory; the two heads share each
chunk's B/C loads, which arrive with ``cp.async`` into a double buffer
while the previous chunk computes.  The four chunk products are ``wgmma``
m64n64k16 on the tensor cores; the operands made in fp32 (decayed C B^T,
weighted B, the state) enter as bf16 hi + lo pairs, so the result keeps
fp32 accuracy up to the bf16 rounding of y (see the ``.cu``).  Two blocks
per SM run Zamba2's 448 rows in one wave.

The gradient (training): when an input needs one, :func:`mamba2_scan` runs
under a ``torch.autograd.Function`` whose backward is
:func:`mamba2_scan_bwd`, the ``mamba2_scan_bwd`` kernel of the same source,
shaped like the forward: a warpgroup a head, two heads of a group a block,
``wgmma`` products with the operands made in fp32 as bf16 hi + lo pairs
(three parts for the weighted B of the states' recompute and the state's
gradient in x g^T, which reach dt's and A's gradients through sums whose
terms cancel).  A
forward walk recomputes each chunk's starting state and ``dy h0^T`` into a
scratch, then a reverse walk carries the state's gradient in shared memory
(see the ``.cu``).  dB and dC leave as one fp32 partial a block (the sum of
its pair of heads, or its one head), which the wrapper sums over each
group's partials in a fixed order: the transpose of the broadcast of B/C
to the heads.

For tensors on the CPU each wrapper runs its plain version (the chunked
scan of :func:`repro_torch.kernels.ref.mamba2_chunked`, and its gradient
:func:`~repro_torch.kernels.ref.mamba2_chunked_bwd`); for CUDA tensors it
launches the kernel (bf16 x/B/C, dh and ds multiples of 8 up to 64), or
raises.  ``mamba2_scan.launches`` and ``mamba2_scan_bwd.launches`` count
kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, cost
from repro_torch.kernels.ref import mamba2_chunked, mamba2_chunked_bwd

NAME = "mamba2_scan"
CHUNK = 64          # the kernel's chunk length, and the plain version's
MAX_DIM = 64        # dh, ds


def _lib() -> ctypes.CDLL:
    lib = _build.library(NAME)
    fn = lib.mamba2_scan
    if fn.argtypes is None:
        P, I = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [P] * 8 + [I] * 5 + [P]
        fn.restype = ctypes.c_int
        bwd = lib.mamba2_scan_bwd
        bwd.argtypes = [P] * 15 + [I] * 5 + [P]
        bwd.restype = ctypes.c_int
    return lib


def expand_groups(t: torch.Tensor, rows: int) -> torch.Tensor:
    """[G, S, ds] -> [rows, S, ds]: row r reads group r // (rows // G)."""
    return t.repeat_interleave(rows // t.shape[0], dim=0)


def mamba2_scan_plain(x, dt, a, b, c, d):
    """Plain version: groups repeated per head, then the chunked scan in
    fp32.  Returns (y in x's dtype, final state fp32)."""
    rows = x.shape[0]
    return mamba2_chunked(x, dt, a, expand_groups(b, rows),
                          expand_groups(c, rows), d, chunk=CHUNK,
                          return_final=True)


def mamba2_scan(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                b: torch.Tensor, c: torch.Tensor, d: torch.Tensor):
    """Chunked SSD scan with its final state.

    x [BH, S, dh]; dt [BH, S] (post-softplus); a, d [BH] fp32; b, c
    [G, S, ds] with BH % G == 0, row bh reading group bh // (BH // G)
    (G = BH: one group per head; G = batch: Mamba2's single group shared
    by every head).  Returns (y [BH, S, dh] in x's dtype, h [BH, ds, dh]
    fp32).  Differentiable in every input.
    """
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, dt, a, b, c, d)):
        return _Mamba2Scan.apply(x, dt, a, b, c, d)
    return _scan(x, dt, a, b, c, d)


class _Mamba2Scan(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dt, a, b, c, d):
        y, h = _scan(x, dt, a, b, c, d)
        ctx.save_for_backward(x, dt, a, b, c, d)
        ctx.set_materialize_grads(False)
        return y, h

    @staticmethod
    def backward(ctx, dy, dh):
        x, dt, a, b, c, d = ctx.saved_tensors
        dy = torch.zeros_like(x) if dy is None else dy.contiguous()
        return mamba2_scan_bwd(x, dt, a, b, c, d, dy,
                               None if dh is None else dh.contiguous())


def _check(name, x, dt, a, b, c, d):
    """Raise on inputs that do not match or that the kernel does not take
    (for CUDA tensors)."""
    rows, s, dh = x.shape
    g, ds = b.shape[0], b.shape[-1]
    if (dt.shape != (rows, s) or a.shape != (rows,) or d.shape != (rows,)
            or b.shape != (g, s, ds) or c.shape != b.shape or rows % g):
        raise ValueError(f"{name}: shapes x {tuple(x.shape)}, dt "
                         f"{tuple(dt.shape)}, a {tuple(a.shape)}, b "
                         f"{tuple(b.shape)}, c {tuple(c.shape)}, d "
                         f"{tuple(d.shape)} do not match")
    devices = {t.device for t in (x, dt, a, b, c, d)}
    if len(devices) != 1:
        raise ValueError(f"{name}: tensors on several devices "
                         f"{sorted(map(str, devices))}")
    if x.device.type == "cpu":
        return
    if x.device.type not in ("cuda", "meta"):
        raise ValueError(f"{name}: no kernel for device {x.device}")
    if not x.dtype == b.dtype == c.dtype == torch.bfloat16 or not (
            dt.dtype == a.dtype == d.dtype == torch.float32):
        raise TypeError(f"{name}: the kernel takes bf16 x/b/c and fp32 "
                        f"dt/a/d, got {x.dtype}, {b.dtype}, {c.dtype}, "
                        f"{dt.dtype}, {a.dtype}, {d.dtype}")
    if not (dh <= MAX_DIM and ds <= MAX_DIM and dh % 8 == ds % 8 == 0):
        raise ValueError(f"{name}: dh {dh} and ds {ds} must be "
                         f"multiples of 8 up to {MAX_DIM}")
    if not all(t.is_contiguous() for t in (x, dt, a, b, c, d)):
        raise ValueError(f"{name}: inputs must be contiguous")


def _scan(x, dt, a, b, c, d):
    _check("mamba2_scan", x, dt, a, b, c, d)
    if x.device.type == "cpu":
        return mamba2_scan_plain(x, dt, a, b, c, d)
    rows, s, dh = x.shape
    g, ds = b.shape[0], b.shape[-1]
    y = torch.empty_like(x)
    h = torch.empty((rows, ds, dh), dtype=torch.float32, device=x.device)
    if x.device.type == "meta":
        tri = CHUNK * (CHUNK + 1) // 2      # causal pairs of a chunk
        cost.record(NAME, 2 * rows * -(-s // CHUNK) * (
            tri * ds + tri * dh + 2 * CHUNK * ds * dh),
            2 * x.numel() * x.element_size() + 4 * dt.numel() + 4 * (
                a.numel() + d.numel()) + (b.numel() + c.numel())
            * b.element_size() + 4 * rows * ds * dh)
        return y, h
    lib = _lib()
    code = lib.mamba2_scan(
        x.data_ptr(), dt.data_ptr(), a.data_ptr(), b.data_ptr(),
        c.data_ptr(), d.data_ptr(), y.data_ptr(), h.data_ptr(), rows, s, dh,
        ds, rows // g, _build.stream(x.device))
    _build.check(lib, NAME, code)
    mamba2_scan.launches += 1
    return y, h


mamba2_scan.launches = 0


def block_heads(heads_per_group: int) -> int:
    """Heads a block of the backward kernel owns: two of one group where
    the group's heads pair up, else one."""
    return 2 if heads_per_group % 2 == 0 else 1


def sum_groups(t: torch.Tensor, groups: int) -> torch.Tensor:
    """[n, S, ds] partials, n a multiple of ``groups`` -> [groups, S, ds]:
    each group the sum of its n / groups partials in order (over rows, the
    transpose of :func:`expand_groups`)."""
    rows = t.shape[0]
    if groups == rows:
        return t
    return t.reshape(groups, rows // groups, *t.shape[1:]).sum(dim=1)


def mamba2_scan_bwd_plain(x, dt, a, b, c, d, dy, dh_final=None):
    """Plain version: the gradient of the chunked scan by autograd, with
    b and c repeated per head and their gradients summed back over each
    group's rows.  Returns fp32 (dx, ddt, da, db, dc, dd)."""
    rows, g = x.shape[0], b.shape[0]
    dx, ddt, da, db, dc, dd = mamba2_chunked_bwd(
        x, dt, a, expand_groups(b, rows), expand_groups(c, rows), d, dy,
        dh_final, chunk=CHUNK)
    return dx, ddt, da, sum_groups(db, g), sum_groups(dc, g), dd


def mamba2_scan_bwd(x, dt, a, b, c, d, dy, dh_final=None):
    """The backward of :func:`mamba2_scan`: from its inputs, the gradient
    ``dy`` [BH, S, dh] of y (x's dtype) and that of the final state
    ``dh_final`` [BH, ds, dh] fp32 (None: zero), returns (dx, ddt, da, db,
    dc, dd) in the shapes and dtypes of x, dt, a, b, c, d."""
    _check("mamba2_scan_bwd", x, dt, a, b, c, d)
    rows, s, dh = x.shape
    g, ds = b.shape[0], b.shape[-1]
    if dy.shape != x.shape or (dh_final is not None and dh_final.shape != (
            rows, ds, dh)):
        raise ValueError(f"mamba2_scan_bwd: dy {tuple(dy.shape)} and "
                         f"dh_final {None if dh_final is None else tuple(dh_final.shape)} "
                         f"do not match x {tuple(x.shape)}")
    if x.device.type == "cpu":
        grads = mamba2_scan_bwd_plain(x, dt, a, b, c, d, dy, dh_final)
        return tuple(gr.to(t.dtype) for gr, t in
                     zip(grads, (x, dt, a, b, c, d)))
    if x.device.type == "meta":
        # x, dy, dx; dt, ddt fp32; B, C and their gradients; a, d, da, dd;
        # 10 products of a chunk x ds x dh a chunk and row
        cost.record("mamba2_scan_bwd", 10 * 2 * CHUNK * ds * dh * rows
                    * -(-s // CHUNK), 3 * x.numel() * x.element_size()
                    + 8 * rows * s + 4 * g * s * ds * b.element_size()
                    + 16 * rows)
        return tuple(torch.empty_like(t) for t in (x, dt, a, b, c, d))
    if dy.device != x.device or dy.dtype != x.dtype or not dy.is_contiguous() \
            or (dh_final is not None and (
                dh_final.device != x.device or dh_final.dtype != torch.float32
                or not dh_final.is_contiguous())):
        raise ValueError("mamba2_scan_bwd: the kernel takes a contiguous dy "
                         "in x's dtype and a contiguous fp32 dh_final on "
                         "x's device")
    f32 = dict(dtype=torch.float32, device=x.device)
    dx = torch.empty_like(x)
    ddt = torch.empty((rows, s), **f32)
    da = torch.empty((rows,), **f32)
    dd = torch.empty((rows,), **f32)
    # dB and dC leave as one partial a block: the sum of a pair of heads of
    # one group where the group's heads pair up, else of one head
    parts = rows // block_heads(rows // g)
    db_parts = torch.empty((parts, s, ds), **f32)
    dc_parts = torch.empty((parts, s, ds), **f32)
    # each row's state at the start of each chunk and the final state, then
    # each chunk's dy h0^T, which the kernel's first walk writes and its
    # reverse walk reads (64 x 64 fp32 tiles)
    chunks = -(-s // CHUNK)
    scratch = torch.empty((rows, 2 * chunks + 1, CHUNK * MAX_DIM), **f32)
    lib = _lib()
    code = lib.mamba2_scan_bwd(
        x.data_ptr(), dt.data_ptr(), a.data_ptr(), b.data_ptr(),
        c.data_ptr(), d.data_ptr(), dy.data_ptr(),
        None if dh_final is None else dh_final.data_ptr(), dx.data_ptr(),
        ddt.data_ptr(), da.data_ptr(), dd.data_ptr(), db_parts.data_ptr(),
        dc_parts.data_ptr(), scratch.data_ptr(), rows, s, dh, ds, rows // g,
        _build.stream(x.device))
    _build.check(lib, "mamba2_scan_bwd", code)
    mamba2_scan_bwd.launches += 1
    return (dx, ddt, da, sum_groups(db_parts, g).to(b.dtype),
            sum_groups(dc_parts, g).to(c.dtype), dd)


mamba2_scan_bwd.launches = 0

