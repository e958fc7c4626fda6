"""The port's kernels (plain versions on the CPU) against the JAX package.

The same numpy inputs go through the reference's functions (its jnp twins,
its oracles and its Pallas kernels in interpret mode) and through the port's
``repro_torch.kernels.ops``, which on CPU tensors runs each kernel's plain
PyTorch version.  Packing is held bit-exact; attention within fp32
tolerances.  The CUDA kernels themselves run only on a card
(``tests/test_torch_gpu.py`` and ``chip_smoke.py`` hold them against the
plain versions there).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import collectives as jcl
from repro.kernels import ref as jref
from repro.kernels.dispatch_pack import dispatch_pack as pallas_pack
from repro.kernels.flash_attention import flash_attention as pallas_attention
from repro.models.layers import flash_attention_jnp
from repro_torch.kernels import _build, ops

# fp32 attention: the port's dense softmax vs the reference's dense,
# streaming and Pallas forms differ only in summation order
ATTN_TOL = dict(atol=2e-5, rtol=2e-5)


def _bits(x) -> np.ndarray:
    """Raw bits of a float array (bf16 and fp32 compared bit for bit)."""
    if isinstance(x, torch.Tensor):
        x = x.contiguous()
        ints = torch.int16 if x.element_size() == 2 else torch.int32
        return x.view(ints).numpy()
    x = np.asarray(x)
    return x.view(np.int16 if x.dtype.itemsize == 2 else np.int32)


def _to_torch(x: np.ndarray, dtype) -> torch.Tensor:
    return torch.from_numpy(np.asarray(x, np.float32)).to(dtype)


# ---------------------------------------------------------------------------
# dispatch pack: bit-exact against pack_by_bitmap, pack_ref and Pallas
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,h,d,c,br", [
    (32, 16, 4, 16, 8),
    (17, 8, 8, 3, 4),        # padding + overflow
    (64, 128, 16, 64, 16),
    (8, 4, 31, 2, 8),        # 31 destinations
])
def test_pack_bit_exact(n, h, d, c, br, dtype):
    rng = np.random.default_rng(n + d * 3)
    tokens = rng.normal(size=(n, h)).astype(np.float32)
    bitmap = rng.integers(0, 1 << d, size=n).astype(np.int32)
    valid = rng.random(n) > 0.25
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = getattr(torch, dtype)
    jtok = jnp.asarray(tokens, jdt)
    jbits, jvalid = jnp.asarray(bitmap), jnp.asarray(valid)
    launches = ops.dispatch_pack.launches
    got_t, got_i = ops.dispatch_pack(
        _to_torch(tokens, tdt), torch.from_numpy(bitmap),
        torch.from_numpy(valid), num_dests=d, capacity=c)
    assert ops.dispatch_pack.launches == launches    # CPU: plain version
    assert got_t.dtype == tdt and got_i.dtype == torch.int32
    refs = [jcl.pack_by_bitmap(jtok, jbits, jvalid, d, c),
            jref.pack_ref(jtok, jbits, jvalid, d, c),
            pallas_pack(jtok, jbits, jvalid, num_dests=d, capacity=c,
                        block_rows=br, interpret=True)]
    for exp_t, exp_i in refs:
        np.testing.assert_array_equal(got_i.numpy(), np.asarray(exp_i))
        np.testing.assert_array_equal(_bits(got_t), _bits(exp_t))


# ---------------------------------------------------------------------------
# flash attention: grouped kv, fp32
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", [
    dict(s=64, t=64, causal=True),
    dict(s=80, t=80, causal=False),
    dict(s=128, t=128, causal=True, window=16),
    dict(s=128, t=128, causal=True, window=64),
    dict(s=64, t=64, causal=True, softcap=30.0),
    dict(s=40, t=72, causal=False),                 # cross lengths
    dict(s=96, t=96, causal=True, window=24, softcap=20.0),
    dict(s=1, t=77, causal=False),                  # a decode step's cross
], ids=["causal", "noncausal", "window16", "window64", "softcap", "cross",
        "all-masks", "q1-cross"])
def test_attention_matches_reference(case):
    b, hq, g, d = 2, 4, 2, 32
    s, t = case["s"], case["t"]
    kw = {k: case.get(k) for k in ("causal", "window", "softcap")}
    rng = np.random.default_rng(s * 7 + t)
    q = rng.normal(size=(b, hq, s, d)).astype(np.float32)
    k = rng.normal(size=(b, g, t, d)).astype(np.float32)
    v = rng.normal(size=(b, g, t, d)).astype(np.float32)
    launches = ops.flash_attention.launches
    got = ops.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), **kw).numpy()
    assert ops.flash_attention.launches == launches
    rep = hq // g
    kx = np.repeat(k, rep, axis=1).reshape(b * hq, t, d)
    vx = np.repeat(v, rep, axis=1).reshape(b * hq, t, d)
    qx = q.reshape(b * hq, s, d)
    dense = jref.attention_ref(jnp.asarray(qx), jnp.asarray(kx),
                               jnp.asarray(vx), **kw)
    pallas = pallas_attention(jnp.asarray(qx), jnp.asarray(kx),
                              jnp.asarray(vx), block_q=32, block_k=32,
                              interpret=True, **kw)
    streaming = flash_attention_jnp(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), block_k=32, **kw)
    for exp in (dense, pallas):
        np.testing.assert_allclose(got.reshape(b * hq, s, d),
                                   np.asarray(exp), **ATTN_TOL)
    np.testing.assert_allclose(got, np.asarray(streaming), **ATTN_TOL)


@pytest.mark.parametrize("kv_len,window,softcap", [
    (None, None, None), (9, None, None), (12, 4, None), (16, None, 30.0)])
def test_decode_attention_matches_reference(kv_len, window, softcap):
    b, h, g, t, d = 2, 4, 2, 16, 32
    rng = np.random.default_rng(t + (kv_len or 0))
    q = rng.normal(size=(b, h, d)).astype(np.float32)
    k = rng.normal(size=(b, t, g, d)).astype(np.float32)
    v = rng.normal(size=(b, t, g, d)).astype(np.float32)
    got = ops.decode_attention(torch.from_numpy(q), torch.from_numpy(k),
                               torch.from_numpy(v), kv_len, window=window,
                               softcap=softcap)
    exp = jref.decode_attention_ref(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), kv_len, window=window,
                                    softcap=softcap)
    np.testing.assert_allclose(got.numpy(), np.asarray(exp), **ATTN_TOL)


# ---------------------------------------------------------------------------
# wrapper contract: device picks the path, no fallback
# ---------------------------------------------------------------------------

class _Elsewhere(torch.Tensor):
    """A tensor on a device that has no kernel and no plain version (XLA's
    device type; the meta device is the dry run's, which the wrappers
    take): it carries a shape and a dtype and runs no op."""

    @staticmethod
    def __new__(cls, shape, dtype=torch.float32):
        return torch.Tensor._make_wrapper_subclass(
            cls, shape, dtype=dtype, device=torch.device("xla"))

    @classmethod
    def __torch_dispatch__(cls, func, types, args=(), kwargs=None):
        raise NotImplementedError(func)


def test_wrappers_refuse_devices_without_a_kernel():
    tok = _Elsewhere((4, 8))
    bits = _Elsewhere((4,), torch.int32)
    valid = _Elsewhere((4,), torch.bool)
    with pytest.raises(ValueError, match="no kernel"):
        ops.dispatch_pack(tok, bits, valid, num_dests=2, capacity=2)
    q = _Elsewhere((1, 2, 4, 64), torch.bfloat16)
    with pytest.raises(ValueError, match="no kernel"):
        ops.flash_attention(q, q, q)


def test_wrappers_check_arguments():
    tok = torch.zeros((4, 8))
    with pytest.raises(ValueError, match="num_dests"):
        ops.dispatch_pack(tok, torch.zeros(4, dtype=torch.int32),
                          torch.ones(4, dtype=torch.bool), num_dests=32,
                          capacity=2)
    with pytest.raises(ValueError, match="several devices"):
        ops.dispatch_pack(tok, torch.zeros(4, dtype=torch.int32,
                                           device="meta"),
                          torch.ones(4, dtype=torch.bool), num_dests=2,
                          capacity=2)
    q = torch.zeros((1, 4, 8, 64))
    with pytest.raises(ValueError, match="do not match"):
        ops.flash_attention(q, torch.zeros((1, 3, 8, 64)),
                            torch.zeros((1, 3, 8, 64)))
    with pytest.raises(ValueError, match="window"):
        ops.flash_attention(q, q, q, window=0)


def test_build_raises_without_a_compiler(monkeypatch, tmp_path):
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "_nvcc", lambda: (_ for _ in ()).throw(
        RuntimeError("nvcc not found: the CUDA kernels cannot be built")))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build(("dispatch_pack",))
    assert not list(tmp_path.iterdir())


def test_library_names_follow_the_source(monkeypatch, tmp_path):
    a = _build.library_path("dispatch_pack")
    b = _build.library_path("flash_attention")
    assert a.parent == b.parent == _build.BUILD_DIR
    assert a.name.startswith("libdispatch_pack-") and a.suffix == ".so"
    assert a != b
    for name in _build.KERNELS:
        for path in _build.sources(name):
            assert path.is_file()
    # an edited header, even one included through another header, renames
    # every library that includes it
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    (tmp_path / "k.cu").write_text('#include <cuda.h>\n#include "a.cuh"\n')
    (tmp_path / "a.cuh").write_text('#pragma once\n#include "b.cuh"\n')
    (tmp_path / "b.cuh").write_text("// v1\n")
    (tmp_path / "other.cu").write_text("// no local header\n")
    assert [p.name for p in _build.sources("k")] == ["k.cu", "a.cuh", "b.cuh"]
    before = _build.library_path("k"), _build.library_path("other")
    (tmp_path / "b.cuh").write_text("// v2\n")
    after = _build.library_path("k"), _build.library_path("other")
    assert before[0] != after[0] and before[1] == after[1]
