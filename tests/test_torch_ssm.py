"""The port's Mamba2 scan and Zamba2 serving path against the JAX package.

The same numpy inputs go through the reference (its Pallas kernel in
interpret mode, its per-step oracle, its chunked jnp twin, its model and
serving engine) and through the port on the CPU, where
``ops.mamba2_scan`` runs its plain version.  Tolerances are the reference
kernel tests' (fp32 1e-4, bf16 5e-2) and, for logits, ``test_torch_moe``'s.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jax_get_config
from repro.kernels import ref as jref
from repro.kernels.mamba2_scan import mamba2_scan as pallas_mamba2
from repro.models.api import build_model as jax_build_model
from repro.runtime.server import ServeConfig as JaxServeConfig
from repro.runtime.server import ServeEngine as JaxServeEngine
from repro_torch.configs.base import get_config
from repro_torch.convert import params_from_jax
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref
from repro_torch.models import ssm
from repro_torch.models.api import build_model
from repro_torch.runtime.server import ServeConfig, ServeEngine

LOGIT_TOL = dict(atol=1e-4, rtol=1e-4)


def _tol(dtype):
    t = 5e-2 if dtype == "bfloat16" else 1e-4
    return dict(atol=t, rtol=t)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _scan_inputs(bh, s, dh, ds, seed):
    """The reference kernel test's draws."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(bh, s, dh)).astype(np.float32)
    dt = (np.log1p(np.exp(rng.normal(size=(bh, s)))) * 0.1).astype(
        np.float32)
    a = (-np.abs(rng.normal(size=(bh,))) - 0.1).astype(np.float32)
    b = rng.normal(size=(bh, s, ds)).astype(np.float32)
    c = rng.normal(size=(bh, s, ds)).astype(np.float32)
    d = rng.normal(size=(bh,)).astype(np.float32)
    return x, dt, a, b, c, d


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bh,s,dh,ds,chunk", [
    (2, 64, 32, 16, 16),
    (1, 100, 16, 8, 32),     # padding
    (3, 32, 64, 32, 32),
])
def test_mamba2_scan_matches_reference(bh, s, dh, ds, chunk, dtype):
    x, dt, a, b, c, d = _scan_inputs(bh, s, dh, ds, seed=s * 7 + dh)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jx, jb, jc = (jnp.asarray(t, jdt) for t in (x, b, c))
    jrest = [jnp.asarray(t) for t in (dt, a)]
    launches = ops.mamba2_scan.launches
    y, h = ops.mamba2_scan(torch.from_numpy(x).to(tdt),
                           torch.from_numpy(dt), torch.from_numpy(a),
                           torch.from_numpy(b).to(tdt),
                           torch.from_numpy(c).to(tdt), torch.from_numpy(d))
    assert ops.mamba2_scan.launches == launches       # CPU: plain version
    assert y.dtype == tdt and h.dtype == torch.float32
    assert h.shape == (bh, ds, dh)
    args = (jx, *jrest, jb, jc, jnp.asarray(d))
    pallas = pallas_mamba2(*args, chunk=chunk, interpret=True)
    oracle = jref.mamba2_ref(*args)
    twin_y, twin_h = jref.mamba2_chunked_jnp(*args, chunk=chunk,
                                             return_final=True)
    for exp in (pallas, oracle, twin_y):
        np.testing.assert_allclose(_np(y), _np(exp), **_tol(dtype))
    np.testing.assert_allclose(_np(h), _np(twin_h), **_tol(dtype))
    # the port's per-step recurrence: the yardstick of the kernel on the card
    ry, rh = tref.mamba2_ref(*(torch.from_numpy(t) for t in
                               (x, dt, a, b, c, d)), return_final=True)
    np.testing.assert_allclose(_np(ry), _np(jref.mamba2_ref(
        *(jnp.asarray(t) for t in (x, dt, a, b, c, d)))), **_tol("float32"))
    np.testing.assert_allclose(_np(rh), _np(twin_h), **_tol(dtype))


def test_mamba2_scan_reads_one_group_for_all_heads():
    """B and C as [batch, S, ds], read by every head of the batch row,
    equal the reference's broadcast to [batch * heads, S, ds]."""
    batch, heads, s, dh, ds = 2, 3, 40, 8, 4
    x, dt, a, _, _, d = _scan_inputs(batch * heads, s, dh, ds, seed=3)
    rng = np.random.default_rng(4)
    b = rng.normal(size=(batch, s, ds)).astype(np.float32)
    c = rng.normal(size=(batch, s, ds)).astype(np.float32)
    y, h = ops.mamba2_scan(*(torch.from_numpy(t) for t in
                             (x, dt, a, b, c, d)))
    bh_ = np.repeat(b, heads, axis=0)
    ch_ = np.repeat(c, heads, axis=0)
    exp_y, exp_h = jref.mamba2_chunked_jnp(
        *(jnp.asarray(t) for t in (x, dt, a, bh_, ch_, d)),
        return_final=True)
    np.testing.assert_allclose(_np(y), _np(exp_y), **_tol("float32"))
    np.testing.assert_allclose(_np(h), _np(exp_h), **_tol("float32"))


def test_mamba2_decode_steps_match_reference():
    x, dt, a, b, c, d = _scan_inputs(2, 16, 8, 4, seed=11)
    jh = jnp.zeros((2, 4, 8), jnp.float32)
    th = torch.zeros((2, 4, 8))
    for t in range(16):
        cols = [x[:, t], dt[:, t], a, b[:, t], c[:, t], d]
        jh, jy = jref.mamba2_decode_step(jh, *(jnp.asarray(v) for v in cols))
        th, ty = tref.mamba2_decode_step(th, *(torch.from_numpy(
            np.ascontiguousarray(v)) for v in cols))
        np.testing.assert_allclose(_np(ty), _np(jy), **_tol("float32"))
    np.testing.assert_allclose(_np(th), _np(jh), **_tol("float32"))


def test_causal_conv_tail_is_pre_silu_input():
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.normal(size=(2, 7, 6)).astype(np.float32))
    w = torch.from_numpy(rng.normal(size=(4, 6)).astype(np.float32))
    out, tail = ssm._causal_conv(x, w)
    assert torch.equal(tail, x[:, -3:])
    # decode through the tail equals the prefill's last step
    out2, _ = ssm._causal_conv(x[:, -1:], w, x[:, -4:-1])
    torch.testing.assert_close(out2[:, 0], out[:, -1])


# ---------------------------------------------------------------------------
# the Zamba2 stack
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def zamba():
    """Reduced Zamba2 in fp32 and the reference's parameters for it."""
    cfg = get_config("zamba2_7b").reduced()
    jmodel = jax_build_model(jax_get_config("zamba2_7b").reduced(),
                             dtype=jnp.float32)
    jparams = jmodel.init(jax.random.key(0))
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                              cfg, device="cpu", dtype=torch.float32)
    return cfg, jmodel, jparams, tparams


def test_zamba2_prefill_and_decode_match_reference(zamba):
    cfg, jmodel, jparams, tparams = zamba
    assert ssm.n_shared_calls(cfg) == 1 and len(tparams.mamba) == 4
    model = build_model(cfg, device="cpu", dtype=torch.float32)
    toks = np.random.default_rng(5).integers(
        0, cfg.vocab, size=(2, 70)).astype(np.int32)   # two chunks, ragged
    jcache = jmodel.init_cache(2, 74, jnp.float32)
    tcache = model.init_cache(2, 74, torch.float32)
    jl, jcache = jax.jit(jmodel.prefill)(
        jparams, {"tokens": jnp.asarray(toks)}, jcache)
    with torch.inference_mode():
        tl, tcache = model.prefill(tparams, {"tokens": torch.from_numpy(toks)},
                                   tcache)
    np.testing.assert_allclose(_np(tl), _np(jl), **LOGIT_TOL)
    for name in ("conv", "ssd"):
        np.testing.assert_allclose(_np(tcache[name]), _np(jcache[name]),
                                   atol=1e-4, rtol=1e-4, err_msg=name)
    np.testing.assert_allclose(_np(tcache["k"][0]), _np(jcache["k"][0]),
                               atol=1e-4, rtol=1e-4)
    jdecode = jax.jit(jmodel.decode)
    for _ in range(3):
        nxt = np.array(jnp.argmax(jl, axis=-1), np.int32)[:, None]
        jl, jcache = jdecode(jparams, {"tokens": jnp.asarray(nxt)}, jcache)
        with torch.inference_mode():
            tl, tcache = model.decode(tparams,
                                      {"tokens": torch.from_numpy(nxt)},
                                      tcache)
        np.testing.assert_allclose(_np(tl), _np(jl), **LOGIT_TOL)
    assert tcache["len"] == int(jcache["len"]) == 73


def test_zamba2_greedy_generate_matches_reference(zamba):
    cfg, jmodel, jparams, tparams = zamba
    jeng = JaxServeEngine(jmodel, jparams,
                          JaxServeConfig(max_new_tokens=5,
                                         cache_dtype=jnp.float32))
    teng = ServeEngine(build_model(cfg, device="cpu", dtype=torch.float32),
                       tparams, ServeConfig(max_new_tokens=5,
                                            cache_dtype=torch.float32),
                       device="cpu")
    prompts = np.random.default_rng(2).integers(
        0, cfg.vocab, size=(3, 12)).astype(np.int32)
    got = teng.generate(prompts)
    np.testing.assert_array_equal(got, jeng.generate(prompts))
    assert teng.stats["nonfinite_logits"] == 0


def test_zamba2_converter_keeps_ssm_parameters_fp32(zamba):
    cfg, _, jparams, _ = zamba
    p = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), cfg,
                        device="cpu", dtype=torch.bfloat16)
    blk = p.mamba[0]
    for name in ("A_log", "D", "dt_bias"):
        assert getattr(blk, name).dtype == torch.float32, name
    assert blk.ln.w.dtype == blk.out_norm.w.dtype == torch.float32
    assert blk.in_proj.dtype == blk.conv.dtype == torch.bfloat16
    assert p.shared.attn.wq.dtype == torch.bfloat16 and p.unembed is None
    np.testing.assert_array_equal(
        blk.in_proj.float().numpy(),
        _np(jnp.asarray(jparams["mamba"]["in_proj"][0]).astype(
            jnp.bfloat16)))


@pytest.mark.parametrize("arch", ["zamba2_7b", "rwkv6_7b"])
def test_configs_copy_reference(arch):
    import dataclasses
    assert dataclasses.asdict(get_config(arch)) == dataclasses.asdict(
        jax_get_config(arch))
    assert dataclasses.asdict(get_config(arch).reduced()) == \
        dataclasses.asdict(jax_get_config(arch).reduced())
    assert get_config(arch.replace("_", "-")) is get_config(arch)
