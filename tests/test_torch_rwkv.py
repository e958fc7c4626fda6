"""The port's RWKV-6 scan and RWKV6 serving path against the JAX package.

The same numpy inputs go through the reference (its Pallas kernel in
interpret mode, its per-step oracle, its chunked jnp twin, its model and
serving engine) and through the port on the CPU, where
``ops.rwkv6_scan`` runs its plain version.  Tolerances are the reference
kernel tests' (fp32 1e-4, bf16 5e-2) and, for logits, ``test_torch_moe``'s.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jax_get_config
from repro.kernels import ref as jref
from repro.kernels.rwkv6_scan import rwkv6_scan as pallas_rwkv6
from repro.models import rwkv as jrwkv
from repro.models.api import build_model as jax_build_model
from repro.runtime.server import ServeConfig as JaxServeConfig
from repro.runtime.server import ServeEngine as JaxServeEngine
from repro_torch.configs.base import get_config
from repro_torch.convert import params_from_jax
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref
from repro_torch.models import rwkv as trwkv
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


def _scan_inputs(bh, s, dk, dv, seed):
    """The reference kernel test's draws."""
    rng = np.random.default_rng(seed)
    r = rng.normal(size=(bh, s, dk)).astype(np.float32)
    k = rng.normal(size=(bh, s, dk)).astype(np.float32)
    v = rng.normal(size=(bh, s, dv)).astype(np.float32)
    logw = (-np.abs(rng.normal(size=(bh, s, dk))) * 0.3 - 0.05).astype(
        np.float32)
    u = rng.normal(size=(bh, dk)).astype(np.float32)
    return r, k, v, logw, u


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bh,s,dk,dv,chunk", [
    (2, 64, 16, 16, 16),
    (1, 100, 8, 32, 32),     # padding
    (3, 32, 32, 8, 8),
])
def test_rwkv6_scan_matches_reference(bh, s, dk, dv, chunk, dtype):
    r, k, v, logw, u = _scan_inputs(bh, s, dk, dv, seed=s * 13 + dk)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    args = (*(jnp.asarray(t, jdt) for t in (r, k, v)), jnp.asarray(logw),
            jnp.asarray(u))
    launches = ops.rwkv6_scan.launches
    y, state = ops.rwkv6_scan(*(torch.from_numpy(t).to(tdt)
                                for t in (r, k, v)),
                              torch.from_numpy(logw), torch.from_numpy(u))
    assert ops.rwkv6_scan.launches == launches        # CPU: plain version
    assert y.dtype == tdt and state.dtype == torch.float32
    assert state.shape == (bh, dk, dv)
    pallas = pallas_rwkv6(*args, chunk=chunk, interpret=True)
    oracle = jref.rwkv6_ref(*args)
    twin_y, twin_s = jref.rwkv6_chunked_jnp(*args, chunk=chunk,
                                            return_final=True)
    for exp in (pallas, oracle, twin_y):
        np.testing.assert_allclose(_np(y), _np(exp), **_tol(dtype))
    np.testing.assert_allclose(_np(state), _np(twin_s), **_tol(dtype))
    # the port's per-step recurrence: the yardstick of the kernel on the card
    ry, rs = tref.rwkv6_ref(*(torch.from_numpy(t) for t in
                              (r, k, v, logw, u)), return_final=True)
    np.testing.assert_allclose(_np(ry), _np(jref.rwkv6_ref(
        *(jnp.asarray(t) for t in (r, k, v, logw, u)))), **_tol("float32"))
    np.testing.assert_allclose(_np(rs), _np(twin_s), **_tol(dtype))


def test_rwkv6_decode_steps_match_reference():
    r, k, v, logw, u = _scan_inputs(2, 12, 8, 8, seed=17)
    js = jnp.zeros((2, 8, 8), jnp.float32)
    ts = torch.zeros((2, 8, 8))
    for t in range(12):
        cols = [r[:, t], k[:, t], v[:, t], logw[:, t], u]
        js, jy = jref.rwkv6_decode_step(js, *(jnp.asarray(c) for c in cols))
        ts, ty = tref.rwkv6_decode_step(ts, *(torch.from_numpy(
            np.ascontiguousarray(c)) for c in cols))
        np.testing.assert_allclose(_np(ty), _np(jy), **_tol("float32"))
    np.testing.assert_allclose(_np(ts), _np(js), **_tol("float32"))


def test_per_step_recurrence_survives_fast_decays():
    """Chunk sums of logw near -170 (e^170 overflows fp32, so the
    reference's chunked factorisation k * exp(-cum) cannot hold them): the
    per-step plain version, the card's yardstick, stays finite and equals
    a float64 recurrence."""
    r, k, v, _, u = _scan_inputs(2, 64, 8, 8, seed=23)
    logw = np.full_like(r, -5.3)
    y, state = tref.rwkv6_ref(*(torch.from_numpy(t) for t in
                                (r, k, v, logw, u)), return_final=True)
    assert torch.isfinite(y).all() and torch.isfinite(state).all()
    s64 = np.zeros((2, 8, 8))
    for t in range(64):
        kv = k[:, t, :, None].astype(np.float64) * v[:, t, None, :]
        y64 = np.einsum("bk,bkv->bv", r[:, t], s64 + u[:, :, None] * kv)
        np.testing.assert_allclose(_np(y[:, t]), y64, **_tol("float32"))
        s64 = np.exp(logw[:, t])[:, :, None] * s64 + kv
    np.testing.assert_allclose(_np(state), s64, **_tol("float32"))


# ---------------------------------------------------------------------------
# the RWKV6 stack
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def rwkv():
    """Reduced RWKV6 in fp32 and the reference's parameters for it."""
    cfg = get_config("rwkv6_7b").reduced()
    jmodel = jax_build_model(jax_get_config("rwkv6_7b").reduced(),
                             dtype=jnp.float32)
    jparams = jmodel.init(jax.random.key(0))
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                              cfg, device="cpu", dtype=torch.float32)
    return cfg, jmodel, jparams, tparams


def test_decay_logw_matches_reference(rwkv):
    cfg, _, jparams, tparams = rwkv
    xw = np.random.default_rng(3).normal(size=(2, 5, cfg.d_model)).astype(
        np.float32)
    jlp = jax.tree_util.tree_map(lambda a: a[1], jparams["layers"])
    got = trwkv._decay_logw(tparams.layers[1], torch.from_numpy(xw))
    np.testing.assert_allclose(_np(got), _np(jrwkv._decay_logw(
        jlp, jnp.asarray(xw))), atol=1e-6, rtol=1e-5)
    assert (got <= 0).all()


def test_rwkv6_prefill_and_decode_match_reference(rwkv):
    cfg, jmodel, jparams, tparams = rwkv
    model = build_model(cfg, device="cpu", dtype=torch.float32)
    toks = np.random.default_rng(5).integers(
        0, cfg.vocab, size=(2, 45)).astype(np.int32)   # two chunks, ragged
    jcache = jmodel.init_cache(2, 49, jnp.float32)
    tcache = model.init_cache(2, 49, torch.float32)
    jl, jcache = jax.jit(jmodel.prefill)(
        jparams, {"tokens": jnp.asarray(toks)}, jcache)
    with torch.inference_mode():
        tl, tcache = model.prefill(tparams, {"tokens": torch.from_numpy(toks)},
                                   tcache)
    np.testing.assert_allclose(_np(tl), _np(jl), **LOGIT_TOL)
    for name in ("tshift", "cshift", "wkv"):
        np.testing.assert_allclose(_np(tcache[name]), _np(jcache[name]),
                                   atol=1e-4, rtol=1e-4, err_msg=name)
    jdecode = jax.jit(jmodel.decode)
    for _ in range(3):
        nxt = np.array(jnp.argmax(jl, axis=-1), np.int32)[:, None]
        jl, jcache = jdecode(jparams, {"tokens": jnp.asarray(nxt)}, jcache)
        with torch.inference_mode():
            tl, tcache = model.decode(tparams,
                                      {"tokens": torch.from_numpy(nxt)},
                                      tcache)
        np.testing.assert_allclose(_np(tl), _np(jl), **LOGIT_TOL)
    assert tcache["len"] == int(jcache["len"]) == 48


def test_rwkv6_greedy_generate_matches_reference(rwkv):
    cfg, jmodel, jparams, tparams = rwkv
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


def test_rwkv6_converter_keeps_decay_parameters_fp32(rwkv):
    cfg, _, jparams, _ = rwkv
    p = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), cfg,
                        device="cpu", dtype=torch.bfloat16)
    blk = p.layers[0]
    for name in ("w0", "wA", "wB", "u"):
        assert getattr(blk, name).dtype == torch.float32, name
    assert blk.ln1.w.dtype == blk.gn.w.dtype == p.ln_in.w.dtype \
        == torch.float32
    for name in ("wr", "wo", "ck", "cv", "mu", "cmu"):
        assert getattr(blk, name).dtype == torch.bfloat16, name
    assert p.unembed.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        blk.wA.numpy(), np.asarray(jparams["layers"]["wA"][0]))
