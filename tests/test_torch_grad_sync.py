"""The planned gradient mean and the differentiable exchanges of the port,
over gloo ranks on the CPU, against the JAX package.

- ``planned_psum`` by every scheme (ring, tree, hierarchical, multiwrite,
  compressed) over 4 ranks (2 servers x 2) and 3 ranks (the
  non-power-of-two and unfactorable fallbacks): each lossless scheme is
  the exact mean within fp32 sum order, the same bits on every rank, and
  within 1e-6 of the reference's ``planned_psum`` under ``shard_map`` on
  the same numpy inputs; ``compressed`` within the reference's int8
  tolerance, and its error feedback converging on the mean
  (``tests/multidev/check_{allreduce,compression}.py``' bounds);
  ``tree_compressed_psum`` a leaf at a time; the pod-aware
  ``hierarchical_psum``;
- each differentiable exchange (``parallel.mesh``: the tiled all_to_all,
  all_gather, ppermute, reduce-scatter, pmean; ``core.collectives``' plain
  domain gather and the MultiWrite paired and full relays): its output and
  the gradient of its input, for a cotangent of every rank's own, against
  ``jax.vjp`` of the reference's ``shard_map`` program;
- the Megatron pair over a model axis: with *f* and *g* the gradients of
  a block whose loss every rank computes alike equal one rank's; with
  ``torch.distributed.nn.functional.all_reduce`` the weights' are M times
  too large (the trap).

The JAX side is this file run as a script on 4 forced CPU devices; the
torch side is ``repro_torch.launch.ranks``' workers.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[1]
N = 1000                      # elements a rank of the psum inputs
LOSSLESS = ("ring", "tree", "hierarchical", "multiwrite")
EF_ROUNDS = 20
XSHAPE = (4, 3)               # a rank's exchange input
WORLD = 4
SPAWN_TIMEOUT_S = 120
EXCHANGE_NAMES = ("all_to_all", "all_gather", "ppermute", "reduce_scatter",
                  "mean", "gather_reference", "gather_paired", "gather_full")


def psum_inputs(ranks: int) -> np.ndarray:
    return np.random.default_rng(ranks).normal(size=(ranks, N)).astype(
        np.float32)


def exchange_inputs() -> dict:
    """x [4, *XSHAPE] and each exchange's per-rank cotangent, from a numpy
    seed."""
    rng = np.random.default_rng(11)
    x = rng.normal(size=(WORLD,) + XSHAPE).astype(np.float32)
    shapes = {"all_to_all": XSHAPE, "all_gather": (WORLD,) + XSHAPE,
              "ppermute": XSHAPE, "reduce_scatter": XSHAPE[1:],
              "mean": XSHAPE, "gather_reference": (2,) + XSHAPE,
              "gather_paired": (2,) + XSHAPE, "gather_full": (2,) + XSHAPE}
    out = {"x": x}
    for name in EXCHANGE_NAMES:
        out[f"{name}/ct"] = rng.normal(size=(WORLD,) + shapes[name]).astype(
            np.float32)
    return out


def fg_inputs() -> dict:
    rng = np.random.default_rng(12)
    d, f = 6, 8
    return {"h": rng.normal(size=(5, d)).astype(np.float32),
            "w1": rng.normal(size=(d, f)).astype(np.float32),
            "w2": rng.normal(size=(f, d)).astype(np.float32),
            "c": rng.normal(size=(5, d)).astype(np.float32)}


# ---------------------------------------------------------------------------
# the JAX side (run as a script)
# ---------------------------------------------------------------------------

def jax_reference(path: str) -> None:
    import jax
    import jax.numpy as jnp
    from jax import lax
    from jax.sharding import Mesh
    from jax.sharding import PartitionSpec as P

    from repro.core import collectives as cl
    from repro.parallel.compat import shard_map

    assert jax.device_count() == WORLD
    out = {}
    for ranks in (WORLD, 3):
        mesh = Mesh(np.array(jax.devices()[:ranks]), ("data",))
        gs = psum_inputs(ranks)
        for scheme in LOSSLESS + ("compressed",):
            fn = jax.jit(shard_map(
                lambda g, s=scheme: cl.planned_psum(g, "data", num_servers=2,
                                                    reduce_scheme=s),
                mesh=mesh, in_specs=P("data"), out_specs=P("data"),
                check_vma=False))
            out[f"psum{ranks}/{scheme}"] = np.asarray(
                fn(jnp.asarray(gs.reshape(-1)))).reshape(ranks, N)

    perm = [(0, 1), (1, 2), (2, 0)]
    fns = {
        "all_to_all": lambda x: lax.all_to_all(x, "model", 0, 0, tiled=True),
        "all_gather": lambda x: lax.all_gather(x, "model"),
        "ppermute": lambda x: lax.ppermute(x, "model", perm),
        "reduce_scatter": lambda x: lax.psum_scatter(
            x, "model", scatter_dimension=0, tiled=False),
        "mean": lambda x: lax.pmean(x, "model"),
        "gather_reference": lambda x: cl.allgather_reference(x, "model", 2),
        "gather_paired": lambda x: cl.multiwrite_allgather(
            x, "model", split=0.25, mode="paired"),
        "gather_full": lambda x: cl.multiwrite_allgather(
            x, "model", split=0.25, mode="full"),
    }
    mesh = Mesh(np.array(jax.devices()), ("model",))
    inputs = exchange_inputs()
    x = jnp.asarray(inputs["x"].reshape((-1,) + XSHAPE[1:]))
    for name, fn in fns.items():
        # each rank's output stacked along dim 0 of the global one, so
        # every rank's cotangent is its own
        def body(xl, fn=fn):
            return fn(xl)[None]
        prog = shard_map(body, mesh=mesh, in_specs=P("model"),
                         out_specs=P("model"), check_vma=False)
        y, vjp = jax.vjp(prog, x)
        (dx,) = vjp(jnp.asarray(inputs[f"{name}/ct"]))
        out[f"{name}/y"] = np.asarray(y)
        out[f"{name}/dx"] = np.asarray(dx).reshape((WORLD,) + XSHAPE)
    np.savez(path, **out)


if __name__ == "__main__":
    jax_reference(sys.argv[1])
    raise SystemExit(0)


# ---------------------------------------------------------------------------
# the torch side (gloo ranks)
# ---------------------------------------------------------------------------

from repro_torch.launch import ranks  # noqa: E402


def _spec(tmp: Path, world: int, pods: int, ep: int, tp: int = 1,
          **kw) -> dict:
    return dict(world=world, pods=pods, ep=ep, tp=tp, backend="gloo",
                device="cpu", init_method=f"file://{tmp / 'store'}",
                timeout_s=60, out_dir=str(tmp / "out"), threads=1, **kw)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    path = tmp_path_factory.mktemp("jax") / "reference.npz"
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS=f"--xla_force_host_platform_device_count={WORLD}",
               PYTHONPATH=os.pathsep.join(
                   [str(ROOT / "src"), os.environ.get("PYTHONPATH", "")]))
    proc = subprocess.Popen([sys.executable, __file__, str(path)], env=env,
                            cwd=ROOT, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    yield proc, path


def _jax(reference) -> dict:
    proc, path = reference
    if proc.returncode is None:
        _, err = proc.communicate(timeout=240)
        assert proc.returncode == 0, err[-4000:]
    return dict(np.load(path))


@pytest.fixture(scope="module")
def psums(tmp_path_factory):
    """Every scheme over 4 ranks (2 x 2, dp servers of 2) and over 3 ranks
    (1 x 3)."""
    out = {}
    for world, pods, ep in ((WORLD, 2, 2), (3, 1, 3)):
        tmp = tmp_path_factory.mktemp(f"psum{world}")
        spec = _spec(tmp, world, pods, ep, dp_servers=(2,),
                     psum=psum_inputs(world),
                     psum_kw=dict(num_servers=2, rounds=EF_ROUNDS))
        out[world] = ranks.run_ranks(ranks.psum_worker, spec,
                                     timeout_s=SPAWN_TIMEOUT_S)
    return out


@pytest.fixture(scope="module")
def exchanges(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("exchanges")
    np.savez(tmp / "inputs.npz", **exchange_inputs())
    spec = _spec(tmp, WORLD, 1, 1, tp=WORLD, inputs=str(tmp / "inputs.npz"),
                 fg=fg_inputs())
    return ranks.run_ranks(ranks.exchange_worker, spec,
                           timeout_s=SPAWN_TIMEOUT_S)


@pytest.mark.parametrize("world", [WORLD, 3])
@pytest.mark.parametrize("scheme", LOSSLESS)
def test_lossless_scheme_is_the_mean(psums, reference, world, scheme):
    """Within fp32 sum order of the mean (4 ulp of its largest term), the
    same bits on every rank, and within 1e-6 of the reference's scheme."""
    gs = psum_inputs(world)
    mean = gs.astype(np.float64).mean(0)
    tol = 4 * np.finfo(np.float32).eps * np.abs(gs).max()
    got = [r[scheme] for r in psums[world]]
    for rank, g in enumerate(got):
        assert np.abs(g - mean).max() <= tol, (scheme, rank)
        np.testing.assert_array_equal(g, got[0])
    np.testing.assert_allclose(np.stack(got),
                               _jax(reference)[f"psum{world}/{scheme}"],
                               atol=1e-6, rtol=0)


def test_tree_scheme_is_the_butterfly_exactly(psums):
    """Over 4 ranks the tree's two XOR rounds add (g0 + g1) + (g2 + g3) on
    every rank: exactly that fp32 sum, divided by 4."""
    gs = psum_inputs(WORLD)
    want = ((gs[0] + gs[1]) + (gs[2] + gs[3])) / 4
    for r in psums[WORLD]:
        np.testing.assert_array_equal(r["tree"], want)


@pytest.mark.parametrize("world", [WORLD, 3])
def test_compressed_within_int8_tolerance(psums, reference, world):
    """Two quantisation steps of the largest input and of the mean, as the
    reference's check; the same bits on every rank; and the reference's
    own compressed result within the same bound."""
    gs = psum_inputs(world)
    mean = gs.mean(0)
    tol = 2 * (np.abs(gs).max() / 127 + np.abs(mean).max() / 127)
    got = [r["compressed"] for r in psums[world]]
    for g in got:
        assert np.abs(g - mean).max() < tol
        np.testing.assert_array_equal(g, got[0])
    np.testing.assert_allclose(np.stack(got),
                               _jax(reference)[f"psum{world}/compressed"],
                               atol=tol, rtol=0)


@pytest.mark.parametrize("world", [WORLD, 3])
def test_compressed_error_feedback_converges(psums, world):
    """The mean of 20 compressed means with the residual fed back lies
    within two quantisation steps of the mean's largest value over 127
    (``check_compression.run_error_feedback_convergence``)."""
    mean = psum_inputs(world).mean(0)
    naive = np.abs(mean).max() / 127 * 2
    for r in psums[world]:
        assert np.abs(r["compressed_ef"] - mean).max() <= naive + 1e-5


@pytest.mark.parametrize("world", [WORLD, 3])
def test_tree_compressed_psum_by_leaf(psums, world):
    """``tree_compressed_psum`` of two leaves (a [20, 30] block and a flat
    rest): each leaf's mean in its own shape within the int8 tolerance of
    its own values, the same bits on every rank, and each rank's residual
    what quantisation took from its own input (below half a step)."""
    gs = psum_inputs(world)
    parts = {"a": (gs[:, :600], (20, 30)), "b": (gs[:, 600:], (N - 600,))}
    for key, (vals, shape) in parts.items():
        mean = vals.mean(0).reshape(shape)
        tol = 2 * (np.abs(vals).max() / 127 + np.abs(mean).max() / 127)
        got = [r["tree_compressed"][key] for r in psums[world]]
        for rank, (m, err) in enumerate(got):
            assert m.shape == shape
            assert np.abs(m - mean).max() < tol
            np.testing.assert_array_equal(m, got[0][0])
            step = np.abs(vals[rank]).max() / 127
            assert err.shape == (vals.shape[1],)
            assert np.abs(err).max() <= step / 2 + 1e-6


def test_pod_aware_hierarchical_psum_is_the_mean(psums):
    gs = psum_inputs(WORLD)
    for r in psums[WORLD]:
        np.testing.assert_allclose(r["pod_aware"], gs.mean(0), atol=1e-5)


@pytest.mark.parametrize("name", EXCHANGE_NAMES)
def test_exchange_and_its_transpose_match_jax(exchanges, reference, name):
    ref = _jax(reference)
    for rank, r in enumerate(exchanges):
        np.testing.assert_allclose(r[name]["y"], ref[f"{name}/y"][rank],
                                   atol=1e-6, rtol=1e-6,
                                   err_msg=f"{name} rank {rank} output")
        np.testing.assert_allclose(r[name]["dx"], ref[f"{name}/dx"][rank],
                                   atol=1e-6, rtol=1e-6,
                                   err_msg=f"{name} rank {rank} gradient")


def test_megatron_pair_gives_one_rank_gradients(exchanges):
    """y = g(tanh(f(h) @ w1_r) @ w2_r), loss = sum(y * c) on every model
    rank: with f and g each rank's gradients are one rank's (its blocks of
    w1's columns and w2's rows, h whole); with the all_reduce of
    ``torch.distributed.nn`` in place of g (its backward sums the
    cotangents) the weights' are 4 times one rank's."""
    import torch
    fg = {k: torch.from_numpy(v) for k, v in fg_inputs().items()}
    h, w1, w2 = (fg[k].clone().requires_grad_(True) for k in ("h", "w1",
                                                             "w2"))
    ((torch.tanh(h @ w1) @ w2) * fg["c"]).sum().backward()
    part = w1.shape[1] // WORLD
    for rank, r in enumerate(exchanges):
        cols = slice(rank * part, (rank + 1) * part)
        np.testing.assert_allclose(r["fg"]["h"], h.grad.numpy(), rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(r["fg"]["w1"], w1.grad[:, cols].numpy(),
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(r["fg"]["w2"], w2.grad[cols].numpy(),
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(r["nn"]["w2"], WORLD * w2.grad[cols]
                                   .numpy(), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(r["nn"]["w1"], WORLD * w1.grad[:, cols]
                                   .numpy(), rtol=1e-5, atol=1e-5)
