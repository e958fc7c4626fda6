"""The port's multi-rank MoE path against the JAX package, at 2 pods x 2 ep
ranks on the CPU.

The 2 x 2 counterpart of ``tests/multidev/check_collectives.py``'s
``run_dispatch_checks`` and ``run_capacity_checks``:

- the JAX side is this file run as a script in a subprocess with 4 forced
  CPU devices (``XLA_FLAGS`` set before its first import); it draws the
  inputs from numpy seeds, runs the reference's ``shard_map`` programs and
  writes every input and per-rank result to one ``.npz``;
- the torch side is 4 gloo processes (``repro_torch.launch.ranks``) that
  read the same inputs, meeting through a ``file://`` store under the
  test's temporary directory.

Pack maps and expert gates must be bit-exact rank by rank; combined outputs
and ``moe_ffn`` within 1e-5 (fp32), and within the reference's 1e-4 of the
dense oracle.  ``moe_ffn`` is also held at G = 4 pipeline chunks
(``run_moe_pipeline_checks``: bit-exact against G = 1, within 1e-5 of the
reference's G = 4), under bound plans (``run_execution_plan_checks``: a
pinned plan against contrasting knobs, a planned bind against ad-hoc
``auto``, both bit-exact), and with EP over the data axis alone (2 experts
over 2 x 2 ranks, the pods pure DP).  A reduced DBRX served over the 4
ranks must give the one-rank engine's tokens under all three scheme pairs.
"""

import math
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[1]
WORLD, PODS, EPS = 4, 2, 2
TOL = dict(atol=1e-5, rtol=1e-5)
ORACLE_TOL = 1e-4                 # the reference's own bound
# name, dispatch scheme, combine, experts scale their rows (dense oracle)
CASES = (("hier", "hierarchical", "hierarchical", True),
         ("unicast", "hierarchical", "unicast", True),
         ("baseline", "baseline", "baseline", True),
         ("tight", "hierarchical", "hierarchical", False),
         ("drops", "hierarchical", "hierarchical", False))
PAIRS = ("hierarchical+hierarchical", "hierarchical+baseline",
         "baseline+baseline")
SPAWN_TIMEOUT_S = 300
PIPE_G = 4
# the pinned plans of run_execution_plan_checks: (scheme, combine, G)
PINNED = (("hierarchical", "hierarchical", 4),
          ("hierarchical", "baseline", 4),
          ("baseline", "baseline", 2))


def pipe_config():
    """``run_moe_pipeline_checks``' layer: 8 experts, top-2, capacity factor
    4 (no stage drops a pair), d_model 16, d_ff 32, over [4, 16] tokens, so
    16 rows a rank and 4 rows a chunk at G = 4."""
    import types
    return types.SimpleNamespace(num_experts=8, top_k=2, act="silu",
                                 moe_capacity=4.0, d_model=16), 32


def ep_data_config(get_config):
    """Reduced DBRX with 2 experts, top-1: fewer experts than the 4 ranks,
    so EP runs over the data axis alone and the pods are pure DP."""
    import dataclasses
    return dataclasses.replace(
        get_config("dbrx_132b").reduced(num_experts=2), top_k=1)


def case_config(name: str) -> dict:
    """The dispatch config and sizes of a case: capacity 1.0 on the dense
    oracle's inputs (16 experts, top-4), or the tight expert capacity 0.25
    (top-2): ``run_dispatch_checks`` and ``run_capacity_checks``.  At 2 x 2
    ranks 0.25 still leaves 16 slots an expert, so ``drops`` halves it to
    make experts overflow."""
    if name in ("tight", "drops"):
        cap = 0.25 if name == "tight" else 0.125
        return dict(dcfg=dict(num_experts=16, top_k=2, pod_capacity=1.0,
                              ep_capacity=1.0, expert_capacity=cap),
                    n_per_rank=16, h=4, seed=3)
    return dict(dcfg=dict(num_experts=16, top_k=4, pod_capacity=1.0,
                          ep_capacity=1.0, expert_capacity=1.0),
                n_per_rank=24, h=8, seed=7)


def moe_reference(tokens, ids, gates, num_experts):
    """Dense oracle: out[t] = sum_k gate * scale(e_k) * token."""
    scale = (np.arange(num_experts) + 1.0) * 0.01
    out = np.zeros_like(tokens, dtype=np.float64)
    for t in range(tokens.shape[0]):
        for kk in range(ids.shape[1]):
            out[t] += gates[t, kk] * scale[ids[t, kk]] * tokens[t]
    return out.astype(np.float32)


# ---------------------------------------------------------------------------
# the JAX side (run as a script)
# ---------------------------------------------------------------------------

def jax_reference(path: str) -> None:
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from repro.configs.base import get_config
    from repro.core import collectives as cl
    from repro.models.moe import init_moe, moe_ffn
    from repro.parallel.compat import shard_map
    from repro.parallel.context import ParallelContext

    assert jax.device_count() == WORLD
    mesh = jax.make_mesh((PODS, EPS), ("pod", "ep"))
    epmesh = cl.EPMesh(pod_axis="pod", ep_axis="ep", num_pods=PODS,
                       ep_per_pod=EPS)
    spec = P(("pod", "ep"))
    out = {}
    for name, scheme, combine, scaled in CASES:
        cc = case_config(name)
        cfg = cl.DispatchConfig(**cc["dcfg"])
        e, k = cfg.num_experts, cfg.top_k
        per_rank = e // WORLD
        rng = np.random.default_rng(cc["seed"])
        n = cc["n_per_rank"] * WORLD
        tokens = rng.normal(size=(n, cc["h"])).astype(np.float32)
        logits = rng.normal(size=(n, e)).astype(np.float32)
        gates, ids = jax.jit(lambda lg, k=k: cl.route_topk(lg, k))(
            jnp.asarray(logits))

        def step(tok, ids_, gates_, scheme=scheme, combine=combine,
                 scaled=scaled, cfg=cfg, per_rank=per_rank, e=e):
            my_rank = (jax.lax.axis_index("pod") * EPS
                       + jax.lax.axis_index("ep"))
            if scheme == "hierarchical":
                exp_tok, exp_gate, st = cl.hierarchical_dispatch(
                    tok, ids_, gates_, cfg, epmesh)
                maps = (st.map_pod, st.map_ep, st.map_exp, st.recv_src)
            else:
                exp_tok, exp_gate, st = cl.baseline_dispatch(
                    tok, ids_, gates_, cfg, epmesh)
                maps = (st.map_rank, st.map_exp)
            if scaled:
                scale = (jnp.arange(e, dtype=jnp.float32) + 1.0) * 0.01
                exp_tok = exp_tok * scale[my_rank * per_rank
                                          + jnp.arange(per_rank)][:, None,
                                                                  None]
            fn = {"hierarchical": cl.hierarchical_combine,
                  "unicast": cl.hierarchical_combine_unicast,
                  "baseline": cl.baseline_combine}[combine]
            return (fn(exp_tok, exp_gate, st), exp_gate) + maps

        n_out = 6 if scheme == "hierarchical" else 4
        res = jax.jit(shard_map(step, mesh=mesh, in_specs=(spec,) * 3,
                                out_specs=(spec,) * n_out,
                                check_vma=False))(
            jnp.asarray(tokens), ids, gates)
        names = ["out", "exp_gate"] + (
            ["map_pod", "map_ep", "map_exp", "recv_src"]
            if scheme == "hierarchical" else ["map_rank", "map_exp"])
        out[f"{name}/tokens"] = tokens
        out[f"{name}/ids"] = np.asarray(ids)
        out[f"{name}/gates"] = np.asarray(gates)
        for key, val in zip(names, res):
            val = np.asarray(val)
            out[f"{name}/{key}"] = (val if key == "out" else
                                    val.reshape(WORLD, -1, *val.shape[1:]))

    # moe_ffn under a fixed pctx, each scheme pair: a reduced DBRX layer;
    # run_moe_pipeline_checks' layer at G = 4; EP over the data axis alone
    mesh3 = jax.make_mesh((PODS, EPS, 1), ("pod", "data", "model"))
    pipe_cfg, pipe_ff = pipe_config()
    jobs = (("moe", get_config("dbrx_132b").reduced(), None, (WORLD, 8), 5,
             1),
            ("pipe", pipe_cfg, pipe_ff, (4, 16), 5, PIPE_G),
            ("epdata", ep_data_config(get_config), None, (WORLD, 8), 6, 1))
    for job, cfg, d_ff, shape, seed, g in jobs:
        params = init_moe(jax.random.key(0), cfg.d_model,
                          d_ff or cfg.expert_d_ff, cfg.num_experts)
        x = np.random.default_rng(seed).normal(
            size=shape + (cfg.d_model,)).astype(np.float32)
        for key, val in params.items():
            out[f"{job}/{key}"] = np.asarray(val)
        out[f"{job}/x"] = x
        for pair in PAIRS:
            scheme, combine = pair.split("+")
            pctx = ParallelContext(mesh=mesh3, pod_axis="pod",
                                   data_axis="data", model_axis="model",
                                   plan_policy="fixed", moe_scheme=scheme,
                                   moe_combine=combine, moe_microbatch=g)
            with mesh3:
                y, aux = jax.jit(
                    lambda xx, p=pctx, c=cfg, w=params: moe_ffn(w, xx, c, p)
                )(jnp.asarray(x))
            out[f"{job}/{pair}/y"] = np.asarray(y)
            out[f"{job}/{pair}/aux"] = np.asarray(aux)
    np.savez(path, **out)


if __name__ == "__main__":
    jax_reference(sys.argv[1])
    raise SystemExit(0)


# ---------------------------------------------------------------------------
# the torch side (4 gloo ranks)
# ---------------------------------------------------------------------------

import torch  # noqa: E402

from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.launch import ranks  # noqa: E402


def _spec(tmp: Path, **kw) -> dict:
    return dict(world=WORLD, pods=PODS, ep=EPS, backend="gloo",
                device="cpu", init_method=f"file://{tmp / 'store'}",
                timeout_s=60, out_dir=str(tmp / "out"), threads=1, **kw)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    path = tmp_path_factory.mktemp("jax") / "reference.npz"
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=os.pathsep.join(
                   [str(ROOT / "src"), os.environ.get("PYTHONPATH", "")]))
    res = subprocess.run([sys.executable, __file__, str(path)], env=env,
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=240)
    assert res.returncode == 0, res.stderr[-4000:]
    return dict(np.load(path))


MOE_JOBS = ("moe", "pipe", "epdata")


def pipe_runs() -> list:
    """The runs of the pipeline layer: the fixed pairs at G = 1 and G = 4
    and the baseline at G = 2; each pinned plan, bound to a context whose
    knobs contrast with it; the planner ad hoc (``auto``) and its plan for
    the same workload, bound (``planned``)."""
    from repro_torch.core import plan as plan_ir
    from repro_torch.core.h100 import moe_compute_s
    cfg, d_ff = pipe_config()
    n_local = 4 * 16 // WORLD
    sites = plan_ir.moe_sites(
        "train", num_experts=cfg.num_experts, top_k=cfg.top_k,
        tokens_per_rank=n_local, token_bytes=cfg.d_model * 4,
        compute_s=moe_compute_s(n_local, cfg.top_k, cfg.d_model, d_ff))
    program = plan_ir.CollectiveProgram("train", sites)
    runs = (ranks.fixed_runs() + ranks.fixed_runs(microbatch=PIPE_G)
            + ranks.fixed_runs((("baseline", "baseline"),), microbatch=2))
    for scheme, combine, g in PINNED:
        pinned = plan_ir.pinned_execution_plan(
            program, {"train/moe_dispatch": {"moe_scheme": scheme,
                                             "moe_combine": combine,
                                             "microbatch": g}})
        runs.append(dict(label=f"pinned {scheme}+{combine}@G{g}",
                         scheme="baseline", microbatch=1, plan=pinned))
    runs.append(dict(label="auto", policy="auto"))
    runs.append(dict(label="planned", policy="auto", program=program))
    return runs


@pytest.fixture(scope="module")
def torch_ranks(reference, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ranks")
    np.savez(tmp / "inputs.npz", **{
        k: v for k, v in reference.items()
        if k.split("/")[0] not in MOE_JOBS})
    cases = [dict(name=n, scheme=s, combine=c, scaled=sc,
                  dcfg=case_config(n)["dcfg"]) for n, s, c, sc in CASES]
    cfgs = {"moe": get_config("dbrx_132b").reduced(),
            "pipe": pipe_config()[0], "epdata": ep_data_config(get_config)}
    moe = [dict(name=job, cfg=cfgs[job], x=reference[f"{job}/x"],
                weights={k: reference[f"{job}/{k}"]
                         for k in ("router", "w1", "w3", "w2")},
                runs=pipe_runs() if job == "pipe" else None)
           for job in MOE_JOBS]
    spec = _spec(tmp, inputs=str(tmp / "inputs.npz"), cases=cases, moe=moe)
    return ranks.run_ranks(ranks.dispatch_worker, spec,
                           timeout_s=SPAWN_TIMEOUT_S)


@pytest.mark.parametrize("name", [c[0] for c in CASES])
def test_pack_maps_and_gates_bit_exact_per_rank(reference, torch_ranks,
                                                name):
    keys = ([k for k in ("map_pod", "map_ep", "map_exp", "recv_src",
                         "map_rank") if f"{name}/{k}" in reference]
            + ["exp_gate"])
    for rank, got in enumerate(torch_ranks):
        for key in keys:
            np.testing.assert_array_equal(
                got[name][key], reference[f"{name}/{key}"][rank],
                err_msg=f"{name} rank {rank} {key}")


@pytest.mark.parametrize("name", [c[0] for c in CASES])
def test_combined_outputs_match_reference(reference, torch_ranks, name):
    got = np.concatenate([r[name]["out"] for r in torch_ranks])
    np.testing.assert_allclose(got, reference[f"{name}/out"], **TOL)
    tokens = reference[f"{name}/tokens"]
    if name in ("tight", "drops"):
        # identity experts: each row is its token times the sum of its
        # surviving gates, a number in [0, 1] (capacity drops)
        coef = (got * tokens).sum(1) / np.maximum((tokens ** 2).sum(1), 1e-9)
        assert np.all(coef < 1 + 1e-4) and np.all(coef > -1e-4)
        assert np.max(np.abs(got - coef[:, None] * tokens)) < ORACLE_TOL
        kept = sum(int((r[name]["map_exp"] >= 0).sum()) for r in torch_ranks)
        assert (kept < tokens.shape[0] * 2) == (name == "drops")
    else:
        oracle = moe_reference(tokens, reference[f"{name}/ids"],
                               reference[f"{name}/gates"], 16)
        assert np.max(np.abs(got - oracle)) < ORACLE_TOL


@pytest.mark.parametrize("pair", PAIRS)
def test_moe_ffn_over_ranks_matches_reference(reference, torch_ranks, pair):
    got = np.concatenate([r["moe_ffn"]["moe"][pair]["y"]
                          for r in torch_ranks])
    np.testing.assert_allclose(got, reference[f"moe/{pair}/y"], **TOL)
    for r in torch_ranks:
        np.testing.assert_allclose(r["moe_ffn"]["moe"][pair]["aux"],
                                   float(reference[f"moe/{pair}/aux"]),
                                   **TOL)


@pytest.mark.parametrize("pair", PAIRS)
def test_moe_ffn_pipeline_matches_serial_and_reference(reference,
                                                       torch_ranks, pair):
    """G = 4 chunks, double-buffered, against G = 1: bit-exact; and within
    TOL of the reference's G = 4 ``shard_map``, aux included (the mean of
    the chunks' dp-means)."""
    runs = [r["moe_ffn"]["pipe"] for r in torch_ranks]
    for rank, run in enumerate(runs):
        scheme, combine = pair.split("+")
        assert run[f"{pair}@G{PIPE_G}"]["resolved"] == {
            "moe_scheme": scheme, "moe_combine": combine,
            "microbatch": PIPE_G}
        np.testing.assert_array_equal(run[f"{pair}@G{PIPE_G}"]["y"],
                                      run[pair]["y"],
                                      err_msg=f"rank {rank}")
        np.testing.assert_allclose(run[f"{pair}@G{PIPE_G}"]["aux"],
                                   float(reference[f"pipe/{pair}/aux"]),
                                   **TOL)
    got = np.concatenate([run[f"{pair}@G{PIPE_G}"]["y"] for run in runs])
    np.testing.assert_allclose(got, reference[f"pipe/{pair}/y"], **TOL)


@pytest.mark.parametrize("scheme,combine,g", PINNED)
def test_bound_plan_equals_the_knobs_it_pins(torch_ranks, scheme, combine,
                                             g):
    """A pinned ExecutionPlan bound to a context whose knobs say otherwise
    (baseline, G = 1): only the plan lookup gives the pinned round trip, and
    the output equals the fixed knobs' bit for bit."""
    for r in torch_ranks:
        run = r["moe_ffn"]["pipe"]
        pinned = run[f"pinned {scheme}+{combine}@G{g}"]
        assert pinned["resolved"] == {"moe_scheme": scheme,
                                      "moe_combine": combine,
                                      "microbatch": g}
        label = f"{scheme}+{combine}@G{g}"
        np.testing.assert_array_equal(pinned["y"], run[label]["y"])
        assert pinned["aux"] == run[label]["aux"]


def test_planned_bind_equals_ad_hoc_auto(torch_ranks):
    """The planner's plan for the workload, bound, and the planner asked ad
    hoc at the layer resolve alike and give the same output bit for bit;
    every rank resolves the same round trip."""
    first = torch_ranks[0]["moe_ffn"]["pipe"]["planned"]["resolved"]
    for r in torch_ranks:
        run = r["moe_ffn"]["pipe"]
        assert run["planned"]["resolved"] == run["auto"]["resolved"] == first
        np.testing.assert_array_equal(run["planned"]["y"], run["auto"]["y"])


@pytest.mark.parametrize("pair", PAIRS)
def test_moe_ffn_with_ep_over_data_alone_matches_reference(
        reference, torch_ranks, pair):
    """2 experts over 2 pods x 2 ep ranks: EP spans the data axis alone (one
    expert a rank, the same on both pods) and the pods are pure DP."""
    got = np.concatenate([r["moe_ffn"]["epdata"][pair]["y"]
                          for r in torch_ranks])
    np.testing.assert_allclose(got, reference[f"epdata/{pair}/y"], **TOL)
    for r in torch_ranks:
        np.testing.assert_allclose(r["moe_ffn"]["epdata"][pair]["aux"],
                                   float(reference[f"epdata/{pair}/aux"]),
                                   **TOL)


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """A reduced DBRX (fp32) served over the 4 ranks under every scheme
    pair, greedy and at temperature 1, and the one-rank engine on the same
    seeded weights (its greedy and its sampled tokens)."""
    from repro_torch.launch.serve import build_engine
    cfg = get_config("dbrx_132b").reduced()
    prompts = np.random.default_rng(2).integers(
        0, cfg.vocab, size=(WORLD, 8)).astype(np.int32)
    one = build_engine(cfg, device="cpu", dtype=torch.float32, seed=3,
                       max_new=5, cache_dtype=torch.float32)
    expected = one.generate(prompts)
    one.cfg.temperature = 1.0
    sampled = one.generate(prompts, seed=7)
    tmp = tmp_path_factory.mktemp("serve")
    runs = ranks.fixed_runs() + [
        dict(scheme="hierarchical", combine="hierarchical", microbatch=PIPE_G,
             sample=False),
        dict(label="planned", policy="auto", fabric="measured", bind=True,
             sample=False),
        dict(label="planned-fixed", twin="planned", sample=False)]
    spec = _spec(tmp, cfg=cfg, dtype=torch.float32,
                 cache_dtype=torch.float32, seed=3, prompts=prompts,
                 max_new=5, runs=runs, warmup=True, temperature=1.0,
                 sample_seed=7, measure_link=1 << 16,
                 decide=["measured", "measured-pod:12.5"])
    return cfg, expected, sampled, ranks.run_ranks(
        ranks.serve_worker, spec, timeout_s=SPAWN_TIMEOUT_S)


SERVED_RUNS = PAIRS + (f"hierarchical+hierarchical@G{PIPE_G}", "planned",
                       "planned-fixed")


def test_generate_over_ranks_equals_one_rank(served):
    """Every scheme pair, the pipeline at G = 4, the planned run and its
    fixed twin give the one-rank engine's tokens (fp32: each chunk's rows equal the serial
    loop's, so no near ties arise)."""
    cfg, expected, _, results = served
    assert expected.shape == (WORLD, 5)
    for r in results:
        for label in SERVED_RUNS:
            got = r["runs"][label]
            np.testing.assert_array_equal(got["tokens"], expected,
                                          err_msg=f"rank {r['rank']} {label}")
            assert got["nonfinite_logits"] == 0
            assert got["prefill_logits"].shape == (1, cfg.vocab)
            against = "planned" if label == "planned-fixed" else PAIRS[0]
            assert got["vs"] == {"run": against, "rows_equal": 1, "rows": 1,
                                 "widest_gap": 0.0}
        g4 = r["runs"][SERVED_RUNS[3]]["resolved"]
        assert g4 == {"prefill": ("hierarchical", "hierarchical", PIPE_G),
                      "decode": ("hierarchical", "hierarchical", 1)}


def test_planned_serving_follows_the_measured_fabric(served):
    """The ranks measure one exchange and agree on its rate; the planner's
    decisions on that fabric (and on its pod link slowed to 12.5 GB/s) are
    the same on every rank, the planned run executes its plan, clamped to
    the rows a rank has, and its twin runs the plan's prefill triple
    fixed."""
    _, _, _, results = served
    first = results[0]
    fabric = first["link"]["fabric"]
    assert fabric.startswith("2x2@")
    assert [d["fabric"] for d in first["decisions"]] == [
        fabric, f"2x2@12.5:{fabric.partition(':')[2]}"]
    for r in results:
        assert r["link"] == first["link"]
        assert r["decisions"] == [
            {**d, "host_us": r_d["host_us"]}
            for d, r_d in zip(first["decisions"], r["decisions"])]
        planned = r["runs"]["planned"]
        assert planned["plan"] == first["runs"]["planned"]["plan"]
        assert planned["plan"] == first["decisions"][0]["fingerprint"]
        for phase, rows in (("prefill", 8), ("decode", 1)):
            want = first["decisions"][0]["phases"][phase]
            assert planned["resolved"][phase] == (
                want["scheme"], want["combine"],
                math.gcd(want["microbatch"], rows))
        twin = r["runs"]["planned-fixed"]
        assert twin["plan"] is None
        assert twin["resolved"]["prefill"] == planned["resolved"]["prefill"]


def test_pod_bytes_count_the_send_buffers(served):
    """From each pod-0 rank's own buffers of the first (prefill) dispatch:
    occupied rows equal ``dispatch_pod_bytes`` on its expert ids, and
    MultiWrite puts no more on the pod group than the baseline."""
    _, _, _, results = served
    for r in results:
        hier = r["runs"]["hierarchical+hierarchical"]
        base = r["runs"]["baseline+baseline"]
        assert hier["pod_bytes"]["occupied"] <= base["pod_bytes"]["occupied"]
        assert 0 < hier["pod_bytes"]["occupied"] <= hier["pod_bytes"]["whole"]
        if hier["pod"] == 0:
            assert (hier["pod_bytes"]["occupied"]
                    == hier["analytic_pod_bytes"]["multiwrite"])
            assert (base["pod_bytes"]["occupied"]
                    == base["analytic_pod_bytes"]["baseline"])


def test_sampling_over_ranks_equals_one_rank(served):
    """At temperature 1 every global row draws its own uniform from the
    shared generator, so 4 ranks sample the one-rank engine's tokens (rows
    on different ranks sharing draws would not)."""
    _, _, sampled, results = served
    for r in results:
        for pair in PAIRS:
            np.testing.assert_array_equal(
                r["runs"][pair]["sampled"], sampled,
                err_msg=f"rank {r['rank']} {pair}")


def test_every_pack_of_a_step_is_checked(served):
    """The warm-up run (a prefill and a decode step) holds each pack of the
    path against its plain version: 3 a layer and chunk for the
    hierarchical dispatch, 2 for the baseline at 4 ranks."""
    cfg, _, _, results = served
    per_chunk = {"hierarchical": 3, "baseline": 2}
    for r in results:
        for label in SERVED_RUNS:
            run = r["runs"][label]
            want = sum(per_chunk[scheme] * g for scheme, _, g
                       in run["resolved"].values())
            assert len(run["packs"]) == want * cfg.n_layers, label
            assert all(exact for *_, exact in run["packs"])
