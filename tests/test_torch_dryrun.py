"""The port's dry run (``launch/dryrun.py``, ``parallel/sharding.py``,
``launch/mesh.py``, ``ShapeMesh``) against the reference's, on the CPU.

A JAX subprocess of this same file (512 forced CPU devices, nothing
compiled: ``jax.eval_shape`` and the planner) writes the reference's
``VARIANTS``, ``batch_shapes``, ``model_flops_per_step``, every leaf's
shape on one rank under ``param_specs`` on (16, 16) and (2, 16, 16), and
``planner_cell_report`` for DBRX and Kimi-K2 on ``train_4k`` and
``decode_32k`` under ``auto``; the port's are held to them:

- the copies equal, for every arch and shape (``shapes_for`` and
  ``cell_is_skipped`` too);
- each leaf's shape on one rank equal, but for the leaves whose
  model-axis cut the port makes otherwise (``DEVIATIONS``, each with its
  reason); Qwen2-VL-2B's 12 heads do not divide over 16 model ranks, so
  its attention is replicated (``layers.splits``), and its dry-run cells
  run;
- the plan fingerprints and decisions equal, the compute priced at the
  reference's TPU peak.

Then the port alone: the reduced DBRX over (2, 2, 1) on 4 real gloo ranks
against the ``ShapeMesh`` meta run of each rank (prefill and a training
step): the same exchanges, and the same wire bytes by axis and kind; a
meta train cell of each reduced family: argument bytes equal to its
weights, gradients, AdamW state and batch, peak live bytes at least
those, FLOPs above 6 N tokens (N outside the embedding table); ``launch.train --variant baseline`` over
2 gloo ranks runs; ``--multi-pod`` on a small world raises.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PLANNER_CELLS = [(arch, shape, mp) for arch in ("dbrx_132b", "kimi_k2_1t")
                 for shape in ("train_4k", "decode_32k")
                 for mp in (False, True)]


def _plans(rep: dict) -> dict:
    """The fingerprint and the decisions of a planner report."""
    out = {"execution_plan": rep.get("execution_plan"),
           "microbatch": rep.get("moe_microbatch", {}).get("planned")}
    for key in ("moe_dispatch", "moe_combine", "grad_sync",
                "allgather_ref_8x4"):
        if rep.get(key):
            out[key] = rep[key]["plan"]
    for fab, cell in rep.get("fabrics", {}).items():
        for op, dec in cell.items():
            out[f"{fab}/{op}"] = dec["plan"]
    return out


# ---------------------------------------------------------------------------
# the JAX side (run as a script)
# ---------------------------------------------------------------------------

def jax_side(path: str) -> None:
    import functools

    import repro.launch.dryrun as jd     # forces 512 devices before jax
    import jax
    import jax.numpy as jnp

    import repro.models.api as japi
    from repro.configs.base import ARCH_IDS, SHAPES, get_config
    from repro.launch.mesh import make_pctx
    from repro.parallel import sharding as shd
    assert jax.device_count() == 512
    japi.param_count_shape_only = functools.lru_cache(
        japi.param_count_shape_only)
    out = {"variants": repr(jd.VARIANTS), "batch": {}, "mflops": {},
           "params": {}, "planner": {}}
    for arch in ARCH_IDS:
        cfg = get_config(arch)
        for name, shape in SHAPES.items():
            out["batch"][f"{arch}/{name}"] = {
                k: [list(v.shape), str(v.dtype)]
                for k, v in jd.batch_shapes(cfg, shape).items()}
            out["mflops"][f"{arch}/{name}"] = jd.model_flops_per_step(
                arch, shape)
        for mp in (False, True):
            pctx = make_pctx(multi_pod=mp)
            params = jax.eval_shape(japi.build_model(cfg, pctx).init,
                                    jax.ShapeDtypeStruct((2,), jnp.uint32))
            specs = shd.param_specs(params, cfg, pctx)
            leaves = {}
            for (kp, leaf), spec in zip(
                    jax.tree_util.tree_flatten_with_path(params)[0],
                    jax.tree_util.tree_leaves(
                        specs, is_leaf=lambda x: isinstance(
                            x, jax.sharding.PartitionSpec))):
                key = "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                               for k in kp)
                shape = []
                for i, dim in enumerate(leaf.shape):
                    ax = spec[i] if i < len(spec) else None
                    axes = () if ax is None else (
                        (ax,) if isinstance(ax, str) else tuple(ax))
                    n = 1
                    for a in axes:
                        n *= pctx.mesh.shape[a]
                    shape.append(dim // n)
                leaves[key] = shape
            out["params"][f"{arch}/{'multi' if mp else 'single'}"] = leaves
    for arch, shape, mp in PLANNER_CELLS:
        pctx = jd._cell_pctx(arch, SHAPES[shape], mp, "auto")
        rep = jd.planner_cell_report(arch, SHAPES[shape], pctx)
        out["planner"][f"{arch}/{shape}/{mp}"] = _plans(rep)
    with open(path, "w") as f:
        json.dump(out, f)


if __name__ == "__main__":
    jax_side(sys.argv[1])
    raise SystemExit(0)


# ---------------------------------------------------------------------------
# the torch side
# ---------------------------------------------------------------------------

import dataclasses  # noqa: E402
import math  # noqa: E402

import pytest  # noqa: E402
import torch  # noqa: E402

from repro_torch.configs import base as cbase  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import dryrun, ranks  # noqa: E402
from repro_torch.launch.mesh import shape_pctx  # noqa: E402
from repro_torch.models.api import param_module  # noqa: E402
from repro_torch.parallel import sharding  # noqa: E402

ARCHS = cbase.ARCH_IDS
MESHES = {"single": False, "multi": True}
# the leaves whose model-axis cut the port makes otherwise than the
# reference's spec, by the last key of their name, each with its reason
DEVIATIONS = {
    "emb": "the embedding stays whole on every model rank",
    "unembed": "the unembedding stays whole on every model rank",
    "in_proj": "Mamba2's in_proj keeps its heads' z, x, dt columns and "
               "B/C whole (ssm.in_proj_segments)",
    "A_log": "a Mamba2 rank keeps its heads' (replicated in the reference)",
    "D": "a Mamba2 rank keeps its heads'",
    "dt_bias": "a Mamba2 rank keeps its heads'",
    "out_norm.w": "a Mamba2 rank keeps its channels' of the norm",
    "wA": "RWKV-6's decay LoRA wA stays whole (its columns are contracted)",
    "cr": "RWKV-6's channel-mix gate cr stays whole",
    "w0": "an RWKV-6 rank keeps its heads' base decay",
    "u": "an RWKV-6 rank keeps its heads' bonus",
    "gn.w": "an RWKV-6 rank keeps its channels' of the group norm",
    # an arch's own, as "arch:leaf"
    "qwen2_vl_2b:attn.wq": "Qwen2-VL's 12 query heads do not divide over "
                           "16 model ranks: the attention block stays "
                           "whole on every rank (layers.splits), where "
                           "GSPMD cuts wq's 1,536 columns mid-head",
    "qwen2_vl_2b:attn.wo": "the replicated attention block's wo",
}
# kv projections replicated where the kv heads do not divide over the
# model axis (layers.kv_layout)
KV = ("wk", "wv")


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    path = tmp_path_factory.mktemp("dryrun_ref") / "ref.json"
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src"), os.environ.get("PYTHONPATH", "")]),
        JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    res = subprocess.run([sys.executable, __file__, str(path)], env=env,
                         capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-4000:]
    with open(path) as f:
        return json.load(f)


def test_copies_equal_the_reference(reference):
    assert repr(dryrun.VARIANTS) == reference["variants"]
    from repro.configs import base as jbase
    for arch in ARCHS:
        assert cbase.shapes_for(arch) == jbase.shapes_for(arch)
        cfg = cbase.get_config(arch)
        for name, shape in cbase.SHAPES.items():
            assert cbase.cell_is_skipped(arch, name) == \
                jbase.cell_is_skipped(arch, name)
            got = {k: [list(s), str(dt).replace("torch.", "")]
                   for k, (s, dt) in dryrun.batch_shapes(cfg, shape).items()}
            assert got == reference["batch"][f"{arch}/{name}"], (arch, name)
            assert dryrun.model_flops_per_step(arch, shape) == \
                pytest.approx(reference["mflops"][f"{arch}/{name}"],
                              rel=1e-12), (arch, name)


def _ref_key(name: str, cfg) -> tuple[str, bool]:
    """The reference's leaf path of the port's parameter ``name`` and
    whether it is stacked over layers (``convert.params_from_jax``'s
    correspondence)."""
    parts = name.split(".")
    if parts == ["unembed"]:
        return "unembed/w", False
    top = {"blocks": "layers", "mamba": "mamba", "layers": "layers",
           "enc_blocks": "enc_layers"}.get(parts[0])
    if top is None:
        return "/".join(parts), False
    i, rest = int(parts[1]), "/".join(parts[2:])
    if parts[0] == "blocks" and i < cfg.first_k_dense:
        return f"layers_prefix/{i}/{rest}", False
    return f"{top}/{rest}", True


def _deviates(name: str, cfg, arch: str) -> bool:
    keys = [k for k in name.split(".") if not k.isdigit()]
    if keys[-1] in KV and cfg.n_kv_heads % 16:
        return True
    return (keys[-1] in DEVIATIONS or ".".join(keys[-2:]) in DEVIATIONS
            or f"{arch}:{'.'.join(keys[-2:])}" in DEVIATIONS)


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_leaf_shapes_on_one_rank_equal_param_specs(reference, arch, mesh):
    cfg = cbase.get_config(arch)
    pctx = shape_pctx(multi_pod=MESHES[mesh])
    params = param_module(cfg, device="meta", dtype=torch.bfloat16,
                          pctx=pctx)
    want = reference["params"][f"{arch}/{mesh}"]
    seen = set()
    for name, shape in sharding.param_shapes(params, cfg, pctx).items():
        key, stacked = _ref_key(name, cfg)
        ref = want[key][1:] if stacked else want[key]
        seen.add(key)
        if _deviates(name, cfg, arch):
            if list(shape) != ref:
                DEVIATED.add(_leaf_key(name, arch))
            continue
        assert list(shape) == ref, (name, shape, ref)
    assert seen == set(want)


DEVIATED: set = set()


def _leaf_key(name: str, arch: str) -> str:
    keys = [k for k in name.split(".") if not k.isdigit()]
    for key in (f"{arch}:{'.'.join(keys[-2:])}", ".".join(keys[-2:])):
        if key in DEVIATIONS:
            return key
    return keys[-1]


def test_every_listed_deviation_is_one():
    """Each leaf of the list differs from the reference's spec in some
    (arch, mesh) of the test above (run first, in this file's order)."""
    assert set(DEVIATIONS) | set(KV) <= DEVIATED


@pytest.mark.parametrize("cell", PLANNER_CELLS,
                         ids=lambda c: f"{c[0]}-{c[1]}-{c[2]}")
def test_planner_report_equals_reference(reference, cell):
    from repro_torch.core.topology import TPU_PEAK_FLOPS
    arch, shape, mp = cell
    spec = cbase.SHAPES[shape]
    pctx = dryrun._cell_pctx(arch, spec, mp, "auto",
                             peak_flops=TPU_PEAK_FLOPS)
    rep = dryrun.planner_cell_report(arch, spec, pctx,
                                     peak_flops=TPU_PEAK_FLOPS)
    assert _plans(rep) == reference["planner"][f"{arch}/{shape}/{mp}"]


def test_width_not_dividing_is_an_error_naming_it(tmp_path, monkeypatch):
    """Qwen2-VL-2B's 12 query heads over 16 model ranks: the cell runs
    (its attention replicated, ``layers.splits``) and saves a result
    without an ``error``; the name is kept from when such a width
    raised."""
    monkeypatch.setattr(dryrun, "RESULTS_DIR", str(tmp_path))
    r = dryrun.run_and_save("qwen2_vl_2b", "decode_32k", False, force=True)
    assert "error" not in r
    assert r["memory"]["argument_bytes"] > 0
    saved = json.loads((tmp_path / "qwen2_vl_2b__decode_32k__single__mw.json"
                        ).read_text())
    assert "error" not in saved
    assert saved["collectives"]["by_kind"] == r["collectives"]["by_kind"]


# ---------------------------------------------------------------------------
# the port alone
# ---------------------------------------------------------------------------

SMALL = cbase.ShapeSpec("small", 32, 4, "train")
SMALL_PREFILL = cbase.ShapeSpec("small_prefill", 32, 4, "prefill")


def _reduced_dbrx():
    return dataclasses.replace(cbase.get_config("dbrx_132b").reduced(),
                               moe_capacity=4.0)


def exchanges_on_ranks(mesh, dev, spec) -> dict:
    """On each of 4 gloo ranks of (2, 2, 1): the reduced DBRX's prefill
    and a training step (FSDP over the data axis, the loss, its backward,
    the gradient sync and the update), every exchange recorded as a
    ``ShapeMesh`` of the same rank records it."""
    from unittest import mock

    from repro_torch.data.pipeline import DataConfig, SyntheticLM, \
        batch_for_model
    from repro_torch.launch.train import grad_sync_for
    from repro_torch.models.api import build_model
    from repro_torch.optim import adamw
    from repro_torch.parallel import mesh as mesh_ops
    from repro_torch.parallel.context import ParallelContext
    from repro_torch.runtime.trainer import (TrainState, make_train_step,
                                             trainable)
    twin = mesh_ops.ShapeMesh(tuple(mesh.shape.values()), rank=mesh.rank)
    names = {id(g): key for key, g in mesh._groups.items()}

    def group_of(group):
        if group is None:                       # the world
            return twin.world_group()
        key = names[id(group)]
        axes, members = ((key, tuple(range(mesh.axis_size(*key))))
                         if all(isinstance(k, str) for k in key)
                         else (mesh_ops.axis_names(key[0]), key[1]))
        return mesh_ops.ShapeGroup(twin, axes, members)

    def wrap(fn, kind, out_of=lambda out, *a: out):
        def run(*args):
            out = fn(*args)
            group = group_of(args[1])
            if kind == "collective-permute":
                group.record(kind, out, sends=args[3] in args[4])
            else:
                group.record(kind, out)
            return out
        return run
    patches = [mock.patch.object(mesh_ops, name, wrap(getattr(mesh_ops,
                                                              name), kind))
               for name, kind in (("_all_reduce_", "all-reduce"),
                                  ("_all_to_all", "all-to-all"),
                                  ("_all_gather", "all-gather"),
                                  ("_reduce_scatter", "reduce-scatter"),
                                  ("_ppermute", "collective-permute"))]
    cfg = _reduced_dbrx()
    out = {}
    for p in patches:
        p.start()
    try:
        for label, shape in (("prefill", SMALL_PREFILL), ("train", SMALL)):
            pctx = ParallelContext(mesh, pod_axis="pod", remat=(
                "full" if shape.kind == "train" else "none"))
            model = build_model(cfg, device="cpu", dtype=torch.bfloat16,
                                pctx=pctx)
            params = model.init(torch.Generator().manual_seed(0))
            raw = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=shape.
                                         seq_len, global_batch=shape.
                                         global_batch, seed=0)).batch(0)
            batch = batch_for_model(cfg, raw, device="cpu", pctx=pctx)
            if shape.kind == "train":           # the step the dry run runs
                params = sharding.shard_fsdp(params, cfg, pctx)
                sync = grad_sync_for(cfg, pctx, params, shape.global_batch
                                     * shape.seq_len // pctx.dp_size)[1]
                opt = adamw(lr=1e-4)
                state = TrainState(params, opt.init(trainable(params)), 0)
            twin.log.clear()
            if shape.kind == "train":
                make_train_step(model, opt, grad_sync=sync)(state, batch)
            else:
                batch.pop("labels", None)
                cache = model.init_cache(batch["tokens"].shape[0],
                                         shape.seq_len)
                model.prefill(params, batch, cache)
            out[label] = list(twin.log)
    finally:
        for p in patches:
            p.stop()
    return out


@pytest.fixture(scope="module")
def real_exchanges(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dryrun_ranks")
    spec = dict(world=4, pods=2, ep=2, tp=1, backend="gloo", device="cpu",
                init_method=f"file://{tmp / 'store'}", timeout_s=60,
                out_dir=str(tmp / "out"), threads=1,
                call=exchanges_on_ranks)
    return ranks.run_ranks(ranks.call_worker, spec, timeout_s=180)


@pytest.mark.parametrize("kind", ["prefill", "train"])
def test_shape_mesh_records_the_exchanges_real_ranks_run(real_exchanges,
                                                         kind):
    shape = SMALL if kind == "train" else SMALL_PREFILL
    for rank, real in enumerate(real_exchanges):
        meta = dryrun.run_cell("dbrx_132b", shape, multi_pod=True,
                               rank=rank, mesh_shape=(2, 2, 1),
                               config=_reduced_dbrx(), verbose=False,
                               fabrics=())
        got = real[kind]
        assert got, "the real ranks exchanged nothing"
        want = [_record(r) for r in _meta_log(meta)]
        assert [_record(r) for r in got] == want, rank
        by_axis, by_kind = {}, {}
        for k, ax, wire, _, _ in got:
            by_axis[ax] = by_axis.get(ax, 0) + wire
            by_kind[k] = by_kind.get(k, 0) + wire
        assert meta["collectives"]["by_axis"] == by_axis
        assert meta["collectives"]["by_kind"] == by_kind


def _meta_log(result: dict) -> list:
    return result["collectives"]["log"]


def _record(rec) -> tuple:
    """A log record with its shape as a tuple (a list through JSON)."""
    return tuple(rec[:4]) + (tuple(rec[4]),)


@pytest.mark.parametrize("arch", ["zamba2_7b", "rwkv6_7b",
                                  "seamless_m4t_medium"])
def test_meta_train_cell_of_each_family(arch):
    cfg = cbase.get_config(arch).reduced()
    before = ops.launches()
    r = dryrun.run_cell(arch, SMALL, multi_pod=False, mesh_shape=(1, 1, 1),
                        config=cfg, verbose=False, fabrics=())
    # meta launches are counted from their cost records; the wrappers'
    # counters count real launches only
    assert ops.launches() == before
    # a cell of one rank builds its model without a context, so no block
    # runs under remat and each forward kernel runs once (remat="full"
    # doubles them over a model axis: test_torch_train_stacks.py)
    kernel = {"zamba2_7b": "mamba2_scan", "rwkv6_7b": "rwkv6_scan",
              "seamless_m4t_medium": "flash_attention"}[arch]
    assert r["launches"][kernel] == r["launches"][kernel + "_bwd"] > 0
    assert r["launches"] == {k: row["launches"]
                             for k, row in r["cost"]["kernels"].items()}
    params = param_module(cfg, device="meta", dtype=torch.bfloat16)
    weights = sum(p.numel() * p.element_size() for p in params.parameters())
    args = r["memory"]["arguments"]
    assert args["weights"] == weights
    assert args["grads"] == weights
    assert args["opt_state"] == 2 * weights           # AdamW m and v
    assert args["batch"] == sum(
        torch.Size(s).numel() * dt.itemsize
        for s, dt in dryrun.batch_shapes(cfg, SMALL).values())
    # the gradients are made by the step: reported, not an argument
    assert r["memory"]["argument_bytes"] == sum(args.values()) - weights
    assert r["memory"]["peak_live_bytes"] >= r["memory"]["argument_bytes"]
    assert sum(r["memory"]["peak_parts"].values()) == \
        r["memory"]["peak_live_bytes"]
    # the parameters outside the embedding table (a lookup costs no FLOPs)
    n = sum(p.numel() for p in params.parameters()) - params.embed.emb.numel()
    assert r["cost"]["flops_per_device"] > 6 * n * 4 * 32
    assert r["cost"]["bytes_per_device"] > weights
    assert r["collectives"]["num_ops"] == 0


def test_launch_train_variant_over_ranks(tmp_path):
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src"), os.environ.get("PYTHONPATH", "")]))
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc-per-node", "2", "-m", "repro_torch.launch.train",
           "--arch", "zamba2_7b", "--smoke", "--device", "cpu", "--tp", "2",
           "--backend", "gloo", "--variant", "baseline", "--steps", "2",
           "--batch", "2", "--seq", "16"]
    res = subprocess.run(cmd, env=env, cwd=tmp_path, capture_output=True,
                         text=True, timeout=240)
    out = res.stdout + res.stderr
    assert res.returncode == 0, out[-4000:]
    assert "variant baseline: {'moe_scheme': 'baseline'}" in out
    assert "final loss" in out


def test_traffic_counts_storages_made_before_it_once():
    """Storages that exist when the mode starts (weights, optimizer
    moments, a cache) count nothing, however an op writes them: in place,
    through a view, or as an ``out=`` tensor; a storage made inside counts
    once while it lives."""
    w = torch.empty(1 << 20, device="meta")
    m = torch.empty(1 << 20, device="meta")
    with dryrun.Traffic() as t:
        w.add_(1)
        m.mul_(0.9)
        torch.add(w, 1, out=m)
        w[:10].zero_()
        m.view(2, -1).t().mul_(2)
    assert t.peak == 0
    with dryrun.Traffic() as t:
        x = w * 2                       # made inside: 4 MiB
        x.add_(1)                       # in place: nothing more
        y = x.view(-1)                  # a view: nothing more
        del x, y
        z = torch.empty(1 << 19, device="meta")   # 2 MiB, the first freed
        z.zero_()
    assert t.peak == 4 << 20


def test_meta_train_cell_counts_gradients_once():
    """A train cell on one rank: the gradients are made by the step, so
    they are not in the argument bytes, and the peak holds each once: it
    falls at the update for a step this small, where every gradient is
    alive beside the arguments, and its split counts each byte in one
    part."""
    cfg = cbase.get_config("mistral_nemo_12b").reduced()
    r = dryrun.run_cell("mistral_nemo_12b", cbase.ShapeSpec("tiny", 4, 1,
                                                            "train"),
                        multi_pod=False, mesh_shape=(1, 1, 1), config=cfg,
                        verbose=False, fabrics=(), makers=3)
    mm = r["memory"]
    args = mm["arguments"]
    assert mm["argument_bytes"] == (args["weights"] + args["opt_state"]
                                    + args["batch"])
    assert mm["peak_parts"]["gradients"] == args["grads"]
    assert sum(mm["peak_parts"].values()) == mm["peak_live_bytes"]
    # the largest makers of the bytes at the peak, by op and model code
    assert len(mm["peak_makers"]) == 3
    assert all(" @ " in maker for maker in mm["peak_makers"])
    assert sum(mm["peak_makers"].values()) <= mm["temp_bytes"]


def _cpu_peak(cfg, batch: int, seq: int) -> int:
    """The peak of the bytes the CPU allocator holds over one fp32 train
    step of ``cfg`` on one rank, from ``torch.profiler``'s allocation
    events (those made before the step aside)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.data.pipeline import DataConfig, SyntheticLM, \
        batch_for_model
    from repro_torch.models.api import build_model
    from repro_torch.optim import adamw
    from repro_torch.runtime.trainer import (TrainState, make_train_step,
                                             trainable)
    model = build_model(cfg, device="cpu", dtype=torch.float32)
    params = model.init(torch.Generator().manual_seed(0))
    opt = adamw(lr=1e-4)
    state = TrainState(params, opt.init(trainable(params)), 0)
    raw = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=seq,
                                 global_batch=batch, seed=0)).batch(0)
    data = batch_for_model(cfg, raw, device="cpu")
    step = make_train_step(model, opt)
    with profile(activities=[ProfilerActivity.CPU],
                 profile_memory=True) as prof:
        step(state, data)
    now = peak = 0
    for e in sorted((e for e in prof.profiler.kineto_results.events()
                     if e.name() == "[memory]"), key=lambda e: e.start_ns()):
        now += e.nbytes()
        peak = max(peak, now)
    return peak


@pytest.mark.parametrize("arch", ["mistral_nemo_12b", "gemma2_9b",
                                  "dbrx_132b", "zamba2_7b", "rwkv6_7b",
                                  "seamless_m4t_medium"])
def test_predicted_peak_matches_the_cpu_allocator(arch, monkeypatch):
    """A small fp32 model's train step on one rank: the meta prediction's
    peak (arguments plus :class:`~repro_torch.launch.dryrun.Traffic`'s
    peak) within 10% of the arguments plus the peak the CPU allocator
    held over the same step (``torch.profiler``'s memory events).  Both
    run the kernels' plain versions, the CPU's program; the dry run's
    modules are built in fp32 (``models.api``'s builders patched)."""
    from repro_torch.models import api
    for name in ("build_model", "param_module"):
        monkeypatch.setattr(api, name, lambda *a, real=getattr(api, name),
                            **kw: real(*a, **dict(kw, dtype=torch.float32)))
    cfg = cbase.get_config(arch).reduced()
    with ranks._plain_kernels():
        r = dryrun.run_cell(arch, cbase.ShapeSpec("small", 64, 8, "train"),
                            multi_pod=False, mesh_shape=(1, 1, 1),
                            config=cfg, verbose=False, fabrics=())
        held = _cpu_peak(cfg, 8, 64)
    mm = r["memory"]
    ratio = mm["peak_live_bytes"] / (mm["argument_bytes"] + held)
    assert 0.9 <= ratio <= 1.1, ratio


def _fsdp_analytic(params, cfg, pctx) -> dict:
    """The FSDP exchanges of one train step on paper: each data-cut
    leaf's weight all-gather over ``data`` in the forward and its
    gradient's reduce-scatter, wire bytes by ``parallel.mesh``'s factors
    (the dry run's own pricing before it executed FSDP)."""
    data = pctx.data_size
    parts = sharding.fsdp_parts(params, cfg, pctx) if pctx.fsdp else {}
    return {"all-gather": sum(whole * (data - 1) // data
                              for _, whole in parts.values()),
            "reduce-scatter": sum(held * (data - 1)
                                  for held, _ in parts.values())}


@pytest.mark.parametrize("mesh", [(1, 2, 2), (2, 2, 1), (1, 4, 1)])
@pytest.mark.parametrize("arch", ARCHS)
def test_executed_fsdp_bytes_equal_the_analytic(arch, mesh):
    """Each family's reduced train cell under FSDP (remat "full", the dry
    run's default): the data axis's all-gathers of the forward and
    reduce-scatters of the backward equal the analytic figures, and each
    block's recompute gathers its weights again (``regather``); the
    weights a rank holds are ``sharding.param_shapes``'."""
    cfg = cbase.get_config(arch).reduced()
    pctx = shape_pctx(shape=mesh)
    whole = param_module(cfg, device="meta", dtype=torch.bfloat16, pctx=pctx)
    r = dryrun.run_cell(arch, SMALL, multi_pod=mesh[0] > 1, mesh_shape=mesh,
                        config=cfg, verbose=False, fabrics=())
    got = r["collectives"]["fsdp"]
    want = _fsdp_analytic(whole, cfg, pctx)
    assert want["all-gather"] > 0
    assert {k: got[k] for k in want} == want
    assert got["regather"] > 0
    assert r["memory"]["arguments"]["weights"] == sum(
        math.prod(s) * p.element_size() for s, p in zip(
            sharding.param_shapes(whole, cfg, pctx).values(),
            whole.parameters()))


def _chunk_loss_by_autograd(hh, emb, ll, tied, final_softcap, ignore):
    """The chunk's summed nll as plain ops, differentiated by autograd."""
    logits = hh @ (emb.T if tied else emb).to(hh.dtype)
    lf = logits.float()
    if final_softcap is not None:
        lf = final_softcap * torch.tanh(lf / final_softcap)
    logz = torch.logsumexp(lf, dim=-1)
    gold = lf.gather(-1, ll.clamp(min=0).long()[..., None])[..., 0]
    mask = ll != ignore
    return torch.sum((logz - gold) * mask), torch.sum(mask)


@pytest.mark.parametrize("tied", [True, False])
@pytest.mark.parametrize("cap", [None, 30.0])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_chunk_nll_backward_is_autograds(dtype, cap, tied):
    """``layers._ChunkNLL``'s backward in one fp32 buffer gives autograd's
    bits: the nll, and the gradients of the activations and the table."""
    from repro_torch.models import layers as L
    gen = torch.Generator().manual_seed(3)
    hh = torch.randn(3, 8, 16, generator=gen).to(dtype).requires_grad_(True)
    emb = torch.randn(*((50, 16) if tied else (16, 50)), generator=gen
                      ).to(dtype).requires_grad_(True)
    ll = torch.randint(0, 50, (3, 8), generator=gen)
    ll[0, :3] = -1
    got = []
    for fn in (_chunk_loss_by_autograd, L._chunk_loss):
        hh.grad = emb.grad = None
        nll, count = fn(hh, emb, ll, tied, cap, -1)
        (0.37 * nll).backward()
        got.append((nll.detach(), count, hh.grad, emb.grad))
    for want, mine in zip(*got):
        assert torch.equal(want, mine)


def test_sequence_cut_is_a_tensor_of_its_own():
    """A rank's block of the positions (``parallel.mesh.split``, the
    residual's cut between blocks) does not share the whole sequence's
    storage, with and without a gradient: under remat a block's output is
    kept for the backward, and a view of it kept every block's whole
    sequence (DBRX ``train_4k``: 30 GB a rank)."""
    from repro_torch.parallel import mesh as mesh_ops
    group = shape_pctx(shape=(1, 1, 4)).mesh.group("model")
    for grad in (False, True):
        x = torch.randn(2, 8, 3, requires_grad=grad)
        part = mesh_ops.split(x, group, 4, 2, dim=1)
        assert torch.equal(part, x[:, 4:6])
        assert part.untyped_storage().data_ptr() != \
            x.untyped_storage().data_ptr()


@pytest.mark.parametrize("variant", ["default", "nofsdp"])
def test_launch_train_nofsdp_trains_replicated(tmp_path, variant):
    """``launch.train`` over 2 data ranks: by default (the reference's
    ``fsdp=True``) the parameters are FSDP-sharded over ``data``; under
    ``--variant nofsdp`` every leaf is replicated; both train."""
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src"), os.environ.get("PYTHONPATH", "")]))
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc-per-node", "2", "-m", "repro_torch.launch.train",
           "--arch", "mistral_nemo_12b", "--smoke", "--device", "cpu",
           "--ep", "2", "--backend", "gloo", "--steps", "2", "--batch", "2",
           "--seq", "16"] + ([] if variant == "default"
                             else ["--variant", variant])
    res = subprocess.run(cmd, env=env, cwd=tmp_path, capture_output=True,
                         text=True, timeout=240)
    out = res.stdout + res.stderr
    assert res.returncode == 0, out[-4000:]
    assert "final loss" in out
    if variant == "default":
        assert "parameters: FSDP over 2 data ranks" in out
    else:
        assert "parameters: replicated over the 2 data-parallel ranks" in out
    from repro_torch.launch import train
    cfg = cbase.get_config("mistral_nemo_12b").reduced()
    pctx = train.variant_context(shape_pctx(shape=(1, 2, 1)), variant if
                                 variant != "default" else "mw", None, cfg,
                                 2, 16)
    assert pctx.fsdp == (variant == "default")
    # ``nosp`` turns sequence parallelism off; the plan policy is "auto"
    # unless pinned
    got = train.variant_context(shape_pctx(shape=(1, 1, 2)), "nosp", None,
                                cfg, 2, 16)
    assert not got.seq_parallel and got.plan_policy == "auto"


def test_multi_pod_on_a_small_world_raises():
    """``launch.train --multi-pod`` and ``launch.mesh.make_pctx`` want the
    512 ranks of (2, 16, 16): on one process each raises the mesh's
    ``ValueError``, as the reference fails without 512 devices."""
    from repro_torch.launch import train
    from repro_torch.launch.mesh import make_pctx
    with pytest.raises(ValueError, match="--pods 2 x --ep 16 x --tp 16"):
        train.main(["--arch", "dbrx_132b", "--smoke", "--device", "cpu",
                    "--multi-pod", "--backend", "gloo"])
    with pytest.raises(ValueError, match="holds 512 ranks"):
        make_pctx(multi_pod=True)
