"""The card transport (``parallel.mesh.CardGroup``) against gloo on the
same CPU processes: 4 gloo ranks spawned by ``repro_torch.launch.ranks``
(``card_transport_worker``) build meshes over both transports, and the
card transport's host flavour (host shared memory) runs the code the card
runs on CUDA tensors, the staging buffers aside.

- each of the five exchanges over whole axes, the data-parallel pair, a
  split-TP domain of the model axis and a dp server group: the byte movers
  (all_to_all, all_gather, ppermute) bit for bit against gloo's; the sums
  (all_reduce, reduce_scatter) the same bits on every rank and equal to
  the sum in group-rank order computed here, within the recursive
  summation bound of the fp64 sum; large inputs in pieces of 4 KB;
- every differentiable exchange of ``ranks.EXCHANGES`` and its gradient
  through the card transport against gloo's (the movers bit for bit, the
  sums within fp32 sum order);
- a reduced DBRX served over 2 x 2: tokens and every step's logits equal
  to gloo's;
- a reduced DBRX training step over (1, 2, 2) under FSDP: the loss and
  every gradient equal to gloo's within fp32 sum order (rtol 1e-6);
- a card transport spec whose ranks span two devices raises, as do a
  backend other than gloo and an unknown transport; decode under the card
  transport is eager.
"""

import dataclasses
from pathlib import Path
from unittest import mock

import numpy as np
import pytest
import torch

from repro_torch.configs.base import get_config
from repro_torch.launch import ranks
from repro_torch.parallel import mesh as mesh_ops
from repro_torch.runtime.graphs import decode_mode

WORLD = 4
SPAWN_TIMEOUT_S = 300
PIECE = 4096                  # the card transport's piece in these runs
FSDP_RTOL = 1e-6              # fp32 sum order: 4 ranks' sums reordered
# name, kind, mesh, axis, members, a member's input shape, dtype
CASES = (
    ("a2a pod", "all_to_all", (2, 2, 1), "pod", None, (2, 33, 7),
     "bfloat16"),
    ("a2a data ids", "all_to_all", (2, 2, 1), "data", None, (2, 40, 4),
     "int32"),
    ("a2a dp valid", "all_to_all", (2, 2, 1), ("pod", "data"), None,
     (4, 9), "bool"),
    ("a2a dp pieces", "all_to_all", (2, 2, 1), ("pod", "data"), None,
     (4, 700, 3), "float32"),
    ("gather data", "all_gather", (2, 2, 1), "data", None, (6, 5),
     "float32"),
    ("gather pieces", "all_gather", (1, 1, 4), "model", None, (3000,),
     "bfloat16"),
    ("gather split-TP domain", "all_gather", (1, 1, 4), "model",
     ((0, 1), (2, 3)), (4, 8, 5), "bfloat16"),
    ("gather split-TP cross", "all_gather", (1, 1, 4), "model",
     ((0, 2), (1, 3)), (4, 8, 5), "bfloat16"),
    ("gather dp server", "all_gather", (2, 2, 1), ("pod", "data"),
     ((0, 1), (2, 3)), (3, 2), "float32"),
    ("permute model", "ppermute", (1, 1, 4), "model", None, (3, 4),
     "int32"),
    ("permute pieces", "ppermute", (1, 1, 4), "model", None, (2100,),
     "float32"),
    ("reduce-scatter data", "reduce_scatter", (2, 2, 1), "data", None,
     (2, 50, 3), "float32"),
    ("reduce-scatter pieces", "reduce_scatter", (1, 1, 4), "model", None,
     (4, 2000), "float32"),
    ("reduce-scatter bf16", "reduce_scatter", (2, 2, 1), ("pod", "data"),
     None, (4, 64), "bfloat16"),
    ("all-reduce world pieces", "all_reduce", (1, 1, 4), "model", None,
     (5000,), "float32"),
    ("all-reduce pod", "all_reduce", (2, 2, 1), "pod", None, (7, 3),
     "float32"),
    ("all-reduce split-TP", "all_reduce", (1, 1, 4), "model",
     ((0, 1), (2, 3)), (33,), "bfloat16"),
)
MOVERS = [c[0] for c in CASES if c[1] in ("all_to_all", "all_gather",
                                          "ppermute")]
SUMS = [c[0] for c in CASES if c[1] in ("all_reduce", "reduce_scatter")]


def _cases() -> list:
    return [dict(name=n, kind=k, mesh=m, axis=a, members=mem, shape=s,
                 dtype=d) for n, k, m, a, mem, s, d in CASES]


def _exchange_inputs() -> dict:
    """``ranks.exchange_worker``'s inputs: x [4, 4, 3] and each exchange's
    per-rank cotangent, from a numpy seed."""
    rng = np.random.default_rng(21)
    xs = (4, 3)
    x = rng.normal(size=(WORLD,) + xs).astype(np.float32)
    shapes = {"all_to_all": xs, "all_gather": (WORLD,) + xs,
              "ppermute": xs, "reduce_scatter": xs[1:], "mean": xs,
              "gather_reference": (2,) + xs, "gather_paired": (2,) + xs,
              "gather_full": (2,) + xs}
    out = {"x": x}
    for name in ranks.EXCHANGES:
        out[f"{name}/ct"] = rng.normal(size=(WORLD,) + shapes[name]
                                       ).astype(np.float32)
    return out


def _dbrx():
    return dataclasses.replace(get_config("dbrx_132b").reduced(),
                               moe_capacity=4.0)


@pytest.fixture(scope="module")
def checked(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("card")
    np.savez(tmp / "exchanges.npz", **_exchange_inputs())
    cfg = _dbrx()
    prompts = np.random.default_rng(2).integers(
        0, cfg.vocab, size=(WORLD, 8)).astype(np.int32)
    spec = dict(
        world=WORLD, pods=1, ep=1, tp=WORLD, backend="gloo", device="cpu",
        init_method=f"file://{tmp / 'store'}", timeout_s=120,
        out_dir=str(tmp / "out"), threads=1, dp_servers=(2,),
        piece_bytes=PIECE, cases=_cases(), barriers=100,
        exchanges=str(tmp / "exchanges.npz"),
        serve=dict(cfg=cfg, dtype=torch.float32, cache_dtype=torch.float32,
                   seed=3, prompts=prompts, max_new=4, keep_logits=True,
                   runs=ranks.fixed_runs(ranks.SCHEME_PAIRS[::2])),
        train=dict(cfg=cfg, dtype=torch.float32, seed=0, batch=4, seq=16,
                   steps=1, lr=1e-3, dp_servers=(),
                   runs=[dict(label="fsdp", grads=True)]))
    return ranks.run_ranks(ranks.card_transport_worker, spec,
                           timeout_s=SPAWN_TIMEOUT_S)


def _member_inputs(case: dict, n: int) -> list:
    return [ranks.case_input(case, m, torch.device("cpu")) for m in
            range(n)]


@pytest.mark.parametrize("name", MOVERS)
def test_byte_movers_bit_exact_against_gloo(checked, name):
    for r in checked:
        got = r["check"]["cases"][name]
        assert got["same_bits"], f"rank {r['rank']}: {got}"


@pytest.mark.parametrize("name", SUMS)
def test_sums_in_group_rank_order_on_every_rank(checked, name):
    """Every member of a group holds the same bits (an all-reduce's digest
    on every member; each member's reduce-scatter block), the sum of the
    members' inputs added in group-rank order (drawn again here), within
    ``(n - 1) u sum|x|`` of the fp64 sum."""
    index = [c[0] for c in CASES].index(name)
    case = dict(_cases()[index], index=index)
    by_group: dict = {}
    for r in checked:
        got = r["check"]["cases"][name]
        assert got["rank_order"] and got["over_bound"] == 0, got
        by_group.setdefault(tuple(got["group"]), []).append(
            (r["rank"], got))
    if case["kind"] == "all_reduce":
        for members in by_group.values():
            assert len({g["digest"] for _, g in members}) == 1
    for group, members in by_group.items():
        parts = _member_inputs(case, len(group))
        for rank, got in members:
            me = group.index(rank)
            blocks = [p[me] for p in parts] if case["kind"] == \
                "reduce_scatter" else parts
            want = blocks[0].clone()
            for b in blocks[1:]:
                want += b
            import hashlib
            assert got["digest"] == hashlib.sha256(
                want.contiguous().view(torch.uint8).numpy().tobytes()
            ).hexdigest(), f"{name} rank {rank}"


def test_barrier_and_staging_recorded(checked):
    for r in checked:
        b = r["check"]["barrier_us"]
        assert b["card"] > 0 and b["gloo"] > 0
        staging = r["check"]["staging"]
        assert set(staging) == {"(1, 1, 4)", "(2, 2, 1)"}
        assert all(s["card"] == 0 and s["host"] > 0
                   for s in staging.values())


@pytest.mark.parametrize("name", list(ranks.EXCHANGES))
def test_autograd_transposes_against_gloo(checked, name):
    """Each exchange and its input's gradient: the same bits where only
    bytes move (the all_to_all, the gathers forward, the ppermute both
    ways), within fp32 sum order where a sum enters."""
    moves_only = name in ("all_to_all", "ppermute")
    for r in checked:
        gloo, card = (r["exchanges"][k][name] for k in ("gloo", "card"))
        for key in ("y", "dx"):
            if moves_only or (key == "y" and name.startswith("gather")
                              or key == "y" and name == "all_gather"):
                np.testing.assert_array_equal(card[key], gloo[key],
                                              err_msg=f"{name} {key}")
            else:
                np.testing.assert_allclose(card[key], gloo[key],
                                           rtol=1e-6, atol=1e-6,
                                           err_msg=f"{name} {key}")


def test_served_dbrx_equal_to_gloo(checked):
    for r in checked:
        gloo, card = (r["serve"][k] for k in ("gloo", "card"))
        assert set(card["runs"]) == set(gloo["runs"]) and card["runs"]
        for label, run in card["runs"].items():
            other = gloo["runs"][label]
            np.testing.assert_array_equal(run["tokens"], other["tokens"])
            assert len(run["step_logits"]) == 4
            for a, b in zip(run["step_logits"], other["step_logits"]):
                assert torch.equal(a, b), f"{label} rank {r['rank']}"
            assert run["decode_graph"]["mode"] == "eager"


def test_fsdp_training_step_equal_to_gloo(checked):
    r0 = checked[0]
    gloo, card = (r0["train"][k]["runs"]["fsdp"] for k in ("gloo", "card"))
    assert card["fsdp"] and card["fsdp"] == gloo["fsdp"]
    for key, val in gloo["step0"].items():
        np.testing.assert_allclose(card["step0"][key], val, rtol=FSDP_RTOL,
                                   err_msg=key)
    assert set(card["grads"]) == set(gloo["grads"]) and card["grads"]
    for name, g in card["grads"].items():
        np.testing.assert_allclose(g, gloo["grads"][name], rtol=FSDP_RTOL,
                                   atol=FSDP_RTOL * float(
                                       np.abs(gloo["grads"][name]).max()),
                                   err_msg=name)


def _spec(**kw) -> dict:
    return dict(dict(world=4, backend="gloo", device="cuda",
                     transport="card"), **kw)


def test_card_spec_over_two_devices_raises():
    with mock.patch.object(torch.cuda, "device_count", return_value=2):
        with pytest.raises(ValueError, match="one device"):
            ranks.transport_of(_spec())
    assert ranks.transport_of(_spec(device="cpu")) == "card"
    assert ranks.transport_of(_spec(device="cuda:0")) == "card"


@pytest.mark.parametrize("bad", [dict(backend="nccl"),
                                 dict(transport="shm")])
def test_card_spec_other_backend_or_transport_raises(bad):
    with pytest.raises(ValueError):
        ranks.transport_of(_spec(**bad))


def test_decode_under_card_transport_is_eager():
    card = type("Ctx", (), {"mesh": type("M", (), {"transport": "card"})})
    mode, reason = decode_mode(torch.device("cuda"), card)
    assert mode == "eager" and "barrier" in reason
    assert mesh_ops.process_group("a group") == "a group"
