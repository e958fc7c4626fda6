"""The port's ``LiveProbe`` over gloo CPU ranks.

The counterpart of ``tests/multidev/check_collectives.py``'s
``run_live_probe_checks``: 8 spawned ranks (``repro_torch.launch.ranks.
probe_worker``, meeting through a ``file://`` store under the test's
temporary directory) lay out 2 pods x 2 ep ranks x 2 model ranks and run
one startup calibration on the paper's two-server fabric of 2 x 2 NPUs,
at tiny payloads and one repeat: every executable plan of the AllGather
(over the model axis), the dispatch and the combine (over pod x ep) is
timed, and both rail directions come out of ``probe_link_directions`` at
the calibration's own sweep (``directions``).
Every rank returns the same walls to the bit; a deadline far below any
wall makes every rank skip every record; the dispatch probe hands the
dispatch the bytes its ledger charges; every pack of the probes equals its
plain version; and a failure-detector scan through the single-rail
``linkprobe`` declares no rail dead.
"""

from pathlib import Path

import numpy as np
import pytest

from repro_torch.core import plan as plan_ir
from repro_torch.core import schedules  # noqa: F401  (registers the plans)
from repro_torch.core.topology import two_server_cluster
from repro_torch.launch import ranks

MESH = (2, 2, 2)                    # pods x ep x model
WORLD = 8
TOKEN_BYTES = 512
SCENARIO = dict(num_experts=16, top_k=4, token_bytes=TOKEN_BYTES)
PAYLOADS = {"allgather": (1 << 14, 1 << 16, 1 << 18),
            "dispatch": tuple(n * TOKEN_BYTES for n in (8, 32, 64)),
            "combine": tuple(n * TOKEN_BYTES for n in (8, 32, 64))}
OPS = ("allgather", "dispatch", "combine")
# the directed rail probes' sweep (the calibration's ``directions``)
DIRECTIONS = (1 << 14, 1 << 16, 1 << 18, 1 << 20)
SPAWN_TIMEOUT_S = 120


@pytest.fixture(scope="module")
def probed(tmp_path_factory):
    tmp = Path(tmp_path_factory.mktemp("live_probe"))
    pods, ep, tp = MESH
    spec = dict(
        world=WORLD, pods=pods, ep=ep, tp=tp, backend="gloo", device="cpu",
        init_method=f"file://{tmp / 'store'}", timeout_s=60,
        out_dir=str(tmp / "out"), threads=1,
        topo=two_server_cluster(npus_per_server=2, num_servers=2),
        calibrate=dict(ops=OPS, payloads=PAYLOADS, repeats=1,
                       check_packs=True, scenario=SCENARIO,
                       directions=DIRECTIONS),
        dispatch_bytes=True, scan=True,
        timeout=dict(timeout_s=1e-9, ops=("dispatch", "allgather"),
                     payloads=PAYLOADS, scenario=SCENARIO))
    return ranks.run_ranks(ranks.probe_worker, spec,
                           timeout_s=SPAWN_TIMEOUT_S)


@pytest.mark.parametrize("op", OPS)
def test_every_executable_plan_is_timed(probed, op):
    records = [r for r in probed[0]["calibration"]["records"]
               if r["op"] == op]
    want = {(p.name, float(b)) for p in plan_ir.plans_for(
        op, executable_only=True) for b in PAYLOADS[op]}
    assert {(r["plan"], r["payload_bytes"]) for r in records} == want
    assert all(r["source"] == "live" and np.isfinite(r["measured_s"])
               and r["measured_s"] > 0 for r in records)
    assert probed[0]["calibration"]["failures"] == 0


def test_link_directions_cover_both_rails(probed):
    roles = sorted({r["bottleneck_role"]
                    for r in probed[0]["calibration"]["records"]
                    if r["op"] == "linkprobe"})
    assert roles == ["inter:0>1", "inter:1>0"]


def test_link_directions_sweep_the_given_payloads(probed):
    for role in ("inter:0>1", "inter:1>0"):
        got = sorted(r["payload_bytes"]
                     for r in probed[0]["calibration"]["records"]
                     if r["op"] == "linkprobe"
                     and r["bottleneck_role"] == role)
        assert got == [float(b) for b in DIRECTIONS], role


def test_walls_are_bit_identical_on_every_rank(probed):
    def walls(res):
        return [np.float64(r["measured_s"]).tobytes()
                for r in res["calibration"]["records"]]
    assert len(walls(probed[0])) > 0
    for res in probed[1:]:
        assert walls(res) == walls(probed[0])
        assert res["calibration"]["hw"] == probed[0]["calibration"]["hw"]


def test_deadline_skips_the_same_records_on_every_rank(probed):
    plans = sum(len(plan_ir.plans_for(op, executable_only=True))
                * len(PAYLOADS[op]) for op in ("dispatch", "allgather"))
    for res in probed:
        assert res["timeout"] == {"records": 0, "failures": plans}


def test_dispatch_probe_moves_the_ledger_bytes(probed):
    """Each dispatch probe hands the dispatch ``payload / token_bytes``
    rows a rank of ``token_bytes`` each: the bytes its ledger was simulated
    at (the reference's probe sends 4-byte columns, capped at 1024)."""
    calls = probed[0]["dispatch_calls"]
    assert calls
    assert {rows * row_bytes for rows, row_bytes in calls} == set(
        PAYLOADS["dispatch"]) | set(PAYLOADS["combine"])
    assert {row_bytes for _, row_bytes in calls} == {TOKEN_BYTES}


def test_probe_packs_equal_their_plain_version(probed):
    for res in probed:
        packs = res["calibration"]["packs"]
        assert packs and all(exact for *_, exact in packs)


def test_rail_scan_declares_no_dead_link(probed):
    for res in probed:
        assert res["scan"] == {"changed": False, "rails": 4, "dead": []}
