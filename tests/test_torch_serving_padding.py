"""Continuous serving over data-parallel ranks with cohorts that do not
divide over them.

The scheduler forms cohorts of whatever has arrived; over 4 gloo ranks
(2 pods x 2 ep) a cohort of 1, 2 or 3 rows is padded to a multiple of the
ranks, the padding rows are routed as invalid through the first pack's
``valid`` input (so they take no expert capacity) and their samples are
dropped.  Every real row's greedy tokens equal the one-rank engine's.
"""

import tempfile
import types

import numpy as np
import torch

from repro_torch.launch import ranks
from repro_torch.launch import serve as serve_cli
from repro_torch.runtime.server import ServeEngine

CONT = dict(requests=9, prompt_len=8, max_new=4, rate=3000.0, capacity=8,
            group=1)


def test_padding_rows_over_dp_ranks():
    """The rows a rank takes of a batch of 5 over 4 data-parallel ranks:
    two each, the three padding rows zeros and not valid."""
    eng = ServeEngine.__new__(ServeEngine)
    rows = np.arange(10, 15, dtype=np.int32)[:, None]
    taken, valid = [], []
    for idx in range(4):
        eng.pctx = types.SimpleNamespace(dp_size=4, dp_index=idx)
        taken.append(eng._my_rows(rows))
        valid.append(eng._my_valid(len(rows)))
    assert np.concatenate(taken)[:, 0].tolist() == [10, 11, 12, 13, 14, 0,
                                                    0, 0]
    assert np.concatenate(valid).tolist() == [True] * 5 + [False] * 3
    u = eng._my_rows(torch.arange(5.0))            # the sampler's uniforms
    assert u.tolist() == [0.0, 0.0]


def test_ungrouped_stream_over_ranks_equals_one_rank():
    cfg = serve_cli.serve_config("dbrx_132b", layers=None, smoke=True)
    with tempfile.TemporaryDirectory() as tmp:
        spec = dict(world=4, pods=2, ep=2, backend="gloo", device="cpu",
                    init_method=f"file://{tmp}/store", timeout_s=120,
                    out_dir=f"{tmp}/out", threads=1, cfg=cfg,
                    dtype=torch.float32, cache_dtype=torch.float32, seed=0,
                    prompts=serve_cli.make_prompts(cfg, 4, 8), max_new=3,
                    runs=[dict(scheme="hierarchical",
                               combine="hierarchical")],
                    continuous=CONT)
        results = ranks.run_ranks(ranks.serve_worker, spec, timeout_s=300)
    c0 = results[0]["continuous"]
    assert c0["report"]["completed"] == CONT["requests"]
    assert all(r["continuous"]["tokens"] == c0["tokens"] for r in results)
    # a cohort of one row (the join wave the ranks once refused), and
    # others that do not divide over the 4 ranks
    assert 1 in c0["cohorts"]
    assert any(n % 4 for n in c0["cohorts"])

    reqs = ranks.grouped_requests(
        cfg, requests=CONT["requests"], group=1,
        prompt_len=CONT["prompt_len"], max_new=CONT["max_new"],
        rate=CONT["rate"], seed=0)
    engine = serve_cli.build_engine(cfg, device="cpu", dtype=torch.float32,
                                    seed=0, max_new=CONT["max_new"],
                                    cache_dtype=torch.float32)
    one = engine.generate(np.stack([r.prompt for r in reqs]))
    for r in reqs:
        assert c0["tokens"][r.rid] == one[r.rid].tolist(), r.rid
