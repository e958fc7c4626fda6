"""The NVIDIA H100's own figures for the planner.

The copied control plane (``topology.py``, ``latency_model.py``,
``planner.py``) keeps the reference's TPU and HCCS constants: they are what
the plan fingerprints of both packages agree on.  What is the card's own
lives here and is passed in where the copies take it as an argument:

- the dense bf16 tensor-core peak, for ``latency_model.expert_compute_time_s``
  (``peak_flops=``), which the reference defaults to ``TPU_PEAK_FLOPS``;
- a fabric spec string for ``topology.parse_fabric`` built from a measured
  per-pair exchange rate.
"""

from __future__ import annotations

from repro_torch.core.latency_model import expert_compute_time_s

# dense bf16 (no sparsity), H100 SXM5 80GB, NVIDIA's H100 data sheet, at
# the part's full 700 W
H100_BF16_PEAK_FLOPS = 989.4e12


def moe_compute_s(tokens_per_rank: int, top_k: int, d_model: int,
                  d_ff: int, tp: int = 1,
                  peak_flops: float = H100_BF16_PEAK_FLOPS) -> float:
    """The overlap context of one MoE layer on the card: the reference's
    ``moe_overlap_compute_s`` (global expert hidden width over the TP
    degree) at the H100's bf16 peak instead of the TPU's."""
    return expert_compute_time_s(tokens_per_rank, top_k, d_model,
                                 max(1, d_ff // max(1, tp)),
                                 peak_flops=peak_flops)


def fabric_spec(pods: int, ep_per_pod: int, pair_bytes_per_s: float,
                pod_bytes_per_s: float | None = None) -> str:
    """``"PxD@INTER:INTRA"`` for ``parse_fabric``: ``pods`` servers of
    ``ep_per_pod`` ranks, one rail a rank, rates in GB/s.  ``INTRA`` is the
    measured per-pair rate; ``INTER`` (the pod link) is the same rate unless
    ``pod_bytes_per_s`` names a slower one.  Rates are written to four
    significant digits."""
    if pair_bytes_per_s <= 0:
        raise ValueError(f"pair rate {pair_bytes_per_s} B/s")
    pod = pair_bytes_per_s if pod_bytes_per_s is None else pod_bytes_per_s

    def gb(rate: float) -> str:
        return f"{rate / 1e9:.4g}"
    return f"{pods}x{ep_per_pod}@{gb(pod)}:{gb(pair_bytes_per_s)}"
