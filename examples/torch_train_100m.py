"""End-to-end training with the PyTorch/CUDA port: a ~100M-parameter
MoE LM for a few hundred steps on the synthetic pipeline, with
checkpoint/restart fault tolerance.

This exercises every substrate at once: the model (the MoE family: the
paper's dispatch path in its one-device form, the dispatch pack and
flash attention kernels forward and backward on the card), the data
pipeline, the optimizer, the trainer, checkpoints and the straggler
ledger.  The weights are bf16 on the card, fp32 on the CPU.  ``--tiny``
shrinks the model and the run (a test's size).

Run on the card:   PYTHONPATH=src python examples/torch_train_100m.py
On the CPU:        PYTHONPATH=src python examples/torch_train_100m.py \\
                       --device cpu --tiny
"""

import argparse
import time
from pathlib import Path

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.data.pipeline import DataConfig, SyntheticLM, batch_for_model
from repro_torch.device import model_dtype, resolve_device
from repro_torch.models.api import build_model, param_count
from repro_torch.optim import adamw, cosine_schedule
from repro_torch.runtime.trainer import Trainer, TrainerConfig

CKPT_DIR = Path(__file__).resolve().parents[1] / "build" / "torch_train_100m"


def model_config(tiny: bool) -> ModelConfig:
    """~100M parameters: 8 layers, d 512, 8 experts top-2 with a shared
    expert (the Kimi family shrunk); ``tiny``: 2 layers at d 64, 4
    experts."""
    if tiny:
        return ModelConfig(
            name="moe_tiny", family="moe", n_layers=2, d_model=64,
            n_heads=4, n_kv_heads=2, d_ff=128, vocab=512, num_experts=4,
            top_k=2, moe_d_ff=64, n_shared_experts=1, first_k_dense=1,
            moe_capacity=2.0, mlp_gated=True, act="silu",
            tie_embeddings=True)
    return ModelConfig(
        name="moe_100m", family="moe", n_layers=8, d_model=512, n_heads=8,
        n_kv_heads=4, d_ff=2048, vocab=32000, num_experts=8, top_k=2,
        moe_d_ff=1024, n_shared_experts=1, first_k_dense=1,
        moe_capacity=2.0, mlp_gated=True, act="silu", tie_embeddings=True)


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help="cuda (default; raises without one) or cpu")
    ap.add_argument("--tiny", action="store_true",
                    help="a 2-layer model at d 64, 20 steps of 4 x 32 "
                         "tokens at lr 3e-3 (the test's size)")
    ap.add_argument("--steps", type=int)
    ap.add_argument("--batch", type=int)
    ap.add_argument("--seq", type=int)
    ap.add_argument("--lr", type=float)
    ap.add_argument("--ckpt-dir", default=str(CKPT_DIR))
    args = ap.parse_args(argv)
    for key, full, tiny in (("steps", 200, 20), ("batch", 8, 4),
                            ("seq", 256, 32), ("lr", 3e-4, 3e-3)):
        if getattr(args, key) is None:
            setattr(args, key, tiny if args.tiny else full)
    device = resolve_device(args.device)

    cfg = model_config(args.tiny)
    model = build_model(cfg, device=device, dtype=model_dtype(device))
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    params = model.init(gen)
    print(f"model: {cfg.name}  params={param_count(params) / 1e6:.1f}M  "
          f"on {device}")

    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=args.seq,
                                  global_batch=args.batch, seed=7))
    opt = adamw(lr=cosine_schedule(args.lr, warmup=min(20, args.steps // 4),
                                   total=args.steps),
                weight_decay=0.01)
    tcfg = TrainerConfig(total_steps=args.steps,
                         checkpoint_every=max(1, args.steps // 4),
                         checkpoint_dir=args.ckpt_dir,
                         log_every=max(1, args.steps // 10))
    stragglers = []
    trainer = Trainer(
        model, opt,
        lambda s: batch_for_model(cfg, data.batch(s), device=device), tcfg,
        params=params,
        straggler_hook=lambda s, dt: stragglers.append((s, dt)))
    print(f"starting at step {trainer.state.step} "
          f"(resume={'yes' if trainer.state.step else 'no'})")
    t0 = time.monotonic()
    hist = trainer.run()
    wall = time.monotonic() - t0

    n = max(1, min(10, len(hist) // 2))
    first = sum(h["loss"] for h in hist[:n]) / max(len(hist[:n]), 1)
    last = sum(h["loss"] for h in hist[-n:]) / max(len(hist[-n:]), 1)
    toks = args.batch * args.seq * len(hist)
    print(f"\nloss {first:.3f} -> {last:.3f} over {len(hist)} steps "
          f"({wall:.0f}s, {toks / max(wall, 1e-9):.0f} tok/s on {device})")
    print(f"stragglers flagged: {len(stragglers)}; checkpoints in "
          f"{args.ckpt_dir}")
    if hist:
        assert last < first, "loss did not improve"
    print("OK")
    return hist


if __name__ == "__main__":
    main()
