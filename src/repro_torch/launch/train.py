"""Training launcher on one rank.

On the CPU, the reduced config in fp32 through the kernels' plain versions
(batch 4 x 64, as the reference's ``--smoke``):

  PYTHONPATH=src python -m repro_torch.launch.train --arch dbrx_132b \
      --smoke --device cpu --steps 3

On the card the model is bf16 at the arch's full width; one card cannot
hold ``train_4k``'s 256 x 4096, so ``--batch`` and ``--seq`` cut it, and
``--layers`` cuts the depth:

  PYTHONPATH=src python -m repro_torch.launch.train --arch dbrx_132b \
      --layers 2 --batch 4 --seq 512 --steps 8

AdamW on the reference's cosine schedule, weight decay 0.01, parameters
and optimizer state in the model's dtype; ``SyntheticLM`` batches from
``--seed``; checkpoints every ``--ckpt-every`` steps under ``--ckpt-dir``
(a run resumes from the latest one there).  ``--grad-accum N`` splits each
batch into N micro-batches whose fp32 gradients are summed (the
reference's launcher takes the flag and leaves it unused).  The mesh
options (``--multi-pod``, ``--variant``, ``--fabric``, ``--plan-policy``,
``--calibrate``) are training over ranks, which is not ported yet.
"""

from __future__ import annotations

import argparse
import dataclasses
import logging

import torch

from repro_torch.configs.base import SHAPES, get_config
from repro_torch.data.pipeline import DataConfig, SyntheticLM, batch_for_model
from repro_torch.device import resolve_device
from repro_torch.models.api import build_model
from repro_torch.optim import adamw, cosine_schedule
from repro_torch.runtime.trainer import Trainer, TrainerConfig, \
    make_train_step
from repro_torch.telemetry.exporter import (add_metrics_args,
                                            finish_exporter_from_args,
                                            start_exporter_from_args)


def train_config(arch: str, *, smoke: bool, layers: int | None):
    """The arch's config with its depth cut (``layers``), or the reduced
    smoke variant."""
    cfg = get_config(arch)
    if smoke:
        return cfg.reduced()
    if layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    return cfg


def micro_batches(batch: dict, grad_accum: int) -> dict:
    """[B, ...] leaves as [grad_accum, B / grad_accum, ...]."""
    if grad_accum == 1:
        return batch
    return {k: v.reshape(grad_accum, v.shape[0] // grad_accum,
                         *v.shape[1:]) for k, v in batch.items()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config, fp32, batch 4 x 64")
    ap.add_argument("--device", default=None,
                    help="default: CUDA (raises without one); 'cpu' runs "
                         "the plain versions")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the depth (full width)")
    ap.add_argument("--batch", type=int, default=None,
                    help="global batch (default: the shape's)")
    ap.add_argument("--seq", type=int, default=None,
                    help="sequence length (default: the shape's)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--seed", type=int, default=0)
    for flag in ("--multi-pod", "--variant", "--fabric", "--plan-policy",
                 "--calibrate"):
        ap.add_argument(flag, nargs="?", const=True, default=None,
                        help="training over ranks: not ported yet")
    add_metrics_args(ap)
    args = ap.parse_args(argv)
    for flag in ("multi_pod", "variant", "fabric", "plan_policy",
                 "calibrate"):
        if getattr(args, flag) is not None:
            raise NotImplementedError(
                f"--{flag.replace('_', '-')}: training over a mesh is not "
                f"ported yet (ROADMAP item 8b)")
    logging.basicConfig(level=logging.INFO)
    exporter = start_exporter_from_args(args)

    dev = resolve_device(args.device)
    cfg = train_config(args.arch, smoke=args.smoke, layers=args.layers)
    if args.smoke:
        batch, seq, dtype = 4, 64, torch.float32
    else:
        shape = SHAPES[args.shape]
        batch = args.batch or shape.global_batch
        seq = args.seq or shape.seq_len
        dtype = torch.bfloat16
    if batch % args.grad_accum:
        raise ValueError(f"batch {batch} does not split into "
                         f"{args.grad_accum} micro-batches")
    model = build_model(cfg, device=dev, dtype=dtype)
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=seq,
                                  global_batch=batch, seed=args.seed))
    opt = adamw(lr=cosine_schedule(args.lr, warmup=min(100, args.steps // 10
                                                       or 1),
                                   total=args.steps), weight_decay=0.01)
    tcfg = TrainerConfig(total_steps=args.steps,
                         checkpoint_every=args.ckpt_every,
                         checkpoint_dir=args.ckpt_dir, log_every=10)
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)
    trainer = Trainer(
        model, opt,
        lambda s: micro_batches(batch_for_model(cfg, data.batch(s),
                                                device=dev), args.grad_accum),
        tcfg, generator=gen,
        train_step=make_train_step(model, opt, grad_accum=args.grad_accum))
    hist = trainer.run()
    if hist:
        print(f"final loss {hist[-1]['loss']:.4f} over {len(hist)} steps; "
              f"straggler events: {len(trainer.ledger.events)}")
    finish_exporter_from_args(args, exporter)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
