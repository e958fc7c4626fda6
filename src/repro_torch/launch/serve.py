"""Serving launcher: batched greedy generation with the port's ServeEngine.

On the card, with random weights: DBRX-132B at full width with its depth
cut to 4 layers, and Zamba2-7B and RWKV6-7B whole:

  PYTHONPATH=src python -m repro_torch.launch.serve --arch dbrx_132b \
      --layers 4 --prompts 4 --prompt-len 512 --max-new 32
  PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2_7b
  PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6_7b

On the CPU, the reduced config through the kernels' plain versions:

  PYTHONPATH=src python -m repro_torch.launch.serve --arch dbrx_132b \
      --device cpu --smoke --prompt-len 16 --max-new 4
"""

from __future__ import annotations

import argparse
import dataclasses
import json

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, get_config
from repro_torch.device import resolve_device
from repro_torch.models.api import build_model
from repro_torch.runtime.server import ServeConfig, ServeEngine


def serve_config(arch: str, *, layers: int | None, smoke: bool
                 ) -> ModelConfig:
    """The arch's published config with only its depth cut (``layers``),
    or its reduced smoke variant."""
    cfg = get_config(arch)
    if smoke:
        return cfg.reduced()
    if layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    return cfg


def build_engine(cfg: ModelConfig, *, device=None, dtype=torch.bfloat16,
                 seed: int = 0, max_new: int = 32,
                 temperature: float = 0.0) -> ServeEngine:
    """Model with random weights from a seeded generator of ``device``,
    wrapped in a ServeEngine."""
    dev = resolve_device(device)
    model = build_model(cfg, device=dev, dtype=dtype)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    params = model.init(gen)
    return ServeEngine(model, params,
                       ServeConfig(max_new_tokens=max_new,
                                   temperature=temperature), device=dev)


def make_prompts(cfg: ModelConfig, prompts: int, prompt_len: int,
                 seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.vocab,
                        size=(prompts, prompt_len)).astype(np.int32)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True,
                    help="dbrx_132b, zamba2_7b or rwkv6_7b")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the depth to this many layers (widths stay "
                         "the published ones)")
    ap.add_argument("--smoke", action="store_true",
                    help="the arch's reduced config in fp32")
    ap.add_argument("--device", default=None,
                    help="default: cuda (raises without one)")
    ap.add_argument("--prompts", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=512)
    ap.add_argument("--max-new", type=int, default=32)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    cfg = serve_config(args.arch, layers=args.layers, smoke=args.smoke)
    engine = build_engine(
        cfg, device=args.device,
        dtype=torch.float32 if args.smoke else torch.bfloat16,
        seed=args.seed, max_new=args.max_new, temperature=args.temperature)
    prompts = make_prompts(cfg, args.prompts, args.prompt_len, args.seed)
    out = engine.generate(prompts)
    st = engine.stats
    result = {
        "arch": cfg.name, "layers": cfg.n_layers, "device": str(engine.device),
        "shape": list(out.shape), "prefill_s": st["prefill_s"],
        "decode_s": st["decode_s"], "tokens": st["tokens"],
        "nonfinite_logits": st["nonfinite_logits"],
        "first_tokens": out[:, :8].tolist(),
    }
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
