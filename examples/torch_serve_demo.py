"""Serving demo of the PyTorch/CUDA port: batched generation with
prefill + cached decode.

Trains nothing: random weights in small dense, Gemma2, RWKV6
(attention-free) and Zamba2 (hybrid) models (bf16 on the card, fp32 on
the CPU), generated with the
``ServeEngine``, with prefill and decode times and decode tokens/s on the
device; then continuous batching, bit-exact with one-shot generation.

Run on the card:   PYTHONPATH=src python examples/torch_serve_demo.py
On the CPU:        PYTHONPATH=src python examples/torch_serve_demo.py \\
                       --device cpu
"""

import argparse

import numpy as np
import torch

from repro_torch.configs.base import get_config
from repro_torch.device import model_dtype, resolve_device
from repro_torch.models.api import build_model
from repro_torch.runtime.server import ServeConfig, ServeEngine
from repro_torch.serving import (AdmissionController, BatchScheduler,
                                 Request, RequestQueue)

ARCHS = ("mistral_nemo_12b", "gemma2_9b", "rwkv6_7b", "zamba2_7b")


def _model(arch: str, device, width: int):
    cfg = get_config(arch).reduced(n_layers=4, d_model=width, n_heads=4,
                                   d_ff=2 * width, vocab=1024)
    model = build_model(cfg, device=device, dtype=model_dtype(device))
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    return cfg, model, model.init(gen)


def demo(arch: str, device, *, width: int, prompt_len: int,
         max_new: int) -> np.ndarray:
    cfg, model, params = _model(arch, device, width)
    serve = ServeConfig(max_new_tokens=max_new, temperature=0.0,
                        cache_dtype=model_dtype(device))
    engine = ServeEngine(model, params, serve, device=device)
    prompts = np.random.default_rng(1).integers(
        0, cfg.vocab, size=(4, prompt_len)).astype(np.int32)
    out = engine.generate(prompts)
    dec_s = engine.stats["decode_s"]
    print(f"{arch:24s} generated {out.shape} "
          f"prefill={engine.stats['prefill_s'] * 1e3:.0f}ms "
          f"decode={dec_s * 1e3:.0f}ms "
          f"({out.size / max(dec_s, 1e-9):.0f} tok/s decode)")
    engine.close()
    again = ServeEngine(model, params, serve, device=device)
    assert (again.generate(prompts) == out).all(), "not deterministic"
    again.close()
    return out


def demo_continuous(device, *, width: int, prompt_len: int, max_new: int,
                    arch: str = "rwkv6_7b") -> None:
    """Requests arrive staggered, join as cohorts between decode steps
    while earlier cohorts still decode, and leave without a drain
    barrier: the tokens equal one-shot batched generation's (greedy
    rows are independent)."""
    cfg, model, params = _model(arch, device, width)
    engine = ServeEngine(model, params, ServeConfig(
        max_new_tokens=max_new, temperature=0.0,
        cache_dtype=model_dtype(device)),
        device=device)
    prompts = np.random.default_rng(1).integers(
        0, cfg.vocab, size=(6, prompt_len)).astype(np.int32)
    ref = engine.generate(prompts)
    queue = RequestQueue()
    for i in range(prompts.shape[0]):
        queue.push(Request(rid=i, arrival_s=0.003 * i, prompt=prompts[i],
                           max_new=max_new))
    sched = BatchScheduler(
        queue=queue,
        # capacity 3 forces several cohorts
        admission=AdmissionController(capacity=3, policy="greedy"),
        engine=engine, eos_id=engine.cfg.eos_id, seed=0)
    sched.run_until_drained()
    out = np.zeros_like(ref)
    for req in sched.completed:
        toks = req.tokens[:max_new]
        out[req.rid, :len(toks)] = toks
    assert (out == ref).all(), "continuous batching diverged from one-shot"
    rep = sched.report()
    print(f"{arch:24s} continuous: {rep['completed']} request(s), "
          f"{rep['iterations']} iteration(s), max in-flight "
          f"{rep['max_in_flight']} (capacity 3), bit-exact vs one-shot")
    engine.close()


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help="cuda (default; raises without one) or cpu")
    ap.add_argument("--width", type=int, default=256,
                    help="d_model, over 4 heads (on the card the attention "
                         "kernel takes head_dim 64, 112, 128 or 256)")
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--max-new", type=int, default=16)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    size = dict(width=args.width, prompt_len=args.prompt_len,
                max_new=args.max_new)
    for arch in ARCHS:
        demo(arch, device, **size)
    demo_continuous(device, **size)
    print("OK: every family serves deterministically; continuous batching "
          "is bit-exact with one-shot generation.")


if __name__ == "__main__":
    main()
