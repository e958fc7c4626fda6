"""Where the serving time goes on the card: a torch.profiler breakdown.

  PYTHONPATH=src python -m repro_torch.launch.profile_serve \
      --arch dbrx_132b --layers 4 --prompts 4 --prompt-len 512 --decode-steps 8
  PYTHONPATH=src python -m repro_torch.launch.profile_serve --arch zamba2_7b
  PYTHONPATH=src python -m repro_torch.launch.profile_serve --arch rwkv6_7b
  PYTHONPATH=src python -m repro_torch.launch.profile_serve --arch gemma2_9b \
      --prompts 2 --prompt-len 8160
  PYTHONPATH=src python -m repro_torch.launch.profile_serve \
      --arch seamless_m4t_medium

(any arch of ``configs.base.ARCH_IDS`` on one rank; Qwen2-VL's prompt
tokens go through the reference's stub frontend, as in ``launch.serve``)

Builds the engine of ``--arch`` as ``launch.serve`` does (published widths,
full depth unless ``--layers`` cuts it, random weights from seed 0) and
warms it up, its decode graph captured by one cohort that then retires, so
that the measured cohorts take its slot and replay the graph.  Then, for
one prefill and for ``--decode-steps`` decode rounds of the engine, and for
as many rounds of an eager loop of the model's own ``decode`` (argmax and a
host copy of the tokens a round, as the engine samples): the wall time per
call without the profiler (host clock around work that ends in a
synchronize), and under ``torch.profiler`` the summed device time of the
kernels, the number of kernels per call and the kernels that take the
most device time.  The device's busy share is that kernel time over the
unprofiled wall.  ``--trace`` writes a Chrome trace of the engine's decode
window.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import collections
import json
import time

import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.data.pipeline import batch_for_model
from repro_torch.launch.serve import build_engine, make_prompts, serve_config

TOP = 12           # kernels listed per phase


def _kernel_events(prof):
    """(name, device microseconds) of every kernel the profiler saw."""
    out = []
    for evt in prof.events():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            out.append((evt.name, evt.time_range.elapsed_us()))
    return out


def _report(label: str, prof, wall_s: float, calls: int) -> dict:
    kernels = _kernel_events(prof)
    busy_us = sum(us for _, us in kernels)
    by_name = collections.defaultdict(lambda: [0.0, 0])
    for name, us in kernels:
        by_name[name][0] += us
        by_name[name][1] += 1
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][0])
    wall_us = wall_s * 1e6
    print(f"{label}: {wall_us / calls / 1e3:.3f} ms wall per call, "
          f"{busy_us / calls / 1e3:.3f} ms of kernels per call, device busy "
          f"{busy_us / wall_us:.3f} of the wall, {len(kernels) / calls:.1f} "
          f"kernel launches per call")
    for name, (us, n) in ranked[:TOP]:
        print(f"  {us / busy_us:7.3%}  {us / calls / 1e3:9.4f} ms/call  "
              f"{n / calls:6.1f} launches/call  {name[:110]}")
    return {"phase": label, "wall_ms": wall_us / calls / 1e3,
            "kernel_ms": busy_us / calls / 1e3,
            "busy_share": busy_us / wall_us,
            "launches_per_call": len(kernels) / calls,
            "top": [{"name": n, "share": us / busy_us,
                     "ms_per_call": us / calls / 1e3}
                    for n, (us, _) in ranked[:TOP]]}


def _timed(fn) -> tuple[object, float]:
    t0 = time.monotonic()
    out = fn()
    torch.cuda.synchronize()
    return out, time.monotonic() - t0


def main(argv=None) -> list:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="dbrx_132b")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the depth (DBRX-132B fits one card at 4)")
    ap.add_argument("--prompts", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=512)
    ap.add_argument("--decode-steps", type=int, default=8)
    ap.add_argument("--trace", default=None,
                    help="write a Chrome trace of the decode window here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_serve: needs a CUDA device")

    cfg = serve_config(args.arch, layers=args.layers, smoke=False)
    max_new = args.decode_steps + 1
    engine = build_engine(cfg, device="cuda", max_new=max_new)
    prompts = make_prompts(cfg, args.prompts, args.prompt_len)
    engine.generate(prompts, max_new=2)                  # warm-up
    torch.cuda.synchronize()
    print(f"{torch.cuda.get_device_name(0)}; {cfg.name} {cfg.n_layers} "
          f"layers; {args.prompts} x {args.prompt_len} prompt tokens")

    def decode_rounds(state, toks):
        for _ in range(args.decode_steps):
            state, toks, _ = engine.step_cohort(state, toks)
        return state, toks

    def prefill():
        return engine.start_cohort(prompts, max_new=max_new)[:2]

    def cohort():
        state, toks = prefill()
        state, toks = decode_rounds(state, toks)
        engine.end_cohort(state)
        return state

    cohort()                                # captures the decode graph
    (state, toks), prefill_wall = _timed(prefill)
    _, decode_wall = _timed(lambda: decode_rounds(state, toks))
    engine.end_cohort(state)
    activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=activities) as prof:
        state, toks = prefill()
        torch.cuda.synchronize()
    results = [_report("prefill", prof, prefill_wall, 1)]
    with profile(activities=activities) as prof:
        state, toks = decode_rounds(state, toks)
        torch.cuda.synchronize()
    engine.end_cohort(state)
    g = engine.stats["decode_graph"]
    results.append(_report(f"decode ({g['mode']})", prof, decode_wall,
                           args.decode_steps))
    if args.trace:
        prof.export_chrome_trace(args.trace)
    if not torch.isfinite(state.logits).all():
        raise RuntimeError("non-finite logits")

    model, params = engine.model, engine.params
    with torch.inference_mode():
        cache = model.init_cache(args.prompts,
                                 args.prompt_len + 2 * args.decode_steps)
        batch = batch_for_model(cfg, {"tokens": prompts}, device="cuda")
        logits, _ = model.prefill(params, batch, cache)
        tok = torch.argmax(logits, dim=-1).to(torch.int32)

        def eager_rounds(tok):
            for _ in range(args.decode_steps):
                logits, _ = model.decode(params, model.decode_batch(tok),
                                         cache)
                tok = torch.argmax(logits, dim=-1).to(torch.int32)
                tok.cpu()
            return tok

        tok, eager_wall = _timed(lambda: eager_rounds(tok))
        with profile(activities=activities) as prof:
            eager_rounds(tok)
            torch.cuda.synchronize()
    results.append(_report("decode (eager loop)", prof, eager_wall,
                           args.decode_steps))
    print(json.dumps(results))
    return results


if __name__ == "__main__":
    main()
