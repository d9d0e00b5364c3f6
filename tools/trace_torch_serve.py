#!/usr/bin/env python3
"""Where a prefill and a decode step of the PyTorch port's serving path
spend their time.

    python3 tools/trace_torch_serve.py [serve flags] [--trace-steps N]

Sets up the same path as `repro_torch.launch.serve` (defaults: the
chip run's ``gpt2-xl-paper`` at full width and depth, batch 8, prompt
128, ``--stages 2 --mode aqsgd --fw-bits 4 --kv-bits 8``; for gemma2-9b
add ``--arch gemma2-9b --batch 2 --prompt-len 8160``), with the
launcher's weights and prompt (drawn from a CPU generator seeded with
``--seed``, so the traced model is the served one), prefills once to
warm up, times and traces a second prefill into fresh caches (the
``prefill`` entry), warms up two decode steps, then traces
``--trace-steps`` steady decode steps under `torch.profiler` and prints
one JSON object:

* ``step_ms``: host wall time per step (synchronized), the ground truth;
* ``device_busy_ms``: per step, the union of the CUDA kernels' device
  intervals; ``device_idle_share`` = 1 - busy / wall;
* ``kernel_launches``: device kernels per step;
* ``top_kernels``: device time per step by kernel name;
  ``most_launched``: the kernels launched most often a step;
* ``top_host_ops``: self host time per step by PyTorch op;
* ``prefill``: the same keys for one prefill;
* ``build_s``: the model build, weights drawn on the host (gemma2-9b's
  9.24e9 take about a minute).

With ``--continuous`` (and ``--slots``, ``--gen``) it traces the
continuous batcher's pooled tick instead: the launcher's request stream
(`repro_torch.launch.serve.submit_stream`) fills the slots by one
admission round, two ticks warm up, and ``--trace-steps`` ticks
(`ContinuousBatcher.step`, each ending in its host read of the tokens)
are timed and traced; ``prefill`` is then absent.

The traced run pays the profiler's own cost: ``step_ms_untraced`` is the
same steps timed without it.  Needs a CUDA device.
"""
from __future__ import annotations

import json
import os
import sys
import time
from collections import defaultdict

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

DEFAULTS = ["--arch", "gpt2-xl-paper", "--stages", "2", "--mode", "aqsgd",
            "--fw-bits", "4", "--kv-bits", "8", "--batch", "8",
            "--prompt-len", "128"]


def _union_ms(intervals) -> float:
    total, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b > end:
            total += b - max(a, end)
            end = b
    return total / 1e3


def main(argv=None) -> dict:
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.comm import config as comm_cli
    from repro_torch.configs.base import get_config
    from repro_torch.launch import serve
    from repro_torch.models.model import Transformer
    from repro_torch.serving import DeltaHopCodec, KVCodec

    ap = serve.build_parser()
    ap.add_argument("--trace-steps", type=int, default=8)
    args = ap.parse_args(DEFAULTS + list(sys.argv[1:] if argv is None
                                         else argv))
    dev = serve.resolve_device(args.device)
    if dev.type != "cuda":
        raise RuntimeError("the trace measures the card: run with a CUDA "
                           "device")
    comm = comm_cli.from_args(args)
    cfg = get_config(args.arch, smoke=args.smoke)
    kv = KVCodec.from_comm(comm)
    hop = DeltaHopCodec.from_comm(comm) if args.stages > 1 else None
    # the launcher's model and prompt: weights, then the prompt, from one
    # CPU generator, so a seed gives the same numbers on any device
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    gen = torch.Generator().manual_seed(args.seed)
    model = Transformer(cfg, device=dev, generator=gen)
    torch.cuda.synchronize(dev)
    build_s = time.perf_counter() - t0
    if args.continuous:
        return _trace_ticks(args, model, kv, hop, build_s)
    steps = 4 + 2 * args.trace_steps
    kw = dict(logits_last_only=True, num_stages=args.stages,
              kv_codec=kv if kv.bits else None)
    tokens = torch.randint(0, cfg.vocab_size, (args.batch, args.prompt_len),
                           generator=gen).to(dev)

    def prefill():
        caches = model.init_caches(args.batch, args.prompt_len + steps,
                                   torch.float32, kv_codec=kv)
        if hop is not None:
            caches["hop_m"] = hop.init_state(args.stages - 1, args.batch,
                                             cfg.d_model, device=dev)["m"]
        out = model.forward_with_caches(
            tokens, caches, boundary_fn=hop and hop.boundary_fn(
                prefill=True), **kw)
        torch.cuda.synchronize(dev)
        return out

    prefill()                                   # warm-up
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    prefill()
    prefill_untraced = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof_prefill:
        t0 = time.perf_counter()
        logits, caches = prefill()
        prefill_wall = (time.perf_counter() - t0) * 1e3
    bfn = hop and hop.boundary_fn(prefill=False)

    def decode(n):
        nonlocal logits, caches
        for _ in range(n):
            tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
            logits, caches = model.forward_with_caches(
                tok, caches, boundary_fn=bfn, **kw)
        torch.cuda.synchronize(dev)

    decode(2)                                   # warm-up
    t0 = time.perf_counter()
    decode(args.trace_steps)
    untraced = (time.perf_counter() - t0) * 1e3 / args.trace_steps
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        decode(args.trace_steps)
        wall = (time.perf_counter() - t0) * 1e3 / args.trace_steps

    out = {
        "device": torch.cuda.get_device_name(dev),
        "config": {k: getattr(args, k) for k in (
            "arch", "smoke", "stages", "mode", "fw_bits", "kv_bits", "batch",
            "prompt_len")},
        "build_s": build_s, "trace_steps": args.trace_steps,
        "step_ms_untraced": untraced,
        "step_ms": wall, **_summary(prof, args.trace_steps, wall, "step"),
        "prefill": {"ms_untraced": prefill_untraced, "ms": prefill_wall,
                    **_summary(prof_prefill, 1, prefill_wall, "prefill")},
    }
    print(json.dumps(out, indent=1))
    return out


def _trace_ticks(args, model, kv, hop, build_s: float) -> dict:
    """Time and trace ``args.trace_steps`` pooled ticks of the
    continuous batcher (see the module docstring)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.launch import serve
    from repro_torch.serving import ContinuousBatcher

    if 2 + 2 * args.trace_steps >= args.gen:
        raise ValueError(f"--gen {args.gen} ends requests inside the "
                         f"{2 + 2 * args.trace_steps} ticks traced")
    bat = ContinuousBatcher(model, num_slots=args.slots or args.batch,
                            cache_len=args.prompt_len + args.gen,
                            kv_codec=kv if kv.bits else None, hop_codec=hop,
                            num_stages=args.stages)
    serve.submit_stream(bat, args)
    bat._admit()                                # one admission round

    def ticks(n):
        for _ in range(n):
            bat.step()

    ticks(2)                                    # warm-up
    t0 = time.perf_counter()
    ticks(args.trace_steps)
    untraced = (time.perf_counter() - t0) * 1e3 / args.trace_steps
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        ticks(args.trace_steps)
        wall = (time.perf_counter() - t0) * 1e3 / args.trace_steps
    out = {
        "device": torch.cuda.get_device_name(bat.device),
        "config": {k: getattr(args, k) for k in (
            "arch", "smoke", "stages", "mode", "fw_bits", "kv_bits", "batch",
            "slots", "prompt_len", "gen")},
        "build_s": build_s, "trace_steps": args.trace_steps,
        "active_slots": sum(r is not None for r in bat._slots),
        "step_ms_untraced": untraced,
        "step_ms": wall, **_summary(prof, args.trace_steps, wall, "step"),
    }
    print(json.dumps(out, indent=1))
    return out


def _summary(prof, n: int, wall_ms: float, unit: str) -> dict:
    """Device busy time, idle share, kernels and host ops per ``unit``
    (one of ``n`` traced repetitions of ``wall_ms`` each)."""
    from torch.autograd import DeviceType
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy = _union_ms((e.time_range.start, e.time_range.end)
                     for e in kernels) / n
    by_kernel = defaultdict(lambda: [0.0, 0])
    for e in kernels:
        by_kernel[e.name][0] += e.time_range.elapsed_us() / 1e3 / n
        by_kernel[e.name][1] += 1
    host = sorted(((e.key, e.self_cpu_time_total / 1e3 / n, e.count // n)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CPU),
                  key=lambda r: -r[1])
    return {
        "device_busy_ms": busy, "device_idle_share": 1.0 - busy / wall_ms,
        "kernel_launches": len(kernels) / n,
        "top_kernels": [{"name": k[:90], "ms": v[0], f"per_{unit}": v[1] / n}
                        for k, v in sorted(by_kernel.items(),
                                           key=lambda kv: -kv[1][0])[:10]],
        "most_launched": [{"name": k[:90], f"per_{unit}": v[1] / n}
                          for k, v in sorted(by_kernel.items(),
                                             key=lambda kv: -kv[1][1])[:10]],
        "top_host_ops": [{"op": k, "self_ms": ms, f"per_{unit}": c}
                         for k, ms, c in host[:12]],
    }


if __name__ == "__main__":
    main()
