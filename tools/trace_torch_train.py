#!/usr/bin/env python3
"""Where a training step of the PyTorch port's simulated trainer spends
its time.

    python3 tools/trace_torch_train.py [train flags] [--layers N]
        [--remat] [--trace-steps N] [--chrome-trace PATH]

Builds the chip run's training path (`chip_smoke.py` ``[train]``) by
default: ``gpt2-xl-paper`` at full width cut to ``--layers`` (default
12) of its 48 layers, ``--stages 4 --mode aqsgd --fw-bits 4 --bw-bits 8
--dp-grad-bits 4 --dp-workers 2``, batch 8 x seq 1024, 16 samples,
random weights from seed 0 (``--remat``: each layer recomputed in the
backward, `SimTrainConfig.remat`), drawn as `simulated.train` draws them (a
CPU generator, and the noise from the seed's "noise" stream), so the
traced model is the trained one.  The comm flags are the train launcher's,
so ``--mode fp32`` or ``--dp-grad-bits 0`` trace the same model without
a compressed plane.  It runs four untraced steps (the first epoch and
the first delta-coded one), times ``--trace-steps`` more without the
profiler, then traces as many under `torch.profiler`, and prints one
JSON line:

* ``losses``: every step's loss;
* ``step_ms_untraced`` / ``step_ms``: host wall time per step, ending in
  a device synchronize, without and with the profiler;
* ``device_busy_ms``: per step, the union of the CUDA kernels' device
  intervals; ``device_idle_share`` = 1 - busy / wall;
* ``phases``: per step, the device time of the kernels that ran inside
  each of `train_step`'s ``train.*`` ranges (each worker's forward, the
  DP wire, AdamW, the buffer writes); the kernels outside them are the
  backward passes, which autograd runs on its own thread, and the
  buffer reads at the step's start;
* ``kernel_classes``: per step, device time by kind of kernel (matrix
  products, the port's codec kernels, its attention kernel, everything
  else);
* ``top_kernels``: device time per step by kernel name.

Needs a CUDA device.
"""
from __future__ import annotations

import json
import os
import sys
import time
from collections import defaultdict

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

DEFAULTS = ["--arch", "gpt2-xl-paper", "--stages", "4", "--mode", "aqsgd",
            "--fw-bits", "4", "--bw-bits", "8", "--dp-grad-bits", "4",
            "--dp-workers", "2", "--batch", "8", "--seq", "1024",
            "--samples", "16"]
# matched as substrings: "encode_rows" also names the wide-row encoders
# encode_rows_block and encode_rows_block_into
CODEC_KERNELS = ("encode_rows", "dequant_accumulate_flat",
                 "unpack_dequant_flat", "codes_scaled_flat", "sum_mean_flat")
GEMM_MARKERS = ("gemm", "cutlass", "xmma", "gemv", "splitKreduce")
OUTSIDE = "backward (autograd thread) and buffer reads"


def _union_ms(intervals) -> float:
    total, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b > end:
            total += b - max(a, end)
            end = b
    return total / 1e3


def _kind(name: str) -> str:
    if any(k in name for k in CODEC_KERNELS):
        return "codec (quant_pack.cu)"
    if "flash_fwd" in name:
        return "attention forward (flash_attention.cu)"
    if any(k in name for k in GEMM_MARKERS):
        return "matrix products"
    return "other (elementwise, softmax, reductions, copies)"


def main(argv=None) -> dict:
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.comm import config as comm_cli
    from repro_torch.configs.base import get_config
    from repro_torch.data.pipeline import Dataset, DatasetConfig
    from repro_torch.launch import train as launch
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.rng import seeded_generator
    from repro_torch.training import simulated as sim

    ap = launch.build_parser()
    ap.add_argument("--layers", type=int, default=12)
    ap.add_argument("--remat", action="store_true",
                    help="recompute each layer in the backward")
    ap.add_argument("--trace-steps", type=int, default=2)
    ap.add_argument("--chrome-trace", default="",
                    help="also write the traced steps as a Chrome trace")
    args = ap.parse_args(DEFAULTS + list(sys.argv[1:] if argv is None
                                         else argv))
    dev = launch.resolve_device(args.device)
    if dev.type != "cuda":
        raise RuntimeError("the trace measures the card: run with a CUDA "
                           "device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    comm = comm_cli.from_args(args)
    cfg = get_config(args.arch).with_(num_layers=args.layers)
    n = args.trace_steps
    steps = 4 + 2 * n
    tcfg = sim.SimTrainConfig(
        num_stages=args.stages, comm=comm,
        dp_workers=args.dp_workers if comm.dp.bits else 1,
        optimizer=AdamWConfig(lr=args.lr, warmup_steps=max(steps // 20, 1),
                              total_steps=steps),
        remat=args.remat)
    ds = Dataset(DatasetConfig(num_samples=args.samples, seq_len=args.seq,
                               vocab_size=cfg.vocab_size))
    batches = [sim.device_batch(b, dev)
               for b in ds.batches(args.batch, steps)]
    # the weights and noise of `simulated.train` at this seed: weights
    # from a CPU generator, noise from the device stream named "noise"
    state = sim.init_train_state(
        cfg, tcfg, args.samples, args.seq,
        generator=torch.Generator().manual_seed(args.seed), device=dev)
    gen = seeded_generator(dev, args.seed, "noise")
    losses = []

    def run(bs):
        nonlocal state
        for b in bs:
            state, met = sim.train_step(state, b, gen, mcfg=cfg, tcfg=tcfg)
            losses.append(met["loss"])
        torch.cuda.synchronize(dev)

    run(batches[:4])                        # epoch 1, first delta step
    t0 = time.perf_counter()
    run(batches[4:4 + n])
    untraced = (time.perf_counter() - t0) * 1e3 / n
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run(batches[4 + n:])
        wall = (time.perf_counter() - t0) * 1e3 / n
    if args.chrome_trace:
        prof.export_chrome_trace(args.chrome_trace)

    cuda = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    # the ranges' device-side spans, and the kernels proper
    spans = [(e.time_range.start, e.time_range.end, e.name) for e in cuda
             if e.name.startswith("train.")]
    kernels = [e for e in cuda if not e.name.startswith("train.")]
    busy = _union_ms((e.time_range.start, e.time_range.end)
                     for e in kernels) / n
    by_kernel = defaultdict(lambda: [0.0, 0])
    by_kind = defaultdict(float)
    by_phase = defaultdict(float)
    for e in kernels:
        ms = e.time_range.elapsed_us() / 1e3 / n
        by_kernel[e.name][0] += ms
        by_kernel[e.name][1] += 1
        by_kind[_kind(e.name)] += ms
        phase = next((name for a, b, name in spans
                      if a <= e.time_range.start < b), OUTSIDE)
        by_phase[phase] += ms
    out = {
        "device": torch.cuda.get_device_name(dev),
        "config": {"arch": cfg.name, "layers": cfg.num_layers,
                   "d_model": cfg.d_model, "stages": args.stages,
                   "mode": comm.mode, "fw_bits": comm.fw.bits,
                   "bw_bits": comm.bw.bits, "dp_bits": comm.dp.bits,
                   "workers": tcfg.dp_workers, "batch": args.batch,
                   "seq": args.seq, "lr": args.lr, "remat": args.remat},
        "losses": [float(x) for x in losses],
        "trace_steps": n, "step_ms_untraced": untraced, "step_ms": wall,
        "device_busy_ms": busy, "device_idle_share": 1.0 - busy / wall,
        "kernel_launches": len(kernels) / n,
        "phases": dict(sorted(by_phase.items(), key=lambda kv: -kv[1])),
        "kernel_classes": dict(sorted(by_kind.items(),
                                      key=lambda kv: -kv[1])),
        "top_kernels": [{"name": k[:90], "ms": v[0], "per_step": v[1] / n}
                        for k, v in sorted(by_kernel.items(),
                                           key=lambda kv: -kv[1][0])[:12]],
    }
    print(json.dumps(out, indent=1))
    return out


if __name__ == "__main__":
    main()
