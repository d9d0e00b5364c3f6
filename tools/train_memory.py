#!/usr/bin/env python3
"""Where the simulated trainer's device memory peaks, and how it grows
with depth.

    python3 tools/train_memory.py [--layers 4 8 12] [--remat off on]
        [--steps 4] [--src TREE] [--arch ARCH --stages K]
        [--dp-workers N] [--seq S]

Runs `chip_smoke.py`'s ``[train]`` configuration (``gpt2-xl-paper`` at
full width, 4 stage groups, or ``--arch`` at full width in ``--stages``
groups, as ``[train-zamba2]`` runs ``zamba2-2.7b --layers 12 --stages
2``; aqsgd fw 4 / bw 8 stochastic, 4-bit DP on
the ``ring`` over ``--dp-workers`` simulated workers, 2 by default, or
with ``--dp-workers 0`` one worker and no DP plane, as ``[train-moe]``
runs ``deepseek-moe-16b --layers 3 --stages 2``; batch 8 x seq 1024
(``--seq``), 16 samples, random weights from seed 0; ``whisper-small``
takes stub frames (8, 1500, 768) a batch, as ``[train-whisper]`` runs
it with ``--stages 2 --seq 448``, its ``--layers`` the decoder's) at
each depth of ``--layers``, with remat off and on, ``--steps`` steps
each (from step 3 the delta path runs).
For every step it records the bytes resident at its start (weights,
AdamW moments, message buffers, carries) and the peak of each phase,
read with `torch.cuda.max_memory_allocated` after a reset at the
phase's start: each worker's forward and backward
(`simulated._loss_and_grads`), the DP wire (from the last worker's
gradients to AdamW), AdamW, and the buffer writes.  Then it fits each
phase's peak of the last step as ``a + b * layers`` over the depths
(least squares) and prints one JSON line: the runs, the fits, and the
depth at which the largest fitted peak reaches the card's memory.
``--src`` (default: this checkout) is the root of a checkout whose
``src/repro_torch`` is measured, so one call on the card can measure
two trees (a parent unpacked under ``build/`` with ``git archive``);
remat off is `SimTrainConfig`'s default and is not passed, so ``--remat
off`` runs on a tree whose config has no ``remat``.

Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GIB = 2 ** 30


def run(layers: int, remat: bool, steps: int, arch: str = "gpt2-xl-paper",
        stages: int = 4, dp_workers: int = 2, seq: int = 1024) -> dict:
    import torch

    from repro_torch.comm import config as comm_mod
    from repro_torch.configs.base import get_config
    from repro_torch.data.pipeline import Dataset, DatasetConfig
    from repro_torch.optim import adamw
    from repro_torch.rng import seeded_generator
    from repro_torch.training import simulated as sim

    plane = comm_mod.PlaneConfig
    comm = comm_mod.CommConfig(mode="aqsgd", fw=plane(bits=4),
                               bw=plane(bits=8),
                               dp=plane(bits=4 if dp_workers else 0,
                                        wire="ring"))
    cfg = get_config(arch).with_(num_layers=layers)
    tcfg = sim.SimTrainConfig(
        num_stages=stages, comm=comm, dp_workers=max(dp_workers, 1),
        optimizer=adamw.AdamWConfig(lr=1e-3, warmup_steps=1,
                                    total_steps=steps),
        **({"remat": True} if remat else {}))
    ds = Dataset(DatasetConfig(num_samples=16, seq_len=seq,
                               vocab_size=cfg.vocab_size))
    dev = torch.device("cuda")
    torch.cuda.empty_cache()
    state = sim.init_train_state(
        cfg, tcfg, 16, seq, generator=torch.Generator().manual_seed(0),
        device=dev)
    gen = seeded_generator(dev, 0, "noise")
    phases: dict = {}

    def mark(name):
        torch.cuda.synchronize()
        phases[name] = max(phases.get(name, 0),
                           torch.cuda.max_memory_allocated())
        torch.cuda.reset_peak_memory_stats()

    real_grads, real_adamw = sim._loss_and_grads, sim.adamw.apply_updates
    worker = [0]

    def grads_spy(*a, **kw):
        torch.cuda.reset_peak_memory_stats()
        out = real_grads(*a, **kw)
        mark(f"worker{worker[0]}_forward_backward")
        worker[0] += 1
        return out

    def adamw_spy(*a, **kw):
        mark("dp_wire")
        out = real_adamw(*a, **kw)
        mark("adamw")
        return out

    sim._loss_and_grads, sim.adamw.apply_updates = grads_spy, adamw_spy
    records = []
    try:
        for i, batch in enumerate(ds.batches(8, steps)):
            if cfg.family == "audio":
                from repro_torch.data.pipeline import with_stub_media
                batch = with_stub_media(cfg, batch, seed=0, step=i)
            b = sim.device_batch(batch, dev)
            torch.cuda.synchronize()
            resident = torch.cuda.memory_allocated()
            phases.clear()
            worker[0] = 0
            t0 = time.perf_counter()
            state, met = sim.train_step(state, b, gen, mcfg=cfg, tcfg=tcfg)
            loss = float(met["loss"])
            mark("buffer_writes")
            records.append({"seconds": time.perf_counter() - t0,
                            "loss": loss, "resident_gib": resident / GIB,
                            "peak_gib": {k: v / GIB
                                         for k, v in phases.items()}})
    finally:
        sim._loss_and_grads, sim.adamw.apply_updates = real_grads, \
            real_adamw
    n_params = sum(p.numel() for p in state["model"].parameters())
    del state, b
    torch.cuda.empty_cache()
    return {"layers": layers, "remat": remat, "params": n_params,
            "median_step_s": statistics.median(
                r["seconds"] for r in records[2:] or records),
            "steps": records}


def fit(points):
    """Least-squares (a, b) of y = a + b x."""
    n = len(points)
    mx = sum(x for x, _ in points) / n
    my = sum(y for _, y in points) / n
    sxx = sum((x - mx) ** 2 for x, _ in points)
    b = sum((x - mx) * (y - my) for x, y in points) / sxx if sxx else 0.0
    return my - b * mx, b


def main(argv=None) -> dict:
    import torch
    ap = argparse.ArgumentParser()
    ap.add_argument("--layers", type=int, nargs="+", default=[4, 8, 12])
    ap.add_argument("--remat", nargs="+", choices=("off", "on"),
                    default=["off", "on"])
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--src", default=ROOT)
    ap.add_argument("--arch", default="gpt2-xl-paper")
    ap.add_argument("--stages", type=int, default=4)
    ap.add_argument("--dp-workers", type=int, default=2)
    ap.add_argument("--seq", type=int, default=1024)
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.join(os.path.abspath(args.src), "src"))
    if not torch.cuda.is_available():
        raise RuntimeError("the memory split measures the card: run with a "
                           "CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = torch.cuda.get_device_properties(0)
    runs = [run(n, mode == "on", args.steps, args.arch, args.stages,
                args.dp_workers, args.seq)
            for mode in args.remat for n in args.layers]
    fits = {}
    for mode in args.remat:
        mine = [r for r in runs if r["remat"] == (mode == "on")]
        last = [r["steps"][-1] for r in mine]
        per = {"resident": fit([(r["layers"], s["resident_gib"])
                                for r, s in zip(mine, last)])}
        for name in last[0]["peak_gib"]:
            per[name] = fit([(r["layers"], s["peak_gib"][name])
                             for r, s in zip(mine, last)])
        top = max(per.items(), key=lambda kv: kv[1][0] + 48 * kv[1][1])
        cap = card.total_memory / GIB
        a, b = top[1]
        fits[mode] = {"gib_a_plus_b_per_layer": per, "top_phase": top[0],
                      "layers_at_card_memory": (cap - a) / b if b else None,
                      "card_gib": cap}
    out = {"src": os.path.abspath(args.src), "arch": args.arch,
           "stages": args.stages, "dp_workers": args.dp_workers,
           "seq": args.seq,
           "device": torch.cuda.get_device_name(0), "runs": runs,
           "fits": fits}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
