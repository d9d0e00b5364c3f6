#!/usr/bin/env python3
"""How the serving launcher's device memory grows with depth, and the
most layers of an arch that the card holds at full width.

    python3 tools/serve_memory.py [--cell serve-gemma2-27b] [--layers 2 4]
        [--gen 4]

Serves one of ``chip_smoke.py``'s full-size serving cells
(`chip_smoke.SERVE_CELLS`: its launcher flags, so its arch, batch,
prompt, comm flags and seed) through `repro_torch.launch.serve`, with
only ``--layers`` set to each depth of ``--layers`` and ``--gen`` to
``--gen``, and reads `torch.cuda.max_memory_allocated`
after a reset before each run: the weights, the KV stores and the
prefill's activations.  It fits the peak as ``a + b * layers`` through
the depths (least squares) and prints one JSON line: the runs, the
fit, and the most layers, and the most in an even count (local and
global layers alternate in gemma2), whose fitted peak stays
HEADROOM_GIB under the card's memory (the CUDA context and the
allocator's rounding sit outside the peak it reads).

Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GIB = 2 ** 30
HEADROOM_GIB = 2.0


def with_flags(argv: list, values: dict) -> list:
    """``argv`` with each flag of ``values`` set to its value (appended
    where ``argv`` lacks it)."""
    out = list(argv)
    for flag, value in values.items():
        if flag in out:
            out[out.index(flag) + 1] = str(value)
        else:
            out += [flag, str(value)]
    return out


def main() -> int:
    sys.path.insert(0, ROOT)
    from chip_smoke import SERVE_CELLS

    ap = argparse.ArgumentParser(prog="python3 tools/serve_memory.py")
    ap.add_argument("--cell", default="serve-gemma2-27b",
                    choices=sorted(SERVE_CELLS))
    ap.add_argument("--layers", type=int, nargs="+", default=[2, 4])
    ap.add_argument("--gen", type=int, default=4)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("serve_memory: no CUDA device is available", file=sys.stderr)
        return 1
    from repro_torch.launch import serve

    torch.backends.cuda.matmul.allow_tf32 = False
    runs = []
    cell = SERVE_CELLS[args.cell][0]
    for layers in args.layers:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        out = serve.main(with_flags(cell, {"--layers": layers,
                                           "--gen": args.gen}))
        torch.cuda.synchronize()
        runs.append({"layers": layers,
                     "peak_gib": torch.cuda.max_memory_allocated() / GIB,
                     "prefill_s": out["prefill_s"],
                     "build_s": out["build_s"]})
        del out
    xs = [r["layers"] for r in runs]
    ys = [r["peak_gib"] for r in runs]
    mx, my = sum(xs) / len(xs), sum(ys) / len(ys)
    slope = sum((x - mx) * (y - my) for x, y in zip(xs, ys)) \
        / sum((x - mx) ** 2 for x in xs)
    icpt = my - slope * mx
    card = torch.cuda.get_device_properties(0).total_memory / GIB
    most = int((card - HEADROOM_GIB - icpt) // slope)
    print(json.dumps({
        "cell": args.cell, "launcher_args": cell, "gen": args.gen,
        "runs": runs,
        "fit_gib": {"a": icpt, "b_per_layer": slope},
        "card_gib": card, "headroom_gib": HEADROOM_GIB,
        "most_layers": most,
        "most_even_layers": most - most % 2,
        "device": torch.cuda.get_device_name(0)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
