#!/usr/bin/env python3
"""Device time of the codec kernels the serving path launches each step
(B1, B3, B4) at the paths' shapes, for one source tree.

    python3 tools/time_kv_codecs.py [--src TREE]

``--src`` (default: this checkout) is the root of a checkout whose
``src/repro_torch`` is timed, so one call on the card can time two
versions in turns: unpack the other commit into a directory that
``.gitignore`` lists (``git archive <commit> | tar -x -C build/parent``)
and run ``--src build/parent``, then this tree, then both again.  Each
time is the median of replays of a CUDA graph of 40 back-to-back calls
cycling over distinct inputs (`chip_smoke.device_ms`, imported), in ms:

* B4 ``unpack_dequant`` per call: gpt2-xl's layer store (32000, 64),
  gemma2-9b's (131072, 256) and the training boundary (4096, 1600), f32
  and bf16; where the tree has it, the pair read of k and v
  (``*_pair``) at both archs;
* B3 ``quantize_pack`` per call: the decode appends (200, 64) and (16,
  256), gpt2-xl's prefill append (25600, 64), the training boundary
  (4096, 1600) with noise and with a seed; where the tree has it, the
  pair append in place (``*_pair``);
* B1 ``delta_quantize_pack``: the decode hops (8, 1600) and (2, 3584),
  the training boundary (4096, 1600) with noise and with a seed (``m``
  made before the graph is captured, so a row times B1 alone);
* ``launch_floor``: an empty kernel, where the tree has it.

Prints one JSON line.  Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from chip_smoke import device_ms  # noqa: E402  (one timing harness)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--src", default=ROOT)
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.join(os.path.abspath(args.src), "src"))
    import torch
    from repro_torch.kernels import build
    from repro_torch.kernels import quant_pack as qp

    if not torch.cuda.is_available():
        raise RuntimeError("the timing needs a CUDA device")
    dev = "cuda"
    pair = hasattr(qp, "unpack_dequant_pair")
    out = {"src": os.path.abspath(args.src),
           "device": torch.cuda.get_device_name(0)}

    def sets_for(nbytes):             # distinct inputs past the 50 MB L2
        return max(1, min(16, int(120e6 // max(nbytes, 1)) + 1))

    # B4, the store read: (label, rows, d), 8 bits
    for label, rows, d in (("gpt2_read", 32000, 64),
                           ("gemma_read", 131072, 256),
                           ("train_read", 4096, 1600)):
        sets = [(torch.randint(0, 256, (rows, d), device=dev,
                               dtype=torch.uint8),
                 torch.rand(rows, 1, device=dev) + 1e-3)
                for _ in range(sets_for(rows * d * 5 + rows * 4))]
        out[label] = device_ms(
            torch, lambda p, s: qp.unpack_dequant(p, s, bits=8), sets)
        out[label + "_bf16"] = device_ms(
            torch, lambda p, s: qp.unpack_dequant(
                p, s, bits=8, out_dtype=torch.bfloat16), sets)
        if pair and label != "train_read":
            two = [(sets[i], sets[(i + 1) % len(sets)]) if len(sets) > 1
                   else (sets[0], tuple(t.clone() for t in sets[0]))
                   for i in range(len(sets))]
            out[label + "_pair"] = device_ms(
                torch, lambda a, b: qp.unpack_dequant_pair(
                    (a[0], b[0]), (a[1], b[1]), bits=8), two)
        del sets
    # B3, the append: (label, (B, s, N) of the fresh rows, d, S of the
    # store, pos); the training boundary is one (4096, 1600) call
    for label, (b, s, n), d, cache, pos in (
            ("gpt2_append", (8, 1, 25), 64, 160, 150),
            ("gemma_append", (2, 1, 8), 256, 8192, 8191),
            ("gpt2_prefill_append", (8, 128, 25), 64, 160, 0)):
        xs = [torch.randn(b, s, n, d, device=dev) for _ in range(16)]
        out[label] = device_ms(
            torch, lambda x: qp.quantize_pack(x.reshape(-1, d), bits=8),
            [(x,) for x in xs])
        if pair:
            packed = tuple(torch.zeros(b, cache, n, d, device=dev,
                                       dtype=torch.uint8) for _ in range(2))
            scale = tuple(torch.zeros(b, cache, n, device=dev)
                          for _ in range(2))
            out[label + "_pair"] = device_ms(
                torch, lambda xk, xv: qp.quantize_pack_into(
                    (xk, xv), packed, scale, pos, bits=8),
                [(xs[2 * i], xs[2 * i + 1]) for i in range(8)])
        del xs
    seed = torch.tensor([1, 2], dtype=torch.int32, device=dev)
    xs = [(torch.randn(4096, 1600, device=dev),
           torch.rand(4096, 1600, device=dev)) for _ in range(8)]
    out["train_append"] = device_ms(
        torch, lambda x, u: qp.quantize_pack(x, u, bits=8), xs)
    out["train_append_seeded"] = device_ms(
        torch, lambda x, u: qp.quantize_pack(x, bits=8, seed=seed), xs)
    xs = [(x, x * 0.5, u) for x, u in xs]
    out["train_b1"] = device_ms(
        torch, lambda a, m, u: qp.delta_quantize_pack(a, m, u, bits=4), xs)
    out["train_b1_seeded"] = device_ms(
        torch, lambda a, m, u: qp.delta_quantize_pack(a, m, bits=4,
                                                      seed=seed), xs)
    del xs
    # B1, the decode hops
    for label, rows, d in (("hop_b1", 8, 1600), ("gemma_hop_b1", 2, 3584)):
        xs = [(x, x * 0.5) for x in (torch.randn(rows, d, device=dev)
                                     for _ in range(16))]
        out[label] = device_ms(
            torch, lambda a, m: qp.delta_quantize_pack(a, m, bits=4), xs)
    lib = build.load("quant_pack")
    if hasattr(lib, "rt_launch_floor"):
        out["launch_floor"] = device_ms(
            torch, lambda: lib.rt_launch_floor(
                torch.cuda.current_stream().cuda_stream), [()])
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
