"""Batched serving example on the PyTorch port (`repro_torch`; the JAX
twin is examples/serve_batched.py): prefill a batch of prompts, then
decode with KV caches through the public serve path, plus a
continuous-batching pass over mixed-length prompts.

Communication knobs are the one CommConfig surface shared with the
train/serve launchers: ``--kv-bits 8`` stores the demo caches as packed
codes + group scales, ``--comm-config`` accepts the full JSON.

Runs three model families to show the cache machinery: dense GQA
(gemma2), attention-free SSM (mamba2), hybrid (zamba2).  The weights
and prompts are drawn from seeds.

    PYTHONPATH=src python examples/torch_serve_batched.py --tiny --kv-bits 8
    PYTHONPATH=src python examples/torch_serve_batched.py --tiny --device cpu
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.comm import config as comm_cli
from repro_torch.configs.base import get_config
from repro_torch.launch.serve import resolve_device
from repro_torch.models.model import Transformer
from repro_torch.rng import seeded_generator
from repro_torch.serving import ContinuousBatcher, KVCodec


def main(argv=None) -> list:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tiny", action="store_true",
                    help="CI-sized run: one arch, short prompts")
    comm_cli.add_cli_args(ap)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the plain "
                         "PyTorch codec)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    comm = comm_cli.from_args(args)
    kv_codec = KVCodec.from_comm(comm)
    kvc = kv_codec if kv_codec.bits else None
    print("comm:", comm.to_json())

    batch, prompt, gen = (2, 8, 4) if args.tiny else (4, 24, 12)
    archs = ("gemma2-9b",) if args.tiny \
        else ("gemma2-9b", "mamba2-1.3b", "zamba2-2.7b")

    for arch in archs:
        cfg = get_config(arch, smoke=True)
        model = Transformer(cfg, device=dev,
                            generator=seeded_generator("cpu", 0, "init"))
        # hybrid keeps a raw cache (kv.bits>0 is dense-family only)
        quant = kvc if cfg.family != "hybrid" else None
        caches = model.init_caches(batch, prompt + gen, torch.float32,
                                   kv_codec=quant)
        prompts = torch.randint(0, cfg.vocab_size, (batch, prompt),
                                generator=seeded_generator("cpu", 1,
                                                           "prompts")
                                ).to(dev)

        t0 = time.time()
        logits, caches = model.forward_with_caches(
            prompts, caches, logits_last_only=True, kv_codec=quant)
        tok = logits[:, -1].argmax(-1)[:, None]
        out = [tok]
        for _ in range(gen - 1):
            logits, caches = model.forward_with_caches(
                tok, caches, logits_last_only=True, kv_codec=quant)
            tok = logits[:, -1].argmax(-1)[:, None]
            out.append(tok)
        gen_toks = torch.cat(out, dim=1).cpu()       # waits for the device
        dt = time.time() - t0
        print(f"{arch:14s} [{cfg.family:6s}] prefill {batch}x{prompt} + "
              f"decode {gen}: {dt:.1f}s; sample: "
              f"{gen_toks[0][:8].tolist()}")

    # ---- continuous batching over mixed-length prompts ---------------------
    cfg = get_config("gemma2-9b", smoke=True)
    model = Transformer(cfg, device=dev,
                        generator=seeded_generator("cpu", 0, "init"))
    bat = ContinuousBatcher(model, num_slots=batch, cache_len=prompt + gen,
                            kv_codec=kvc)
    rng = np.random.default_rng(2)
    for _ in range(batch * 2):
        plen = int(rng.integers(2, prompt + 1))
        bat.submit(rng.integers(0, cfg.vocab_size, plen).tolist(),
                   max_new_tokens=gen)
    reqs = bat.run()
    assert all(r.state == "DONE" for r in reqs)
    lens = sorted({len(r.prompt) for r in reqs})
    print(f"continuous: {len(reqs)} mixed-length requests "
          f"(lens {lens}) over {batch} slots OK")
    print("serving path OK for attention, SSM and hybrid cache types")
    return reqs


if __name__ == "__main__":
    main()
