"""End-to-end training script on the PyTorch port (`repro_torch`; the
JAX twin is examples/finetune_aqsgd.py): pre-train, then fine-tune a
GPT-2-family model under AQ-SGD with the full substrate stack — data
pipeline with sample identity, AdamW, K-stage pipeline cuts with
message buffers, checkpointing, and a wire-cost report.

The default model is ~5M params; --dim 768 --layers 12 gives the
~100M-class configuration.  The checkpoint holds ``params`` and
``buffers`` in the JAX package's layout (`repro_torch.checkpoint.save`),
which `repro.checkpoint.restore` reads.

    PYTHONPATH=src python examples/torch_finetune_aqsgd.py --steps 100
    PYTHONPATH=src python examples/torch_finetune_aqsgd.py --device cpu
"""
import argparse
import os

import numpy as np

from repro_torch.checkpoint import checkpoint as ckpt
from repro_torch.comm import CommConfig
from repro_torch.configs.base import get_config
from repro_torch.core.aqsgd import CompressionConfig, buffer_nbytes
from repro_torch.core.quantization import wire_bytes
from repro_torch.data.pipeline import Dataset, DatasetConfig
from repro_torch.launch.serve import resolve_device
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.training import simulated as sim
from repro_torch.weights import numpy_tree, to_jax_params


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dim", type=int, default=256)
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--pretrain-steps", type=int, default=80)
    ap.add_argument("--stages", type=int, default=4)
    ap.add_argument("--fw-bits", type=int, default=3)
    ap.add_argument("--bw-bits", type=int, default=6)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--out", default="results/finetune_aqsgd.npz")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the plain "
                         "PyTorch codec)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = get_config("gpt2-xl-paper", smoke=True).with_(
        num_layers=args.layers, d_model=args.dim,
        num_heads=max(args.dim // 64, 1),
        num_kv_heads=max(args.dim // 64, 1), head_dim=64,
        d_ff=args.dim * 4)
    n_params = cfg.params_count()
    print(f"model: {args.layers}L d={args.dim} -> {n_params/1e6:.1f}M "
          f"params, {args.stages} pipeline stages")

    data = Dataset(DatasetConfig(num_samples=64, seq_len=args.seq,
                                 vocab_size=cfg.vocab_size))
    print("phase 1: pre-training (fp32)...")
    tcfg = sim.SimTrainConfig(
        num_stages=1,
        comm=CommConfig.from_legacy(CompressionConfig(mode="fp32")),
        optimizer=AdamWConfig(lr=2e-3, warmup_steps=10,
                              schedule="constant"))
    state, losses = sim.train(cfg, tcfg, data,
                              num_steps=args.pretrain_steps,
                              batch_size=args.batch, log_every=20,
                              device=dev)

    print(f"phase 2: AQ-SGD fine-tuning "
          f"(fw{args.fw_bits} bw{args.bw_bits}, K={args.stages})...")
    cc = CompressionConfig(mode="aqsgd", fw_bits=args.fw_bits,
                           bw_bits=args.bw_bits)
    tcfg = sim.SimTrainConfig(
        num_stages=args.stages, comm=CommConfig.from_legacy(cc),
        optimizer=AdamWConfig(lr=3e-4, warmup_steps=5,
                              schedule="constant"))
    ft_data = Dataset(DatasetConfig(num_samples=48, seq_len=args.seq,
                                    vocab_size=cfg.vocab_size, seed=9))
    state, ft_losses = sim.train(
        cfg, tcfg, ft_data, num_steps=args.steps, batch_size=args.batch,
        log_every=20, device=dev,
        initial_params=numpy_tree(to_jax_params(state["model"])))
    print(f"fine-tune loss: {ft_losses[0]:.3f} -> "
          f"{np.mean(ft_losses[-8:]):.3f}")

    # wire + storage accounting (what a real deployment would see)
    act_shape = (args.batch * args.seq, cfg.d_model)
    raw = int(np.prod(act_shape)) * 4
    wire = wire_bytes(act_shape, args.fw_bits)
    buf = buffer_nbytes(cc, args.stages - 1, ft_data.num_samples,
                        args.seq, cfg.d_model)
    print(f"boundary wire: {raw/1e6:.2f} MB -> {wire/1e6:.2f} MB "
          f"({raw/wire:.1f}x compression) per batch per boundary")
    print(f"message buffers: {buf/1e6:.1f} MB total "
          f"({args.stages-1} boundaries x {ft_data.num_samples} samples)")

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    ckpt.save(args.out, {"params": to_jax_params(state["model"]),
                         "buffers": state["buffers"]})
    print(f"checkpoint (params + AQ-SGD buffers) saved to {args.out}")
    return {"losses": ft_losses, "out": args.out}


if __name__ == "__main__":
    main()
