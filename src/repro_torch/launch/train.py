"""Training launcher: the single-host simulated trainer (port of the
single-host path of `repro.launch.train`).

The flags and their defaults are the JAX package's; all communication
knobs build one `CommConfig` (or pass it whole as JSON with
``--comm-config``).  Runs on CUDA unless ``--device cpu`` asks for the
CPU; with no card and no such request it raises.  The weights are a
random init from ``--seed``.

Not ported yet, and refused with the ROADMAP item that ports them:
``--distributed`` (the multi-process pipeline, queue A slice 4),
``--ckpt-dir``/``--resume``/``--save-every``/``--checkpoint`` and
``--fault``/``--kill-at`` (checkpoints, fault injection and recovery,
queue A item 15).

Examples:
  python -m repro_torch.launch.train --device cpu --smoke --stages 2 \\
      --dp-grad-bits 4 --steps 4
  python -m repro_torch.launch.train --arch gpt2-xl-paper --stages 4 \\
      --mode aqsgd --fw-bits 4 --bw-bits 8 --dp-grad-bits 4 \\
      --dp-workers 2
"""
from __future__ import annotations

import argparse

import numpy as np

from repro_torch.comm import config as comm_cli
from repro_torch.comm import wires as W
from repro_torch.configs.base import ARCHS, get_config
from repro_torch.data.pipeline import Dataset, DatasetConfig
from repro_torch.launch.serve import resolve_device
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.training import simulated as sim

# flags of the JAX launcher the port refuses, and the ROADMAP item
# that ports them
NOT_PORTED = {
    "distributed": "the multi-process pipeline (ROADMAP queue A, "
                   "slice 4, item 13)",
    "ckpt_dir": "checkpoints (ROADMAP queue A, item 15)",
    "resume": "checkpoints (ROADMAP queue A, item 15)",
    "save_every": "checkpoints (ROADMAP queue A, item 15)",
    "checkpoint": "checkpoints (ROADMAP queue A, item 15)",
    "fault": "fault injection (ROADMAP queue A, item 15)",
    "kill_at": "kill-and-resume (ROADMAP queue A, item 15)",
}


def print_wires() -> None:
    """The --list-wires table: every DP wire the port registers."""
    specs = W.list_wires()
    wn = max(len(s.name) for s in specs)
    print(f"{'wire':{wn}}  summary")
    for s in specs:
        print(f"{s.name:{wn}}  {s.summary}")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train")
    ap.add_argument("--arch", default="gpt2-xl-paper", choices=list(ARCHS))
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced config (CPU-friendly)")
    comm_cli.add_cli_args(ap)
    ap.add_argument("--list-wires", action="store_true",
                    help="print the wire registry table and exit")
    ap.add_argument("--dp-workers", type=int, default=2,
                    help="simulated DP degree for --dp-grad-bits")
    ap.add_argument("--stages", type=int, default=4)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--samples", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--warmup-epochs", type=int, default=1,
                    help="(multi-process pipeline only)")
    ap.add_argument("--data-par", type=int, default=2,
                    help="(multi-process pipeline only)")
    ap.add_argument("--microbatches", type=int, default=2,
                    help="(multi-process pipeline only)")
    ap.add_argument("--corpus", default="",
                    help="optional text file to train on (byte-level)")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the random weights and of the "
                         "stochastic-rounding noise")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the plain "
                         "PyTorch codec)")
    ap.add_argument("--distributed", action="store_true")
    ap.add_argument("--checkpoint", default="")
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--save-every", type=int, default=0)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--fault", default="")
    ap.add_argument("--kill-at", type=int, default=None)
    return ap


def main(argv=None):
    """Parse the flags, train, print ``step N loss X`` every 10 steps and
    ``final loss`` (the mean of the last 5).  Returns (state, losses)."""
    ap = build_parser()
    args = ap.parse_args(argv)
    if args.list_wires:
        print_wires()
        return None
    for flag, what in NOT_PORTED.items():
        value = getattr(args, flag)
        if (value is not None) if flag == "kill_at" else bool(value):
            ap.error(f"--{flag.replace('_', '-')}: {what} is not ported "
                     f"yet")
    dev = resolve_device(args.device)
    comm = comm_cli.from_args(args)
    cfg = get_config(args.arch, smoke=args.smoke)
    ds = Dataset(DatasetConfig(
        num_samples=args.samples, seq_len=args.seq,
        vocab_size=cfg.vocab_size,
        kind="textfile" if args.corpus else "synthetic-lm",
        path=args.corpus or None))
    opt = AdamWConfig(lr=args.lr, warmup_steps=max(args.steps // 20, 1),
                      total_steps=args.steps)
    tcfg = sim.SimTrainConfig(num_stages=args.stages, comm=comm,
                              optimizer=opt,
                              dp_workers=args.dp_workers
                              if comm.dp.bits else 1)
    state, losses = sim.train(cfg, tcfg, ds, num_steps=args.steps,
                              batch_size=args.batch, seed=args.seed,
                              device=dev, log_every=10)
    print(f"final loss {np.mean(losses[-5:]):.4f}")
    return state, losses


if __name__ == "__main__":
    main()
