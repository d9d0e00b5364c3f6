"""Training launcher (port of `repro.launch.train`): the single-host
simulated trainer, and with ``--distributed`` the multi-process GPipe
pipeline over a ``(--data-par, --stages)`` process mesh.

The flags and their defaults are the JAX package's; all communication
knobs build one `CommConfig` (or pass it whole as JSON with
``--comm-config``).  Runs on CUDA unless ``--device cpu`` asks for the
CPU; with no card and no such request it raises.  The weights are a
random init from ``--seed``.

The single-host path runs through `repro_torch.launch.runner`:
``--ckpt-dir`` with ``--save-every`` checkpoints the full state in the
JAX package's layout, ``--resume`` continues from the newest committed
checkpoint (the loss stream bit for bit), ``--fault`` injects a fault
plan that the guard catches and recovery replays, and ``--kill-at``
hard-exits (status 17) after a step's loss.  ``--checkpoint`` exports
the final params in JAX's layout (`repro_torch.checkpoint.save`).
Each ``step N loss X [hex]`` line carries the loss's bits.

``--distributed`` spawns one process per rank (`repro_torch.launch.mesh`,
gloo; on one card every rank shares it), builds the CUDA kernels once
before spawning, runs the warm-up step for the first
``--warmup-epochs`` epochs and the compressed step after, and stops
every rank if the run outlasts ``JOIN_TIMEOUT`` seconds.  There
``--ckpt-dir``/``--save-every``/``--resume``/``--keep`` checkpoint the
JAX launcher's one global state in its layout,
``<ckpt-dir>/step_<N>``, written and read by one rank, with the message
rows JAX's layout has no place for in ``<ckpt-dir>/torch_rows/step_<N>``
(`repro_torch.training.pipeline_state`): either package resumes the
other's; as in the JAX package, ``--fault`` and ``--kill-at`` target
the single-host trainer only.

The on-core noise knob (`repro_torch.env.oncore_prng`) puts both
trainers' stochastic encodes on the card onto the kernels' own seeded
noise (the distributed trainer's: its hop's and its monolithic DP
wires', `repro_torch.training.pipeline`).

Examples:
  python -m repro_torch.launch.train --device cpu --smoke --stages 2 \\
      --dp-grad-bits 4 --steps 4
  python -m repro_torch.launch.train --arch gpt2-xl-paper --stages 4 \\
      --mode aqsgd --fw-bits 4 --bw-bits 8 --dp-grad-bits 4 \\
      --dp-workers 2
  python -m repro_torch.launch.train --device cpu --smoke --distributed \\
      --data-par 2 --stages 2 --dp-grad-bits 4 --steps 4 --seq 16 \\
      --samples 8 --batch 4 --dp-wire ring-sharded
and the ssm and hybrid families (a hybrid's blocks of
``shared_attn_every`` layers: the simulated trainer's --stages divides
them, zamba2-2.7b's 9 into 1, 3 or 9, its SMOKE's 2 into 1 or 2; the
distributed trainer cuts the layers, as for every family):
  python -m repro_torch.launch.train --device cpu --smoke \\
      --arch zamba2-2.7b --stages 2 --dp-grad-bits 4 --steps 4
  python -m repro_torch.launch.train --device cpu --smoke \\
      --arch mamba2-1.3b --distributed --data-par 2 --stages 2 \\
      --dp-grad-bits 4 --steps 4 --seq 16 --samples 8 --batch 4
and the moe family (mixtral-8x22b, deepseek-moe-16b, moonshot-v1-16b-a3b:
the stage groups cut the layers past a model's dense prefix, 2 of
deepseek's SMOKE 3; the simulated trainer's loss holds the router's
auxiliary loss, the distributed trainer's does not, as in JAX; the
distributed trainer's ``moe_mode``, ``zero3`` or ``expert_parallel``,
is a `PipelineConfig` field that the spec's ``"pipeline"`` sets, as in
the JAX launcher no flag sets it):
  python -m repro_torch.launch.train --device cpu --smoke \\
      --arch deepseek-moe-16b --stages 2 --dp-grad-bits 4 --steps 4
  python -m repro_torch.launch.train --device cpu --smoke \\
      --arch mixtral-8x22b --distributed --data-par 2 --stages 2 \\
      --dp-grad-bits 4 --steps 4 --seq 16 --samples 8 --batch 4
and the vlm family as the JAX launcher trains it, text-only (the data
pipeline makes no patches):
  python -m repro_torch.launch.train --device cpu --smoke \\
      --arch pixtral-12b --stages 2 --dp-grad-bits 4 --steps 4
The audio family's loss needs frames, which the data pipeline does not
make (the JAX launcher fails with ``KeyError: 'frames'``), so
``--arch whisper-small`` is refused, and ``--distributed`` refuses both
families, whose batch specs in the JAX launcher name frames or patches
its batches lack; `training.simulated.train` (whisper) and
`run_distributed` (both) train them on stub ones
(`data.pipeline.with_stub_media`).

``--dp-wire`` takes every DP wire of the registry: ``ring`` (the
default), ``psum``, ``ring-sharded`` (the ZeRO wire: the ring's
reduce-scatter half, AdamW on each rank's segment of the parameter
bucket, the updated segments all-gathered) and ``fp16`` (the gradient
cast to f16, one all-reduce).  8-bit AdamW moments
(`AdamWConfig.state_bits`) run in the distributed trainer when a
caller sets ``"state_bits"`` in the spec's ``"optimizer"``
(`distributed_spec`); as in the JAX launcher, no flag sets them.
"""
from __future__ import annotations

import argparse
import dataclasses
import os

import numpy as np
import torch

from repro_torch import checkpoint as ckpt
from repro_torch.comm import config as comm_cli
from repro_torch.comm import wires as W
from repro_torch.comm.faults import FaultPlan
from repro_torch.configs.base import ARCHS, get_config
from repro_torch.data.pipeline import Dataset, DatasetConfig
from repro_torch.kernels import build
from repro_torch.launch import runner
from repro_torch.launch.mesh import spawn
from repro_torch.launch.serve import resolve_device
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.training import pipeline as PL
from repro_torch.training import pipeline_state as PS
from repro_torch.training import simulated as sim
from repro_torch.weights import to_jax_params

# seconds a --distributed run may take before every rank is stopped
JOIN_TIMEOUT = 3600.0


# what the JAX launcher lacks for the families whose batches carry
# frames or patches: its data pipeline makes none
AUDIO_DATA_REFUSAL = (
    "the audio family's loss reads batch['frames'] (B, encoder_seq, "
    "d_model), and the launcher's data pipeline makes no frames (the JAX "
    "launcher fails there with KeyError: 'frames'); "
    "training.simulated.train gives it stub frames")
MEDIA_DIST_REFUSAL = (
    "the JAX launcher's distributed batches carry no frames or patches, "
    "which its make_train_step's batch specs name for the audio and vlm "
    "families; launch.train.run_distributed gives them stub ones")


def print_wires() -> None:
    """The --list-wires table: every registered wire of every plane,
    flagged ``sharded`` (the ZeRO wire) or ``local`` (device memory,
    not network bytes), as the JAX launcher prints it."""
    rows = [(s.plane, s.name,
             ("sharded" if s.sharded else "") + ("" if s.network
                                                 else "local"),
             s.summary) for s in W.list_wires()]
    wp, wn, wf = (max(len(r[i]) for r in rows) for i in range(3))
    print(f"{'plane':{wp}}  {'wire':{wn}}  {'':{wf}}  summary")
    for p, n, f, summary in rows:
        print(f"{p:{wp}}  {n:{wn}}  {f:{wf}}  {summary}")


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
                    help="epochs of the uncompressed warm-up step "
                         "(--distributed only)")
    ap.add_argument("--data-par", type=int, default=2,
                    help="data-parallel ranks (--distributed only)")
    ap.add_argument("--microbatches", type=int, default=2,
                    help="GPipe microbatches (--distributed only)")
    ap.add_argument("--corpus", default="",
                    help="optional text file to train on (byte-level)")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the random weights and of the "
                         "stochastic-rounding noise")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the plain "
                         "PyTorch codec)")
    ap.add_argument("--distributed", action="store_true",
                    help="the multi-process GPipe pipeline over a "
                         "(--data-par, --stages) process mesh")
    ap.add_argument("--checkpoint", default="",
                    help="legacy params-only .npz export at exit "
                         "(full-state checkpointing is --ckpt-dir)")
    ap.add_argument("--ckpt-dir", default="",
                    help="versioned full-state checkpoint directory "
                         "(repro_torch.checkpoint manifest subsystem)")
    ap.add_argument("--save-every", type=int, default=0,
                    help="checkpoint the FULL train state every N "
                         "steps (0 = off; needs --ckpt-dir)")
    ap.add_argument("--resume", action="store_true",
                    help="resume from the newest committed checkpoint "
                         "in --ckpt-dir (checksums, structure and "
                         "comm config are verified; the replayed loss "
                         "stream is bit-identical)")
    ap.add_argument("--keep", type=int, default=3,
                    help="keep-last-k checkpoint rotation (0 = keep "
                         "all)")
    ap.add_argument("--max-retries", type=int, default=2,
                    help="bounded fault recovery: reload the last "
                         "good checkpoint and replay at most this "
                         "many times")
    ap.add_argument("--fault", default="",
                    help="deterministic fault injection plan, "
                         "step:plane:kind[,...] — e.g. "
                         "'3:dp:nan-scale,5:fw:drop-hop' (kinds: "
                         "corrupt-codes, nan-scale, drop-hop; "
                         "single-host trainer only)")
    ap.add_argument("--kill-at", type=int, default=None,
                    help="hard-exit (os._exit 17) right after "
                         "printing step N's loss, before any save — "
                         "the kill half of the kill-and-resume parity "
                         "gate (single-host trainer only)")
    return ap


def optimizer_config(args) -> AdamWConfig:
    """AdamW from the flags: linear warm-up over the first 5% of the
    steps (at least one), then linear decay to 0 at the last step."""
    return AdamWConfig(lr=args.lr, warmup_steps=max(args.steps // 20, 1),
                       total_steps=args.steps)


def distributed_spec(args, dev: torch.device) -> dict:
    """The plain-data description of a --distributed run that every
    rank receives (`repro_torch.training.pipeline.train_rank`).  A
    caller may add ``"pipeline"``, a dict of further `PipelineConfig`
    fields (``remat``, ``remat_mode``, ``loss_chunks``, ``block_k``);
    without it they keep their defaults, as the launcher's flags do."""
    return {
        "arch": args.arch, "smoke": args.smoke, "num_layers": 0,
        "comm": comm_cli.from_args(args).to_json(), "device": dev.type,
        "data_par": args.data_par, "stages": args.stages,
        "microbatches": args.microbatches, "steps": args.steps,
        "batch": args.batch, "warmup_epochs": args.warmup_epochs,
        "seed": args.seed, "ckpt_dir": args.ckpt_dir,
        "save_every": args.save_every, "keep": args.keep,
        "resume": args.resume,
        "optimizer": dataclasses.asdict(optimizer_config(args)),
        "dataset": {"num_samples": args.samples, "seq_len": args.seq,
                    "vocab_size": get_config(args.arch,
                                             smoke=args.smoke).vocab_size,
                    "seed": 0,
                    "kind": "textfile" if args.corpus else "synthetic-lm",
                    "path": args.corpus or None}}


def run_distributed(specs: list, *, timeout: float = 3600.0) -> list:
    """Spawn the ``data_par * stages`` ranks of distributed runs of one
    mesh and device, which the same processes run in turn, and return
    each spec's results by rank.  On CUDA the kernels are built here
    first, so the ranks only load them."""
    world = specs[0]["data_par"] * specs[0]["stages"]
    if any(s["data_par"] * s["stages"] != world
           or s["device"] != specs[0]["device"] for s in specs):
        raise ValueError("the specs of one spawn need one mesh and device")
    if specs[0]["device"] == "cuda":
        for name in build.SIGNATURES:
            build.build(name)
        threads = max(1, (os.cpu_count() or 1) // world)
    else:
        threads = 1
    out = spawn(PL.train_ranks, world, (specs,), timeout=timeout,
                threads=threads)
    return [[r[i] for r in out] for i in range(len(specs))]


def main(argv=None):
    """Parse the flags, train, print ``step N loss X [hex]`` every 10
    steps and ``final loss``: the mean of the last 5 on the single-host
    path, the last step's with ``--distributed``, as the JAX launcher
    prints them; ``--distributed`` also prints how many staged ``.tmp-*``
    entries were removed from the checkpoint directory and its sidecar,
    if any, and, where a resume found no sidecar of the step's commit
    (a JAX-written checkpoint), that those rows start at zero.  Returns
    (state, losses), or with --distributed (the ranks' results,
    losses); the losses are those of the steps this call ran."""
    ap = build_parser()
    args = ap.parse_args(argv)
    if args.list_wires:
        print_wires()
        return None
    if args.fault and args.distributed:
        ap.error("--fault targets the single-host simulated trainer, "
                 "not the multi-process pipeline")
    if args.kill_at is not None and args.distributed:
        ap.error("--kill-at targets the single-host simulated trainer, "
                 "not the multi-process pipeline")
    if (args.resume or args.save_every or args.fault) \
            and not args.ckpt_dir:
        ap.error("--resume/--save-every/--fault need --ckpt-dir")
    family = get_config(args.arch).family
    if args.distributed and family in ("audio", "vlm"):
        ap.error(f"--distributed --arch {args.arch}: {MEDIA_DIST_REFUSAL}")
    if family == "audio":
        ap.error(f"--arch {args.arch}: {AUDIO_DATA_REFUSAL}")
    dev = resolve_device(args.device)
    if args.distributed:
        results, = run_distributed([distributed_spec(args, dev)],
                                   timeout=JOIN_TIMEOUT)
        losses = results[0]["losses"]
        start = results[0]["start"]
        removed = sum(r["orphans_removed"] for r in results)
        if removed:
            print(f"checkpoint: removed {removed} orphaned tmp entries")
        if args.resume and not results[0]["ckpt"][0]["rows"]:
            print(f"checkpoint: step {start} has no {PS.ROWS_DIR} sidecar "
                  f"of its commit (the JAX package writes none): the "
                  f"message rows past samples // data-par start at zero")
        if start:
            print(f"resumed from step {start}")
        for i, loss in enumerate(losses, start=start):
            if i % 10 == 0:
                print(runner._loss_line(i, loss), flush=True)
        if losses:                  # a resume at the last step runs none
            print(f"final loss {losses[-1]:.4f}")
        return results, losses
    comm = comm_cli.from_args(args)
    cfg = get_config(args.arch, smoke=args.smoke)
    ds = Dataset(DatasetConfig(
        num_samples=args.samples, seq_len=args.seq,
        vocab_size=cfg.vocab_size,
        kind="textfile" if args.corpus else "synthetic-lm",
        path=args.corpus or None))
    tcfg = sim.SimTrainConfig(num_stages=args.stages, comm=comm,
                              optimizer=optimizer_config(args),
                              dp_workers=args.dp_workers
                              if comm.dp.bits else 1)
    state, losses = runner.run_sim_training(
        cfg, tcfg, ds, num_steps=args.steps, batch_size=args.batch,
        log_every=10, ckpt_dir=args.ckpt_dir, save_every=args.save_every,
        keep=args.keep, resume=args.resume, max_retries=args.max_retries,
        fault_plan=FaultPlan.parse(args.fault), kill_at=args.kill_at,
        seed=args.seed, device=dev)
    if losses:
        print(f"final loss {np.mean(losses[-5:]):.4f}")
    if args.checkpoint:
        ckpt.save(args.checkpoint, to_jax_params(state["model"]))
        print("saved", args.checkpoint)
    return state, losses


if __name__ == "__main__":
    main()
