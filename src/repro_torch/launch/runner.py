"""Fault-tolerant loop for the simulated trainer (port of
`repro.launch.runner`).

`run_sim_training` wraps `training.simulated.train_step` with the
checkpoint / resume / inject / recover loop while reproducing
`training.simulated.train`'s math exactly — the same weights from
``seed``, the same noise generator, the same step — so a run with
checkpointing on gives the losses of one with it off, bit for bit, and
a killed-and-resumed run replays the identical loss stream:

* **checkpoint** — every ``save_every`` steps (plus step 0 at init and
  the final step) the FULL state in the JAX package's layout
  (`training.simulated.to_jax_state`: params, opt, message buffers,
  ``dp_error``), the run's seed and the noise generator's state
  (``get_state()``: seed and offset on a card) are committed through
  `repro_torch.checkpoint.save_state`, with the data position and the
  recent loss tail; ``keep`` rotates old checkpoints out;
* **resume** — `restore_state` verifies checksums, structure and the
  comm config; a checkpoint of another seed raises `CheckpointError`
  (the JAX runner's key check), the generator takes the stored state,
  and the deterministic `data.pipeline` stream is replayed by
  `Dataset.reset` and skipping the first ``step`` batches;
* **inject** — a `comm.faults.FaultPlan` fires at its (step, plane)
  coordinates: a dp fault swaps the internal fault-wrapper wire into
  that step's config, fw / bw / zbuf faults corrupt the carried state
  (`inject_sim_state`; bw after the step).  Each fault fires ONCE: the
  replay of the same step after recovery runs clean;
* **recover** — after every step the loss (always) and the state (when
  a fault plan or checkpointing is active) pass through
  `check_train_state`; a `WireFaultError` reloads the last good
  checkpoint (the generator's state with it) and replays, at most
  ``max_retries`` times, then re-raises.

``kill_at=k`` hard-exits the process (``os._exit(17)``) right after
printing step k's loss and BEFORE any save, so the crash lands mid
checkpoint interval and the resumed run replays steps the killed one
already logged.

Loss lines carry the rounded value and ``float.hex()``, so CLI parity
checks compare bits; each save and restore prints its bytes on disk and
its seconds.
"""
from __future__ import annotations

import dataclasses
import os
import sys
import time
from typing import Optional

import numpy as np
import torch

from repro_torch import checkpoint as ckpt
from repro_torch.comm import faults as F
from repro_torch.rng import seeded_generator

KILL_EXIT_CODE = 17   # --kill-at's os._exit status: distinguishable
                      # from both success and a python traceback


def _skip_batches(dataset, batch_size: int, num_steps: int, start: int):
    """The deterministic batch stream starting at step ``start``:
    `Dataset.reset` rewinds the epoch shuffle to its seed, so resume and
    replay are reset-and-skip, with no cursor state to persist."""
    dataset.reset()
    it = dataset.batches(batch_size, num_steps)
    for _ in range(start):
        next(it)
    return it


def _loss_line(step: int, loss: float) -> str:
    return (f"step {step:5d} loss {loss:.4f} "
            f"[{float(loss).hex()}]")


def run_sim_training(mcfg, tcfg, dataset, *, num_steps: int,
                     batch_size: int, log_every: int = 10,
                     ckpt_dir: str = "", save_every: int = 0,
                     keep: int = 3, resume: bool = False,
                     max_retries: int = 2,
                     fault_plan: Optional[F.FaultPlan] = None,
                     kill_at: Optional[int] = None, seed: int = 0,
                     device="cuda", print_fn=print):
    """Run the simulated trainer with checkpoint/resume, deterministic
    fault injection and guarded recovery (module docstring).  Returns
    ``(state, losses)``, where ``losses`` covers the steps THIS call
    executed (a resumed call starts at the checkpoint step).

    Math-identical to `training.simulated.train`: checkpointing off and
    an empty fault plan give its loss stream bit for bit."""
    from repro_torch.training import simulated as sim

    comm = tcfg.comm
    plan = fault_plan or F.FaultPlan()
    for spec in plan.faults:
        if spec.plane == "kv":
            raise ValueError("kv faults target the serving batcher "
                             "(launch.serve), not the trainer")
        if spec.plane == "dp" and not comm.dp.bits:
            raise ValueError(f"fault {spec.text()!r} needs "
                             f"--dp-grad-bits > 0")
        if spec.plane in ("fw", "zbuf") and comm.mode != "aqsgd":
            raise ValueError(f"fault {spec.text()!r} needs "
                             f"mode='aqsgd' (message buffers)")
        if spec.plane == "zbuf" and not comm.zbuf.bits:
            raise ValueError(f"fault {spec.text()!r} needs "
                             f"--buffer-bits > 0")
    if (plan or resume) and not ckpt_dir:
        raise ValueError("--fault/--resume need --ckpt-dir")
    if ckpt_dir:
        removed = ckpt.clean_orphans(ckpt_dir)
        if removed:
            print_fn(f"checkpoint: removed {len(removed)} orphaned "
                     f"tmp entr{'y' if len(removed) == 1 else 'ies'}")

    device = torch.device(device)
    state = sim.init_train_state(mcfg, tcfg, dataset.num_samples,
                                 dataset.dc.seq_len,
                                 generator=torch.Generator().manual_seed(seed),
                                 device=device)
    gen = seeded_generator(device, seed, "noise")

    def save_tree() -> dict:
        return {"state": sim.to_jax_state(state),
                "noise": {"seed": np.asarray(seed, np.int64),
                          "generator": gen.get_state()}}

    def restore() -> dict:
        t0 = time.perf_counter()
        tree, body = ckpt.restore_state(ckpt_dir, save_tree(), comm=comm)
        if int(tree["noise"]["seed"]) != seed:
            raise ckpt.CheckpointError(
                "checkpoint PRNG key != this run's seed — resuming "
                "would silently fork the trajectory")
        sim.load_jax_state(state, tree["state"])
        gen.set_state(tree["noise"]["generator"])
        del tree
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        print_fn(f"checkpoint: restored step {body['step']} "
                 f"({ckpt.checkpoint_nbytes(ckpt_dir, body['step'])} B, "
                 f"{time.perf_counter() - t0:.3f} s)")
        return body

    def save(step_done: int, tail: list) -> None:
        t0 = time.perf_counter()
        ckpt.save_state(
            ckpt_dir, save_tree(), step=step_done, comm=comm,
            extra={"losses_tail": [float(x) for x in tail[-5:]],
                   "data_position": step_done}, keep=keep)
        print_fn(f"checkpoint: saved step {step_done} "
                 f"({ckpt.checkpoint_nbytes(ckpt_dir, step_done)} B, "
                 f"{time.perf_counter() - t0:.3f} s)")

    start, loss_tail = 0, []
    if resume:
        body = restore()
        start = int(body["step"])
        loss_tail = list(body["extra"].get("losses_tail", []))
        print_fn(f"resumed from step {start} "
                 f"({ckpt.resolve_checkpoint(ckpt_dir)})")
    elif ckpt_dir and save_every:
        save(0, [])

    guard_state = bool(plan or (ckpt_dir and save_every))
    it = _skip_batches(dataset, batch_size, num_steps, start)
    it_pos = start
    fired = {s for s in plan.faults if s.step < start}
    losses, retries, step = [], 0, start
    while step < num_steps:
        if it_pos != step:
            it = _skip_batches(dataset, batch_size, num_steps, step)
            it_pos = step
        batch = sim.device_batch(next(it), device)
        it_pos += 1

        step_tcfg = tcfg
        post_step = []
        for spec in plan.at(step):
            if spec in fired:
                continue
            fired.add(spec)
            print_fn(f"injecting fault {spec.text()}")
            if spec.plane == "dp":
                step_tcfg = dataclasses.replace(
                    tcfg, comm=F.faulted_comm(comm, spec))
            elif spec.plane == "bw":
                # a corrupt backward hop lands in the params at the
                # update, after the forward wrote clean messages, so bw
                # injection follows the step (the guard's attribution
                # depends on this timing)
                post_step.append(spec)
            else:
                F.inject_sim_state(state, spec, comm)

        state, metrics = sim.train_step(state, batch, gen, mcfg=mcfg,
                                        tcfg=step_tcfg)
        for spec in post_step:
            F.inject_sim_state(state, spec, comm)
        loss = float(metrics["loss"])
        try:
            F.check_train_state(state if guard_state else {},
                                comm=comm, step=step, loss=loss)
        except F.WireFaultError as e:
            print_fn(f"guard tripped: {e}")
            retries += 1
            if not ckpt_dir or retries > max_retries:
                raise
            body = restore()
            step = int(body["step"])
            loss_tail = list(body["extra"].get("losses_tail", []))
            losses = losses[:max(step - start, 0)]
            print_fn(f"recovered from checkpoint step {step} "
                     f"(retry {retries}/{max_retries})")
            continue

        losses.append(loss)
        loss_tail = (loss_tail + [loss])[-5:]
        if log_every and step % log_every == 0:
            print_fn(_loss_line(step, loss))
        if kill_at is not None and step == kill_at:
            print_fn(f"killing at step {step} (exit {KILL_EXIT_CODE})")
            # a hard preemption: no save, no cleanup, no interpreter
            # teardown; the next run recovers from the last committed
            # checkpoint alone (stdout is flushed so the log survives)
            sys.stdout.flush()
            sys.stderr.flush()
            os._exit(KILL_EXIT_CODE)
        step += 1
        if ckpt_dir and save_every and step % save_every == 0:
            save(step, loss_tail)

    if ckpt_dir and save_every and num_steps % save_every != 0:
        save(num_steps, loss_tail)
    return state, losses
