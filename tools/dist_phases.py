#!/usr/bin/env python3
"""chip_smoke's distributed phases alone, for one source tree.

    python3 tools/dist_phases.py [--src TREE] [--checks] [--no-variants]
                                 [--sim-resume] [--resume] [--examples]

Runs the tree's own `chip_smoke.dist_phases` (``[dist-train]`` and its
``-sharded``, ``-fp16`` and ``-adam8`` variants: gpt2-xl-paper at full
width, 8 of 48 layers, a 2 x 2 mesh of processes on the one card) and,
with ``--checks``, its `dist_reference_checks` (the SMOKE checks, card
against CPU, and where the tree has it ``[dist-fsdp-check]``) and
`dist_resume_phase` (``[dist-train-resume]``, and where the tree has
them ``[dist-train-oncore]`` and ``[dist-seeded-check]``), with their
asserts, printing chip_smoke's lines for them.  ``--no-variants`` skips
`dist_phases`; ``--sim-resume`` also runs `train_resume_phase`
(``[train-resume]``, ``[train-resume-oncore]``, ``[train-fault]``); ``--resume`` runs
`dist_resume_phase` without the SMOKE checks, and ``--examples`` the
tree's `examples_phase` (``[examples]``).  ``--src`` (default: this
checkout) is the root of a checkout, so one call on the card can run
two versions in turns: unpack the other commit into a directory that
``.gitignore`` lists (``git archive <commit> | tar -x -C build/parent``)
and run ``--src build/parent``, then this tree.  Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--src", default=ROOT)
    ap.add_argument("--checks", action="store_true")
    ap.add_argument("--no-variants", action="store_true")
    ap.add_argument("--sim-resume", action="store_true")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--examples", action="store_true")
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.src))
    import chip_smoke as cs          # the tree's, which puts its src first
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("the distributed phases need a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cs.phase("card", nvidia_smi=f"'{cs.nvidia_smi_line()}'",
             src=os.path.abspath(args.src), torch=torch.__version__)
    if not args.no_variants:
        cs.dist_phases(torch)
    if args.checks:
        cs.dist_reference_checks(torch)
    if args.checks or args.resume:
        cs.dist_resume_phase(torch)
    if args.examples:
        cs.examples_phase()
    if args.sim_resume:
        from repro_torch import env
        from repro_torch.kernels import quant_pack as qp
        cs.train_resume_phase(torch, qp, env)
    return 0


if __name__ == "__main__":
    sys.exit(main())
