"""The ``--distributed`` launcher's report, as the JAX launcher prints it
(`repro.launch.train`): ``final loss`` is the last step's loss (the
single-host path keeps the mean of the last five, JAX's rule there),
and after rank 0 has removed the staged ``.tmp-*`` entries a killed
writer left in the checkpoint directory and its ``torch_rows`` sidecar
(`repro_torch.training.pipeline_state`), the launcher prints
``checkpoint: removed N orphaned tmp entries`` once, N summed over
both; a resume from a checkpoint without the sidecar (as the JAX
package writes them) says once that the rows it would hold start at
zero.

One run of a 2 x 2 gloo mesh on the CPU (``gpt2-xl-paper`` SMOKE, 3
steps, one torch thread a rank).  This module imports no JAX.
"""
import os
import shutil

import numpy as np

from repro_torch.checkpoint import checkpoint as ck
from repro_torch.launch import train as tlaunch

SPAWN_TIMEOUT = 240.0
ARGS = ["--device", "cpu", "--smoke", "--distributed", "--data-par", "2",
        "--stages", "2", "--dp-grad-bits", "4", "--steps", "3", "--seq",
        "16", "--samples", "8", "--batch", "4"]


def test_final_loss_and_orphans_as_jax_prints_them(capsys, monkeypatch,
                                                    tmp_path):
    monkeypatch.setattr(tlaunch, "JOIN_TIMEOUT", SPAWN_TIMEOUT)
    ckpt_dir = tmp_path / "ckpt"
    staged = {"": [ck.TMP_PREFIX + "a", ck.TMP_PREFIX + "b"],
              "torch_rows": [ck.TMP_PREFIX + "c"]}
    for rank, names in staged.items():
        for name in names:
            os.makedirs(ckpt_dir / rank / name)
            (ckpt_dir / rank / name / "arrays.npz").write_bytes(b"partial")
    results, losses = tlaunch.main(ARGS + ["--ckpt-dir", str(ckpt_dir),
                                           "--save-every", "2"])
    lines = capsys.readouterr().out.splitlines()
    assert len(losses) == 3 and np.all(np.isfinite(losses))
    assert [r["orphans_removed"] for r in results] == [3, 0, 0, 0]
    assert lines.count("checkpoint: removed 3 orphaned tmp entries") == 1
    assert sum("orphaned" in ln for ln in lines) == 1
    assert lines[-1] == f"final loss {losses[-1]:.4f}"
    for rank, names in staged.items():
        left = os.listdir(ckpt_dir / rank)
        assert not [n for n in left if n.startswith(ck.TMP_PREFIX)], left
    # a run with nothing staged prints no such line; without the
    # sidecar its rows start at zero, and the launcher says so
    shutil.rmtree(ckpt_dir / "torch_rows")
    _, resumed = tlaunch.main(ARGS + ["--ckpt-dir", str(ckpt_dir),
                                      "--resume"])
    lines = capsys.readouterr().out.splitlines()
    assert not any("orphaned" in ln for ln in lines)
    assert lines.count("checkpoint: step 2 has no torch_rows sidecar of "
                       "its commit (the JAX package writes none): the "
                       "message rows past samples // data-par start at "
                       "zero") == 1
    assert "resumed from step 2" in lines and len(resumed) == 1
    assert lines[-1] == f"final loss {resumed[-1]:.4f}"
