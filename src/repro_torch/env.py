"""The environment knobs of the port: the one module of `repro_torch`
that reads the process environment.

==================  =======  ==============================================
knob                default  meaning
==================  =======  ==============================================
ACSGD_ONCORE_PRNG   ``0``    ``1`` makes the CUDA encode kernels draw the
                             noise of stochastic rounding themselves
                             (Philox4x32-10 seeded by a (2,) int32 key,
                             `repro_torch.kernels.ref.oncore_uniform_ref`)
                             instead of reading a noise tensor.  The
                             reference backend ignores it.
CUDA_HOME           unset    where ``bin/nvcc`` is when it is not on PATH
                             (default ``/usr/local/cuda``).
==================  =======  ==============================================

The counterpart of `repro.env` (whose ``REPRO_ONCORE_PRNG`` does the
same for the Pallas kernels).  The prefix is not ``REPRO_``: the JAX
package's lint rule ``no-stray-env-read`` holds every ``REPRO_*`` read
to `repro.env`.  Knobs are read at call time, so tests may set them
with ``monkeypatch.setenv``.
"""
from __future__ import annotations

import os

ONCORE_PRNG = "ACSGD_ONCORE_PRNG"


def oncore_prng() -> bool:
    """Whether stochastic encodes on the CUDA backend draw their noise
    inside the kernel (``ACSGD_ONCORE_PRNG=1``)."""
    return os.environ.get(ONCORE_PRNG, "0") == "1"


def cuda_home() -> str:
    """The CUDA toolkit's root, for finding nvcc off PATH."""
    return os.environ.get("CUDA_HOME", "/usr/local/cuda")
