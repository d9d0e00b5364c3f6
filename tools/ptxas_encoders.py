#!/usr/bin/env python3
"""What the compiler gives each encoder instance of
``src/repro_torch/kernels/csrc/quant_pack.cu``: registers a thread,
stack, spill stores and loads, from ``nvcc -Xptxas -v`` with the build's
own flags (`repro_torch.kernels.build.NVCC_FLAGS`).

    python3 tools/ptxas_encoders.py

Prints one JSON line, ``{"nvcc_flags": [...], "instances": {name:
{"registers": r, "stack": b, "spill_stores": b, "spill_loads": b}}}``,
one entry for every instantiation of ``encode_rows``,
``encode_rows_into``, ``encode_rows_block`` and
``encode_rows_block_into`` (names demangled to their template
arguments: bits, delta, lanes a row, float4s a lane).  Needs ``nvcc``
(the machine with the card); the library it builds goes to a temporary
directory and is thrown away.
"""
from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

ENCODERS = ("encode_rows_block_into", "encode_rows_block",
            "encode_rows_into", "encode_rows")


def _instance(mangled: str):
    """``encode_rows_block<4, true, 4>`` from a mangled entry name, or
    None for a kernel that is not an encoder."""
    for name in ENCODERS:
        m = re.search(rf"\d+{name}I((?:L[ib]\d+E)+)E", mangled)
        if m:
            args = re.findall(r"L([ib])(\d+)E", m.group(1))
            vals = [("true" if v == "1" else "false") if t == "b" else v
                    for t, v in args]
            return f"{name}<{', '.join(vals)}>"
    return None


def parse(text: str) -> dict:
    """The ptxas report's lines, per encoder instance."""
    out, cur = {}, None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            cur = _instance(m.group(1))
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            out.setdefault(cur, {}).update(
                stack=int(m.group(1)), spill_stores=int(m.group(2)),
                spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out.setdefault(cur, {})["registers"] = int(m.group(1))
    return out


def main() -> dict:
    from repro_torch.kernels import build
    flags = [*build.NVCC_FLAGS, "-Xptxas", "-v"]
    with tempfile.TemporaryDirectory() as tmp:
        proc = subprocess.run(
            [build.nvcc_path(), *flags, "-o", os.path.join(tmp, "lib.so"),
             str(build.CSRC / "quant_pack.cu")],
            capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed:\n{proc.stdout}\n{proc.stderr}")
    out = {"nvcc_flags": flags,
           "instances": dict(sorted(parse(proc.stdout + proc.stderr)
                                    .items()))}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
