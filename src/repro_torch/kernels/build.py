"""Build the CUDA kernels at first use and load them with ctypes.

``nvcc`` compiles each ``csrc/*.cu`` into a shared library with a plain
C interface (no PyTorch headers, so a build takes seconds), under
``build/repro_torch_kernels/`` at the repository root.  The library's
name carries a hash of its source and flags, so an edited source
rebuilds and an unchanged one loads the library already built.  A
build holds an exclusive lock on ``build/repro_torch_kernels/<name>.lock``,
so processes started together (the ranks of a distributed run) compile
each library once: the first builds it, the others wait and load it.
Different libraries lock different files, so builds of different
libraries can run side by side.

Flags: ``-gencode arch=compute_90a,code=sm_90a -std=c++17 -O3``, and
deliberately no ``--use_fast_math`` or ``-prec-div=false``: the kernels
promise bit parity with the JAX package and rely on IEEE division.
"""
from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

from repro_torch import env

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / \
    "repro_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_I64 = ctypes.c_longlong
_I = ctypes.c_int
_F = ctypes.c_float
_U = ctypes.c_uint
# C signature of every extern "C" launcher, by library
SIGNATURES = {
    "quant_pack": {
        "rt_delta_quantize_pack": (_P, _P, _P, _P, _P, _P, _P, _I64, _I64, _I,
                                   _I, _I, _I, _P),
        "rt_dequant_unpack_accumulate": (_P, _P, _P, _P, _I64, _I64, _I, _I,
                                         _P),
        "rt_quantize_pack": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I64,
                             _I64, _I64, _I64, _I64, _I64, _P, _I64, _I64,
                             _I, _I, _I, _I, _P),
        "rt_unpack_dequant": (_P, _P, _P, _P, _P, _P, _I64, _I64, _I, _I, _U,
                              _U, _I, _P),
        "rt_quantize_pack_scaled": (_P, _P, _P, _P, _I64, _I64, _I, _I, _P),
        "rt_unpack_codes": (_P, _P, _I64, _I, _I, _P),
        "rt_quantize_codes_scaled": (_P, _P, _P, _P, _P, _P, _I64, _I64, _I,
                                     _I, _P),
        "rt_dequant_sum_mean": (_P, _P, _P, _I64, _I64, _F, _F, _I, _P),
        "rt_unpack_accumulate": (_P, _P, _P, _I64, _I, _I, _P),
        "rt_pack_sums": (_P, _P, _I64, _I, _I, _P),
        "rt_unpack_sums": (_P, _P, _I64, _I, _I, _P),
        "rt_launch_floor": (_P,),
    },
    "flash_attention": {
        "rt_flash_attention_fwd": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                                   _I, _I, _I, _I, _I, _F, _F, _I, _P),
    },
}

_LOCK = threading.Lock()
_LOADED: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """The CUDA compiler: on PATH, else under CUDA_HOME or
    /usr/local/cuda."""
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(env.cuda_home()) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (PATH, CUDA_HOME, /usr/local/cuda): "
                       "the CUDA kernels cannot be built on this machine")


def library_path(name: str) -> Path:
    """Where the library of ``csrc/<name>.cu`` is (or will be) built."""
    src = (CSRC / f"{name}.cu").read_bytes()
    tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{tag[:16]}.so"


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless its library is already built,
    under the build lock.  The compiler writes a private file that is
    renamed into place, so no process loads a half-written library."""
    out = library_path(name)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / f"{name}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)    # released when the file closes
        if out.exists():                    # built while this one waited
            return out
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}) for "
                               f"{name}.cu:\n{proc.stdout}\n{proc.stderr}")
        os.replace(tmp, out)
    return out


def load(name: str) -> ctypes.CDLL:
    """Build (at first use) and load one kernel library, with argtypes
    and restype set on every launcher."""
    with _LOCK:
        lib = _LOADED.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build(name)))
            for fn, argtypes in SIGNATURES[name].items():
                f = getattr(lib, fn)
                f.argtypes = list(argtypes)
                f.restype = ctypes.c_int
            _LOADED[name] = lib
        return lib
