"""Hand-written CUDA kernels for Hopper and their plain PyTorch versions.

`csrc/` holds the CUDA C++ sources, `build` compiles them with nvcc at
first use and loads them with ctypes, `quant_pack` wraps each kernel
(CPU tensors take the plain version in `ref`), and `ops` flattens any
``(..., d)`` batch shape to the kernels' rows.
"""
