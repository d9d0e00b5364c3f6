"""PyTorch/CUDA port of the AQ-SGD reproduction (`repro`).

The layout mirrors `repro` module for module, so each module's
counterpart is easy to find.  This package imports ``torch`` and never
``jax`` or ``repro``; the tests feed both packages the same numpy
inputs.  The codec kernels are CUDA C++ for Hopper (``sm_90a``) under
`repro_torch.kernels.csrc`, built with ``nvcc`` at first use.

Ported so far, for the dense family (``gpt2-xl-paper``): uniform-batch
prefill + greedy decode with the delta-coded pipeline hop
(`serving.delta`) and the quantized KV cache (`serving.kvcache`); the
single-process AQ-SGD trainer (`training.simulated`) with
error-feedback compressed data-parallel gradients
(`core.grad_compress`); and the distributed GPipe trainer
(`training.pipeline`) over a process mesh (`launch.mesh`) with the
compressed ring DP wire (`core.collectives`).
"""
