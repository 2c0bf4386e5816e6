"""PyTorch + CUDA port of the TAO-Amodal serving path.

Mirrors :mod:`tao_amodal_tpu` module for module (same file names, same
public function names, same NHWC / xyxy / ``[T, D]`` layouts at the
public boundaries) so each piece can be held against its JAX
counterpart.  Imports ``torch`` and numpy only — never ``jax`` or
``flax`` — so it runs on a machine without them.

The TPU's Pallas kernels on the serving path are hand-written CUDA C++
kernels for Hopper (``csrc/``), built with ``nvcc`` on first use
(:mod:`tao_amodal_torch._build`).  Every kernel wrapper takes its plain
PyTorch version for a CPU tensor and launches the kernel for a CUDA
tensor; there is no fallback between the two.
"""
