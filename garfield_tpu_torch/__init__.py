"""PyTorch and CUDA port of garfield_tpu for NVIDIA Hopper (H100).

A package of its own beside ``garfield_tpu`` (the JAX reference, which it
never imports). Module names mirror the JAX package, so each module's
counterpart is found under the same path there. The kernels of the JAX
package's Pallas TPU path are written by hand in CUDA C++ for ``sm_90a``
(``ops/csrc/``); every kernel keeps a plain PyTorch version beside it, which
is what a tensor on the CPU runs.

Entry points run on ``cuda`` by default and raise when CUDA is absent unless
the caller passes ``device="cpu"``.
"""
