"""repro_torch: the PyTorch and CUDA port of the EBISU temporal-blocking
stencil system, for an NVIDIA H100.

It mirrors the JAX reference package ``repro`` module for module and is
held against it by the ``tests/test_torch_*.py`` suite.  Slice 1 is the
2-D main path: ``repro_torch.api.compile_stencil`` → ``StencilProgram``
``.apply``/``.run``, carried by the hand-written CUDA tile kernel in
``repro_torch/kernels/csrc/stencil2d.cu``.

Importing the package is cheap: it imports neither ``jax`` nor
``triton``, initializes no CUDA context and compiles nothing; the kernel
is built at its first launch.
"""
