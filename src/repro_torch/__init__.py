"""repro_torch: the PyTorch and CUDA port of the EBISU temporal-blocking
stencil system, for an NVIDIA H100.

It mirrors the JAX reference package ``repro`` module for module and is
held against it by the ``tests/test_torch_*.py`` suite.  Slice 1 is the
2-D main path: ``repro_torch.api.compile_stencil`` → ``StencilProgram``
``.apply``/``.run``, carried by the hand-written CUDA tile kernel in
``repro_torch/kernels/csrc/stencil2d.cu``; slice 2 the 3-D half on
``csrc/stencil3d.cu``.  Slice 3 is LM serving of the dense family
(``launch.serve`` → ``models.transformer.prefill``/``decode_step``),
whose attention goes through ``api.compile_attention`` to the CUDA flash
kernels (``csrc/flash_attention_mma.cu`` for bfloat16,
``csrc/flash_attention_tf32.cu`` for float32).  Later slices added
training, the program's features, and the SSM, hybrid, MoE, encoder and
VLM families (``models/ssm.py``, ``models/moe.py``).

Importing the package is cheap: it imports neither ``jax`` nor
``triton``, initializes no CUDA context and compiles nothing; each kernel
is built at its first launch.
"""
