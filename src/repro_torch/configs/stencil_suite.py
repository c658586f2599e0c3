"""The paper's own workload as an arch config: the Table-2 stencil suite.

Not an LM: the dry run selects it with ``--arch stencil-suite``; its
"shapes" are the paper's domains, distributed over the production mesh
with deep-halo temporal blocking (``core/distributed.py``).
"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="stencil-suite", family="stencil", n_layers=0, d_model=0,
    source="ICS'23 EBISU Table 2"))
