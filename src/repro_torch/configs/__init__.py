"""Architecture registry of the port: the ten LM configs of the reference
(dense, MoE, SSM, hybrid, encoder and VLM families).

The reference's eleventh, ``stencil-suite`` (the paper's Table-2 suite as
an arch config, selected by the dry run), comes with the dry run (ROADMAP
Queue 1 item 16b); ``get_config("stencil-suite")`` refuses it.
"""
from repro_torch.configs.base import (ArchConfig, SHAPES, get_config,  # noqa: F401
                                      list_archs, register)

# importing the modules registers the configs
from repro_torch.configs import (  # noqa: F401,E402
    gemma_7b, granite_moe_3b_a800m, h2o_danube_1p8b, hubert_xlarge,
    internvl2_1b, mamba2_130m, minicpm_2b, qwen3_14b, qwen3_moe_235b_a22b,
    zamba2_2p7b)
