"""Architecture registry of the port: the dense family's four configs.

The MoE, SSM, hybrid, encoder and VLM configs come with their families'
modules (ROADMAP Queue 1 item 15).
"""
from repro_torch.configs.base import (ArchConfig, SHAPES, get_config,  # noqa: F401
                                      list_archs, register)

# importing the modules registers the configs
from repro_torch.configs import (  # noqa: F401,E402
    gemma_7b, h2o_danube_1p8b, minicpm_2b, qwen3_14b)
