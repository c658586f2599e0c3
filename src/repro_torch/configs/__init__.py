"""Architecture registry of the port: the reference's eleven configs,
the ten LMs (dense, MoE, SSM, hybrid, encoder and VLM families) and
``stencil-suite``, the paper's Table-2 suite as an arch config, which the
dry run (``launch/dryrun.py``) selects.
"""
from repro_torch.configs.base import (ArchConfig, SHAPES, get_config,  # noqa: F401
                                      list_archs, register)

# importing the modules registers the configs
from repro_torch.configs import (  # noqa: F401,E402
    gemma_7b, granite_moe_3b_a800m, h2o_danube_1p8b, hubert_xlarge,
    internvl2_1b, mamba2_130m, minicpm_2b, qwen3_14b, qwen3_moe_235b_a22b,
    stencil_suite, zamba2_2p7b)
