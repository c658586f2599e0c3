"""mamba2-130m [ssm]: attention-free SSD — the paper's closest LM analogue.

[arXiv:2405.21060] 24L d_model=768 (attn-free) vocab=50280, ssm_state=128.
d_inner = 2*d_model = 1536, head_dim 64 -> 24 SSD heads, 1 B/C group.
"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="mamba2-130m", family="ssm",
    n_layers=24, d_model=768, d_ff=0, vocab=50280,
    ssm_state=128, ssm_inner=1536, ssm_head_dim=64, ssm_groups=1,
    rope_theta=None, tie_embeddings=True,
    source="arXiv:2405.21060"))
