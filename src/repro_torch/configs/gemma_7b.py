"""gemma-7b [dense]: GeGLU MLP, head_dim=256, embedding scaling.

[arXiv:2403.08295; hf] 28L d_model=3072 16H (kv=16) d_ff=24576 vocab=256000.
"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="gemma-7b", family="dense",
    n_layers=28, d_model=3072,
    n_heads=16, kv_heads=16, head_dim=256, d_ff=24576, vocab=256000,
    act="geglu", embed_scale=True, tie_embeddings=True,
    microbatches=4,
    source="arXiv:2403.08295; hf"))
