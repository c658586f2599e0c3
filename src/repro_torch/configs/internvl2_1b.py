"""internvl2-1b [vlm]: InternViT patch embeddings (stub) + qwen2-like LM.

[arXiv:2404.16821; hf] LM backbone: 24L d_model=896 14H (GQA kv=2) d_ff=4864
vocab=151655.  The ViT frontend is a stub: the model takes 256
precomputed patch embeddings per image, projected into the LM stream.
"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="internvl2-1b", family="vlm",
    n_layers=24, d_model=896,
    n_heads=14, kv_heads=2, head_dim=64, d_ff=4864, vocab=151655,
    vlm_patch_dim=1024, vlm_patches=256, tie_embeddings=True,
    microbatches=4,
    source="arXiv:2404.16821; hf"))
