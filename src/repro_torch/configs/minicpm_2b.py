"""minicpm-2b [dense]: llama-like; trains with the WSD schedule.

[arXiv:2404.06395; hf] 40L d_model=2304 36H (kv=36) d_ff=5760 vocab=122753.
"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="minicpm-2b", family="dense",
    n_layers=40, d_model=2304,
    n_heads=36, kv_heads=36, head_dim=64, d_ff=5760, vocab=122753,
    schedule="wsd", tie_embeddings=True,
    microbatches=4,
    source="arXiv:2404.06395; hf"))
