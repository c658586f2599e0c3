"""granite-moe-3b-a800m [moe]: 40 experts, top-8 (padded to 48 slots, a
multiple of 16; phantom experts masked in the router).

[hf:ibm-granite/granite-3.0-3b-a800m-base] 32L d_model=1536 24H (GQA kv=8)
expert d_ff=512 vocab=49155.
"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="granite-moe-3b-a800m", family="moe",
    n_layers=32, d_model=1536,
    n_heads=24, kv_heads=8, head_dim=64, d_ff=512, vocab=49155,
    n_experts=40, top_k=8, tie_embeddings=True,
    microbatches=4,
    source="hf:ibm-granite/granite-3.0-3b-a800m-base"))
