"""hubert-xlarge [audio]: encoder-only masked-unit prediction.

[arXiv:2106.07447] 48L d_model=1280 16H (kv=16) d_ff=5120 vocab=504.
The CNN waveform frontend is a stub: the model takes precomputed frame
embeddings (B, S, d); the conv positional embedding is replaced by
nothing (frames carry position), as in the reference.
"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="hubert-xlarge", family="encoder",
    n_layers=48, d_model=1280,
    n_heads=16, kv_heads=16, head_dim=80, d_ff=5120, vocab=504,
    act="gelu", norm="ln", rope_theta=None, tie_embeddings=False,
    microbatches=4,
    source="arXiv:2106.07447"))
