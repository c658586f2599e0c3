"""The float32 flash kernels' rounding, replayed on the CPU: TF32 operands
as ``cvt.rna.tf32.f32`` makes them, and 3xTF32 products.

``csrc/flash_attention_tf32.cu`` and ``csrc/flash_attention_bwd_tf32.cu``
split each float32 operand x into hi = tf32_rna(x) and lo = tf32_rna(x -
hi) and sum hi_a·lo_b + lo_a·hi_b + hi_a·hi_b into float32 (one TF32 pass:
hi_a·hi_b alone).  A product of two TF32 values is exact in float32 (11 ×
11 significant bits), so the replay's float32 matmuls differ from the
tensor cores' only in the order of the sums.
"""
import torch


def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """``cvt.rna.tf32.f32`` bit for bit on finite float32: round to 10
    mantissa bits, to nearest with ties away from zero — add 0x1000 to the
    magnitude bits (the word's, as float32 is sign-magnitude), then clear
    the low 13."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def split(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernels' (hi, lo) pair of a float32 operand."""
    hi = tf32_rna(x)
    return hi, tf32_rna(x.float() - hi)


def mm(a: torch.Tensor, b: torch.Tensor, passes: int = 3) -> torch.Tensor:
    """``a @ b`` as the kernels issue it: 3xTF32 (small terms first) or,
    with ``passes=1``, one TF32 pass."""
    (ah, al), (bh, bl) = split(a), split(b)
    if passes == 1:
        return ah @ bh
    return ah @ bl + al @ bh + ah @ bh
