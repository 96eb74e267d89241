"""Split-precision arithmetic of the port's float32 tensor-core kernels,
emulated on the CPU: the helpers that ``tests/test_torch_attn_f32_split_numerics.py``
and ``tests/test_torch_sg2_tail_f32_split_numerics.py`` share.

A float32 operand x is carried as hi = tf32(x) and lo = tf32(x - hi), both
rounded to nearest with ties away from zero as ``cvt.rna.tf32.f32`` rounds
(the 3xTF32 split); each ``mma.sync`` adds its products into a float32
accumulator and rounds the sum toward zero, as the tensor cores round.
"""
import torch


def tf32(x):
    """Round float32 to TF32 (10 mantissa bits), nearest with ties away from
    zero: ``cvt.rna.tf32.f32``, whose result keeps the float32 layout."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def split_pieces(x, split):
    """The pieces a kernel carries for x under ``split``, widest first."""
    x = x.float()
    if split == "3xtf32":
        hi = tf32(x)
        return hi, tf32(x - hi)
    if split == "tf32":
        return (tf32(x),)
    if split == "bf16x2":
        hi = x.bfloat16().float()
        return hi, (x - hi).bfloat16().float()
    if split == "bf16x3":
        hi = x.bfloat16().float()
        mid = (x - hi).bfloat16().float()
        return hi, mid, (x - hi - mid).bfloat16().float()
    raise ValueError(split)


def round_toward_zero(x):
    """float64 to float32, rounded toward zero as the tensor cores round
    their float32 sums."""
    y = x.float()
    return torch.where(y.double().abs() > x.abs(), torch.nextafter(y, torch.zeros_like(y)), y)
