"""The SA-GAN attention forward's least time at one launch's shape.

theta (B, N, dk), phi (B, M, dk), g (B, M, dv) -> out (B, N, dv): the bytes
of the four read or written once, against the greater of the two products,
2 B N M (dk + dv) at the tensor cores' peak for the operands' type (bf16, or
TF32 for 4-byte operands: one product, not a split-precision design's
three), and the B N M exponentials of the softmax on the special-function
units. The larger of the bytes' and the arithmetic's time is the bound.
"""
from benchmark.counts.peaks import PEAK_BF16_FLOPS, PEAK_BYTES_PER_S, PEAK_TF32_FLOPS

# Exponentials on the special-function units of one H100 SXM: 16 a cycle per
# SM, 132 SMs, at the 1.83 GHz at which the data sheet's bf16 rate is 4,096
# operations a cycle per SM.
PEAK_EXP_PER_S = 16 * 132 * 1.83e9


def forward_ms(b: int, n: int, m: int, dk: int, dv: int, elem: int) -> float:
    """The forward's least time (ms) for operands of ``elem`` bytes."""
    t_bytes = 1e3 * elem * b * (n * dk + m * dk + m * dv + n * dv) / PEAK_BYTES_PER_S
    flops = 2 * b * n * m * (dk + dv)
    t_products = 1e3 * flops / (PEAK_BF16_FLOPS if elem == 2 else PEAK_TF32_FLOPS)
    t_exp = 1e3 * b * n * m / PEAK_EXP_PER_S
    return max(t_bytes, t_products, t_exp)
