"""The two tail kernels' least times at one launch's shape.

Each counts the least arithmetic of a section and each byte once, whatever
design runs it: the input, the weights and the vectors read once, the outputs
written once. The operations are taken at the peak of the unit the kernels
run their products on, the tensor cores: bf16 for 2-byte elements, TF32 for
4-byte ones (one product, not a split-precision design's three).
"""
from benchmark.counts.peaks import PEAK_BF16_FLOPS, PEAK_BYTES_PER_S, PEAK_TF32_FLOPS


def _least_ms(bytes_moved: float, flops: float, elem: int) -> float:
    t_bytes = 1e3 * bytes_moved / PEAK_BYTES_PER_S
    t_ops = 1e3 * flops / (PEAK_BF16_FLOPS if elem == 2 else PEAK_TF32_FLOPS)
    return max(t_bytes, t_ops)


def proggan_section_flops(b: int, c: int, h: int, w: int, head: bool) -> float:
    """One ProgGAN tail section, 2C channels at (H, W) to C at (2H, 2W): the
    nearest-up and 3x3 conv merged by output parity are 4 taps of 2C x C per
    output pixel, not 9; then 9 taps of C x C, and 3 C for the RGB head."""
    r2 = 4 * h * w
    return b * r2 * (2 * (4 * 2 * c * c + 9 * c * c) + (2 * 3 * c if head else 0))


def proggan_section_ms(b: int, c: int, h: int, w: int, head: bool, elem: int) -> float:
    """A ProgGAN tail section's least time (ms)."""
    r2 = 4 * h * w
    n_w = 9 * 2 * c * c + 9 * c * c + 2 * c + 2 + ((3 * c + 4) if head else 0)
    bytes_moved = elem * (b * 2 * c * h * w + b * (3 if head else c) * r2 + n_w)
    return _least_ms(bytes_moved, proggan_section_flops(b, c, h, w, head), elem)


def sg2_section_flops(b: int, c: int, h: int, w: int) -> float:
    """One StyleGAN2 tail section, 2C channels at (H, W) to C at (2H, 2W): the
    stride-2 transposed conv is 9 taps of 2C x C per input pixel (2.25 per
    output pixel), the separable blur 8 C per output pixel, the same-conv
    9 C^2, ToRGB 3 C."""
    r2 = 4 * h * w
    return 2 * (b * h * w * 9 * 2 * c * c + b * r2 * (8 * c + 9 * c * c + 3 * c))


def sg2_section_ms(b: int, c: int, h: int, w: int, want_x2: bool, elem: int) -> float:
    """A StyleGAN2 tail section's least time (ms): the input, the weights, the
    style vectors and the two noise maps read once, rgb (and x2 when the next
    block takes it) written once."""
    r2 = 4 * h * w
    n_small = 9 * 2 * c * c + 9 * c * c + 3 * c + 2 * c + 5 + b * 6 * c + 2 * r2
    bytes_moved = elem * (b * 2 * c * h * w + b * (3 + (c if want_x2 else 0)) * r2 + n_small)
    return _least_ms(bytes_moved, sg2_section_flops(b, c, h, w), elem)
