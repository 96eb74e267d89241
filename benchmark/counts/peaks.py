"""Published peaks of one NVIDIA H100 SXM (data sheet; dense rates, 700 W)."""

PEAK_BYTES_PER_S = 3.35e12      # HBM3
PEAK_TF32_FLOPS = 495e12        # TF32 on the tensor cores
PEAK_BF16_FLOPS = 989e12        # bf16 operands, f32 accumulation, tensor cores
