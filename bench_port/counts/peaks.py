"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates without sparsity, at the 700 W power limit)."""

F32_FLOPS = 67e12      # float32 outside the tensor cores
TF32_FLOPS = 495e12    # TF32 products on the tensor cores
BF16_FLOPS = 989e12    # bf16 products on the tensor cores
MEMORY_BYTES = 3.35e12  # HBM3 bytes a second

# the peak that products of each configured dtype count against: f32
# operands against TF32's, so that no f32 implementation can pass 100%
PRODUCT_PEAK = {'float32': TF32_FLOPS, 'bfloat16': BF16_FLOPS}
