"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates
without sparsity, at the full 700 W power limit): the denominators of every
share of a peak or a roofline the benchmark reports. The card's own power
limit is printed beside them (``timing.card_record``)."""

FLOPS = {
    "bf16": 989e12,   # tensor cores, bfloat16 and float16
    "tf32": 495e12,   # tensor cores, float32 convolutions under TF32
    "f32": 67e12,     # float32 outside the tensor cores
    "fp8": 1979e12,
    "int8": 1979e12,
}
HBM_BYTES_PER_S = 3.35e12
HBM_BYTES = 80e9


def roofline_s(flops, nbytes, precision="f32"):
    """The least time the card could take: the larger of the operations at
    the precision's peak and the bytes at the memory's peak."""
    return max(flops / FLOPS[precision], nbytes / HBM_BYTES_PER_S)
