"""The table of peaks that the `mfu` and `*_roofline` readers divide by.

NVIDIA H100 SXM data sheet, dense rates at the full 700 W power limit
(the port's kernel bounds use the same): 989 TFLOP/s bf16 on the tensor
cores, 1,979 TOP/s int8, 67 TFLOP/s float32 outside the tensor cores,
3.35 TB/s of HBM bandwidth. A model family counts its own model FLOPs
(`families/<family>.py`, `flops_per_frame`).
"""

H100_PEAK_BF16_FLOPS = 989e12
H100_PEAK_INT8_OPS = 1979e12
H100_PEAK_F32_FLOPS = 67e12
H100_HBM_BYTES_PER_S = 3.35e12
