"""Published peaks of the cards the benchmark runs on (NVIDIA's data
sheet, SXM part, dense rates, at the full 700 W power limit): float32
outside the tensor cores, and HBM bandwidth. Keyed by
``torch.cuda.get_device_name()``."""
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"float32_flops": 67e12, "bytes_per_s": 3.35e12},
}
