"""Published peaks of the cards the benchmark knows (NVIDIA's data sheet,
H100 SXM, dense rates without sparsity), looked up by the device's name."""

PEAKS = {
    "H100": {"bf16_flops": 989.4e12},
}


def peaks_for(device_name: str):
    """The peak table of `device_name`, or None for a card not listed."""
    for key, table in PEAKS.items():
        if key in device_name:
            return table
    return None
