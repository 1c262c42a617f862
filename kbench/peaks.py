"""Published peaks of the devices the benchmark runs on, by the name that
``torch.cuda.get_device_name`` gives.  H100 SXM, NVIDIA's data sheet: 80 GB
of HBM3 at 3.35 TB/s."""

PEAKS = {
    "NVIDIA H100 80GB HBM3": {"hbm_bytes_per_s": 3.35e12},
}


def hbm_bytes_per_s(kind: str):
    """The device's memory bandwidth, None for a device not listed."""
    return PEAKS.get(kind, {}).get("hbm_bytes_per_s")
