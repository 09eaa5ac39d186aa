"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates, at the full 700 W power limit). A card set below 700 W reaches
less; the run's ``nvidia-smi`` power limit is printed beside every share
of these."""

PEAKS = {
    "NVIDIA H100 80GB HBM3": {
        "bf16_flops": 989e12,  # tensor cores, dense
        "f32_flops": 67e12,  # outside the tensor cores
        "hbm_bytes": 3.35e12,
    },
}


def peaks(kind: str) -> dict:
    """The peaks of the card named ``kind`` (``torch.cuda.get_device_name``);
    the H100 SXM's for a name not in the table, which a share then
    states against."""
    return PEAKS.get(kind, PEAKS["NVIDIA H100 80GB HBM3"])
