"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates,
at its 700 W power limit). A roofline share is stated against these, with
the card's power limit beside it in the run's device record."""

HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12      # outside the tensor cores


def least_seconds(bytes_moved: float, ops: float) -> float:
    """The least time the card could take: the larger of the bytes over the
    memory rate and the fp32 operations over their peak rate."""
    return max(bytes_moved / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S)


def roofline_pct(least_s: float, device_s: float):
    """100 x least time / measured device time; None where nothing ran."""
    if device_s <= 0 or least_s <= 0:
        return None
    return 100.0 * least_s / device_s
