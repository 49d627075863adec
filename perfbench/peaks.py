"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates, at the full 700 W power limit), and the least time a piece of work
can take on it."""

F32_FLOPS = 67e12  # float32 outside the tensor cores
BF16_FLOPS = 989e12  # bf16 on the tensor cores
HBM_BYTES = 3.35e12  # HBM3, bytes per second


def least_time(flops: float, nbytes: float, flops_per_s: float = F32_FLOPS):
    """(seconds, what bounds it): the larger of the operations at the
    compute peak and the bytes at the memory peak."""
    by_ops, by_bytes = flops / flops_per_s, nbytes / HBM_BYTES
    if by_bytes >= by_ops:
        return by_bytes, "bytes"
    return by_ops, "operations"
