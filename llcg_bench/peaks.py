"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates, at its 700 W power limit).  A roofline share or an ``mfu`` is stated
against these, with the card's power limit beside it."""

#: HBM3 bandwidth, bytes per second.
HBM_BYTES_PER_S = 3.35e12

#: Operations per second by the precision a configuration computes in.
OPS_PER_S = {
    "float32": 67e12,       # outside the tensor cores (TF32 off)
    "tf32": 495e12,
    "bfloat16": 989e12,
    "float16": 989e12,
    "fp8": 1979e12,
    "int8": 1979e12,
}


def bound_seconds(nbytes: float, ops: float, precision: str = "float32"
                  ) -> float:
    """The least time the chip could take: the larger of bytes over the
    HBM bandwidth and operations over the precision's peak."""
    return max(nbytes / HBM_BYTES_PER_S, ops / OPS_PER_S[precision])
