"""The table of peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense,
outside the tensor cores) and the bound they give a piece of work.  These
rates assume the card's full 700 W; a run prints the card's power limit
beside every share taken against them.  K1 stores float16 and bfloat16 in
2 bytes and computes them in float32, so their operations run at
float32's peak."""
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "float64": 33.5e12, "float16": 67e12,
              "bfloat16": 67e12}
ITEMSIZE = {"float32": 4, "float64": 8, "float16": 2, "bfloat16": 2}


def bound(nbytes: float, ops: float, dtype: str) -> tuple:
    """``(seconds, what binds)``: the larger of the bytes over the memory's
    rate and the operations over the dtype's peak."""
    by_bytes = nbytes / HBM_BYTES_PER_S
    by_ops = ops / PEAK_FLOPS[dtype]
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops,
                                                           "operations")
