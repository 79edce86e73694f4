"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet; dense rates,
no sparsity, at the full 700 W power limit): operations per second by the
type the work is computed in, and HBM3 bytes per second."""

OPS_PER_S = {
    "bfloat16": 989e12,   # tensor cores
    "float16": 989e12,
    "tf32": 495e12,
    "float32": 67e12,     # outside the tensor cores
    "int8": 1979e12,
    "fp8": 1979e12,
}
HBM_BYTES_PER_S = 3.35e12


def bound_s(ops: float, dtype: str, nbytes: float) -> float:
    """The least time the card could take: the larger of the operations at
    the peak rate of `dtype` and the bytes at the memory's peak."""
    return max(ops / OPS_PER_S[dtype], nbytes / HBM_BYTES_PER_S)
