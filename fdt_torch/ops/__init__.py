"""Hand-written CUDA kernels for Hopper, built by nvcc into a plain-C shared
library (fdt_torch.ops._build) and bound with ctypes.  Each wrapper takes its
plain PyTorch version for a CPU tensor and launches its kernel, or raises,
for a CUDA tensor."""
from fdt_torch.ops.quant import Int8Conv2d, quant_mode, quantized

Int8Conv = Int8Conv2d  # fdt.ops' name for it

__all__ = ["Int8Conv", "Int8Conv2d", "quant_mode", "quantized"]
