"""Hand-written CUDA kernels for Hopper, built by nvcc into a plain-C shared
library (fdt_torch.ops._build) and bound with ctypes.  Each wrapper takes its
plain PyTorch version for a CPU tensor and launches its kernel, or raises,
for a CUDA tensor."""
