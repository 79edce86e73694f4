"""Device milliseconds an image of convolution and matrix-product kernels
(cuDNN, cuBLAS) in the traced stretch."""


def read(run):
    return run.part_ms_per_image("conv_matmul")
