"""Kernel-launch runtime calls (cudaLaunchKernel*, cuLaunchKernel*) of the
device trace an image, counted where they start inside the program's
`model.forward` span (portbench.metrics._spans)."""
from portbench.metrics._spans import launches_per_image


def read(run):
    return launches_per_image(run, "model.forward")
