"""Whole detect's share of the card's peak: the convolution operations of
an image (counted from the reference's frozen architecture at the cell's
shape) times the images per second of the traced run's stretch before the
profiler started, over the peak of the type the configuration computes in."""
from portbench.metrics._peaks import OPS_PER_S


def read(run):
    rate = run.untraced_images_per_s
    if not rate:
        return None
    return 100.0 * run.flops_per_image() * rate / OPS_PER_S[run.cell.config["dtype"]]
