"""Device milliseconds an image of every other kernel outside the detect
head: BatchNorm, activations, adds, upsampling, softmax, decode."""


def read(run):
    return run.part_ms_per_image("other")
