"""Host milliseconds an image in the program's `model.forward` span over the
traced stretch: the host's enqueue of the network.  Above model.conv_ms plus
model.other_ms, the launches set the pace (portbench.metrics._spans)."""
from portbench.metrics._spans import ms_per_image


def read(run):
    return ms_per_image(run, "model.forward")
