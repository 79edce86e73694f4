"""Host milliseconds an image in the program's `detect.upload` span over the
traced stretch (portbench.metrics._spans)."""
from portbench.metrics._spans import ms_per_image


def read(run):
    return ms_per_image(run, "detect.upload")
