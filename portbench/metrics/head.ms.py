"""Device milliseconds an image of the detect head's sort, NMS (K1) and
gather/index kernels in the traced stretch."""


def read(run):
    parts = [run.part_ms_per_image(p) for p in ("sort", "k1", "gather_index")]
    return sum(p or 0.0 for p in parts) if any(parts) else None
