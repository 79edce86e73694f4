"""Mean requests a device batch in the serving layer over the window: the
MicroBatcher's own counts (DetectionService.stats()) after the window less
those before it."""


def read(run):
    return run.stats.get("mean_batch_size") or None
