"""The one traffic generator: frames and arrival times from a seed and the
parameters of a traffic mix (portbench/traffic/<name>.json).

Frames are BGR uint8 noise, uniform per pixel, drawn on the host (requests
and batches come from host memory, as a user's do).  Open-loop arrivals
are Poisson in shape with a fixed count, rate × seconds, whose gaps are
scaled to fill the window exactly: every seed offers the same number of
requests over the same time, in another order.  The same seed gives the
same traffic; streams of one seed are told apart by a second key.
"""
from __future__ import annotations

import numpy as np

FRAMES, ARRIVALS, PICKS, SAMPLE = range(4)


def rng(seed: int, stream: int) -> np.random.Generator:
    return np.random.default_rng([int(seed), stream])


def frames(seed: int, count: int, height: int, width: int) -> np.ndarray:
    """[count, height, width, 3] uint8."""
    return rng(seed, FRAMES).integers(0, 256, (count, height, width, 3), dtype=np.uint8)


def arrivals(seed: int, rate_per_s: float, seconds: float) -> np.ndarray:
    """Due times in seconds from the window's start, ascending, in
    [0, seconds): round(rate × seconds) of them."""
    n = max(1, round(rate_per_s * seconds))
    gaps = rng(seed, ARRIVALS).exponential(1.0, n + 1)
    return (np.cumsum(gaps)[:-1] / gaps.sum() * seconds).astype(np.float64)


def picks(seed: int, count: int, choices: int) -> np.ndarray:
    """Which of `choices` frames each of `count` requests sends."""
    return rng(seed, PICKS).integers(0, choices, count)


def sample(seed: int, population: int, k: int) -> np.ndarray:
    """k distinct indices of range(population), ascending."""
    k = min(k, population)
    return np.sort(rng(seed, SAMPLE).choice(population, k, replace=False))
