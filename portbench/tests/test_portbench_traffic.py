"""The generator: the same seed gives the same traffic; seeds give the same
amount of work in another order."""
import numpy as np

from portbench import generate

SEED = 2**31 + 12345  # past 32 signed bits, as the check's seeds are


def test_frames_are_deterministic_per_seed():
    a = generate.frames(SEED, 3, 16, 24)
    assert a.shape == (3, 16, 24, 3) and a.dtype == np.uint8
    assert np.array_equal(a, generate.frames(SEED, 3, 16, 24))
    assert not np.array_equal(a, generate.frames(SEED + 1, 3, 16, 24))


def test_arrivals_fill_the_window_with_a_fixed_count():
    a = generate.arrivals(SEED, 400.0, 10.0)
    b = generate.arrivals(SEED + 1, 400.0, 10.0)
    assert len(a) == len(b) == 4000
    assert np.all(np.diff(a) >= 0) and 0 <= a[0] and a[-1] < 10.0
    assert np.array_equal(a, generate.arrivals(SEED, 400.0, 10.0))
    assert not np.array_equal(a, b)
    gaps = np.diff(a)  # exponential in shape: the spread of the gaps is about their mean
    assert 0.8 < gaps.std() / gaps.mean() < 1.2


def test_picks_and_samples_are_deterministic():
    assert np.array_equal(generate.picks(SEED, 50, 7), generate.picks(SEED, 50, 7))
    s = generate.sample(SEED, 100, 10)
    assert len(set(s.tolist())) == 10 and np.array_equal(s, generate.sample(SEED, 100, 10))
    assert len(generate.sample(SEED, 3, 10)) == 3
