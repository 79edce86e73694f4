"""Pytest hooks for the whole checkout.

portbench/tests/conftest.py cuts each traffic mix to a CPU size by its kind
(`TINY`); the `batch_landmarks` kind runs `batch`'s loop, so it takes
batch's size.  The benchmark's own files are left as they are here."""
import sys


def pytest_collection_finish(session):
    bench_tests = sys.modules.get("portbench.tests.conftest")
    if bench_tests is not None:
        bench_tests.TINY.setdefault("batch_landmarks", bench_tests.TINY["batch"])
