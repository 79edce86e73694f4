"""train_chained's chunk processes on the CPU: two chunks of 2 iterations of
try3 at 128², each a `python -m fdt_torch.cli.train_pyramid` child process,
write try3_pyramid_2 and try3_pyramid_4, and the final checkpoint is bit-equal
to one in-process run that saves at iteration 2 and resumes from there (both
from the repo's try3 npz).  Each process rebuilds its dataset and shuffle
stream, so the equality is with a run that restores at the same boundary,
not with one that never restarts.  Every process computes on one thread
(OMP_NUM_THREADS=1 in the children, torch.set_num_threads(1) in this one,
set inside the test: a worker of the parallel run holds whatever thread
count the last test module it imported set), so the float32 sums run in one
order and the comparison is exact.
"""
import pathlib
import sys

import numpy as np
import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

from fdt_torch.cli import train_chained, train_pyramid  # noqa: E402
from fdt_torch.train.checkpoint import OPT_STATE, VARIABLES  # noqa: E402
from tests.test_torch_train_driver import write_dataset  # noqa: E402

torch.set_num_threads(1)

TRY3 = str(REPO / "net_weight" / "try3_mini.npz")


@pytest.fixture
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_two_chunk_processes_equal_one_process_that_restores(tmp_path, monkeypatch, capsys,
                                                            one_thread):
    monkeypatch.chdir(REPO)  # the children find fdt_torch from the repo's root
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    anno = write_dataset(tmp_path, 2)
    common = ["--input_size", "128", "--batch_size", "2", "--max_gt", "4", "--device", "cpu",
              "--annoPath", str(anno)]
    chained, single = tmp_path / "chained", tmp_path / "single"
    assert train_chained.main(["--net", "try3", "--chunk", "2", "--iter", "4",
                               "--save_folder", str(chained), "--resume", TRY3,
                               "--stall-retries", "0"] + common) == 0
    out = capsys.readouterr().out
    assert out.count("# chunk ") == 2 and out.rstrip().endswith(
        f"done: {chained / 'try3_pyramid_4'}")
    for argv in (["--iter", "2", "--resume", TRY3],
                 ["--iter", "4", "--start_iter", "2", "--resume",
                  str(single / "try3_pyramid_2")]):
        train_pyramid.main(["--net", "try3", "--save_point", "2", "--save_folder", str(single)]
                           + common + argv)
    assert (chained / "try3_pyramid_2" / VARIABLES).exists()
    for name in (VARIABLES, OPT_STATE):
        with np.load(chained / "try3_pyramid_4" / name) as got, \
                np.load(single / "try3_pyramid_4" / name) as want:
            assert sorted(got.files) == sorted(want.files)
            for k in want.files:
                np.testing.assert_array_equal(got[k], want[k], err_msg=f"{name}: {k}")
    with np.load(chained / "try3_pyramid_4" / OPT_STATE) as z:
        assert int(z["step"]) == 4
