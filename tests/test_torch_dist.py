"""fdt_torch.dist (procutil, mesh, multihost) and the distribution flags of
the CLIs, against fdt.dist where fdt has the function.

Every multi-process job runs under procutil.run_workers' shared deadline, on
a fresh free_port, with one torch thread a rank, and its test under a
watchdog budget (the --dp_devices CLI's ranks have no deadline of their
own: a rank wedged in a collective raises after multihost.TIMEOUT_S).  The training CLIs run
try3 at 128² on data/mini/gen_anno_file_mini_train, whose images (not in
the repo) are written here as seeded photo-like PNGs large enough for every
box.
"""
import json
import os
import pathlib
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402
from fdt.dist.multihost import process_batch_bounds as fdt_bounds  # noqa: E402
from fdt_torch.cli import serve, train_pyramid  # noqa: E402
from fdt_torch.dist import (batch_sharding, make_mesh, make_mesh_2d, multihost,  # noqa: E402
                            pad_to_mesh, replicated, shard_batch, train_batch_specs)
from fdt_torch.dist.procutil import (WorkerFailure, child_env, free_port,  # noqa: E402
                                     python_workers, run_workers)

torch.set_num_threads(1)

MINI_TRAIN = REPO / "data" / "mini" / "gen_anno_file_mini_train"
TRY3 = str(REPO / chip_smoke.VARIANT_WEIGHTS["try3"])
CPU = torch.device("cpu")
JOB_TIMEOUT_S = 240.0


def _alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
        return True
    except OSError:
        return False


# -- procutil (tests/test_procutil.py's cases) ---------------------------------

@pytest.mark.watchdog(300)
def test_failing_worker_fails_fast_and_kills_sibling(tmp_path):
    pid_file = tmp_path / "sleeper.pid"
    sleeper = ("import os, sys, time\n"
               f"open({str(pid_file)!r}, 'w').write(str(os.getpid()))\n"
               "print('x' * 100000)\n"   # >64KB: would stall a pipe design
               "time.sleep(300)\n")
    t0 = time.monotonic()
    with pytest.raises(WorkerFailure) as ei:
        python_workers([["-c", "import sys, time; time.sleep(1); print('boom', "
                         "file=sys.stderr); sys.exit(3)"],
                        ["-c", sleeper]], timeout=120.0)
    assert ei.value.index == 0 and ei.value.returncode == 3
    assert "boom" in ei.value.stderr
    assert time.monotonic() - t0 < 30
    assert not _alive(int(pid_file.read_text()))


@pytest.mark.watchdog(300)
def test_shared_deadline_not_per_worker():
    prog = "import time; time.sleep(20)"
    t0 = time.monotonic()
    with pytest.raises(subprocess.TimeoutExpired):
        python_workers([["-c", prog], ["-c", prog]], timeout=3.0)
    assert time.monotonic() - t0 < 10


@pytest.mark.watchdog(300)
def test_child_env_gives_a_worker_one_thread():
    env = child_env(base={"OMP_NUM_THREADS": "8", "KEEP": "1"})
    assert env["OMP_NUM_THREADS"] == env["MKL_NUM_THREADS"] == "1" and env["KEEP"] == "1"
    (_, out, _), = python_workers([["-c", "import torch; print(torch.get_num_threads())"]],
                                  timeout=120.0, env=child_env(2))
    assert out.strip() == "2"


def test_run_workers_returns_in_cmd_order_and_can_pass_output_through(capfd):
    results = run_workers([[sys.executable, "-c", "print('a')"],
                           [sys.executable, "-c", "print('b')"]], timeout=60.0)
    assert [r[1].strip() for r in results] == ["a", "b"]
    assert all(r[0] == 0 for r in results)
    assert run_workers([[sys.executable, "-c", "print('through')"]], timeout=60.0,
                       capture=False) == [(0, "", "")]
    assert "through" in capfd.readouterr().out


def test_free_port_is_bindable():
    import socket
    s = socket.socket()
    s.bind(("127.0.0.1", free_port()))
    s.close()


# -- mesh ----------------------------------------------------------------------

def test_make_mesh_takes_cards_only():
    """No card here: make_mesh(2) raises (no fall-back to the CPU, unlike
    fdt's _pick_devices); a CPU mesh is asked for by name."""
    with pytest.raises(ValueError, match="CUDA card"):
        make_mesh(2)
    with pytest.raises(ValueError, match="CUDA card"):
        make_mesh()
    with pytest.raises(ValueError, match="requested 3 devices"):
        make_mesh(3, devices=[CPU] * 2)
    mesh = make_mesh(devices=["cpu"] * 4)
    assert mesh.size == 4 and mesh.distinct == (CPU,) and mesh.axis_name == "data"
    assert (mesh.rank, mesh.world_size) == (0, 1)
    assert make_mesh(2, devices=[CPU] * 4).size == 2


MESH_2D_RANK = """
import json, sys, torch
from fdt_torch.dist import make_mesh_2d, multihost, train_batch_specs
rank, port = int(sys.argv[1]), sys.argv[2]
multihost.initialize(f"127.0.0.1:{port}", 4, rank, timeout_s=60)
try:
    mesh = make_mesh_2d(2, 2, devices=["cpu"] * 4)
    space = torch.distributed.get_process_group_ranks(multihost.space_group())
    data = torch.distributed.get_process_group_ranks(multihost.data_group())
    print(json.dumps({"shape": mesh.shape, "axis_names": mesh.axis_names,
                      "index": [mesh.data_index, mesh.space_index], "space": space,
                      "data": data, "data_main": multihost.is_data_main(),
                      "specs": train_batch_specs(mesh, 3)}))
finally:
    multihost.shutdown()
"""


@pytest.mark.parametrize("case", ["make_mesh_2d", "train_batch_specs"])
def test_the_data_x_space_mesh_is_the_next_slice(case):
    """The data x space mesh (fdt's tests/test_dist.py:46-50).  make_mesh_2d:
    it raises without a process group of n_data x n_space ranks and with
    fewer cards than ranks; on 4 gloo ranks, make_mesh_2d(2, 2) gives each
    rank the shape, axis names, its (data, space) = divmod(rank, 2), its
    space group (its data index's ranks) and data group (its space index's).
    train_batch_specs: fdt's layouts on the 2-D and the 1-D mesh."""
    import jax.sharding
    from fdt.dist import make_mesh as fdt_mesh, make_mesh_2d as fdt_mesh_2d
    from fdt.dist import train_batch_specs as fdt_specs
    from fdt_torch.dist import Mesh2D
    if case == "train_batch_specs":
        assert train_batch_specs(Mesh2D(4, 2, 5, [CPU] * 8), 2) == (
            ("data", "space"), ("data",), ("data",))
        assert train_batch_specs(make_mesh(devices=[CPU]), 2) == (("data",),) * 3
        for port_mesh, mesh in ((Mesh2D(4, 2, 0, [CPU] * 8), fdt_mesh_2d(4, 2)),
                                (make_mesh(devices=[CPU]), fdt_mesh(8))):
            want = fdt_specs(mesh, 3)
            assert all(isinstance(p, jax.sharding.PartitionSpec) for p in want)
            assert train_batch_specs(port_mesh, 3) == tuple(tuple(p) for p in want)
        mesh = Mesh2D(4, 2, 5, [CPU] * 8)
        assert (mesh.shape, mesh.axis_names, mesh.data_index, mesh.space_index) == (
            {"data": 4, "space": 2}, ("data", "space"), 2, 1)
        return
    with pytest.raises(ValueError, match="needs a process group of 4 ranks"):
        make_mesh_2d(2, 2, devices=[CPU] * 4)
    with pytest.raises(ValueError, match="takes 4 CUDA cards; this machine has 0"):
        make_mesh_2d(2, 2)
    port = str(free_port())
    results = python_workers([["-c", MESH_2D_RANK, str(r), port] for r in range(4)],
                             JOB_TIMEOUT_S, env=child_env(1), cwd=str(REPO))
    for r, (_, out, _) in enumerate(results):
        info = json.loads(out.strip().splitlines()[-1])
        d, s = divmod(r, 2)
        assert info["shape"] == {"data": 2, "space": 2}
        assert tuple(info["axis_names"]) == ("data", "space")
        assert info["index"] == [d, s]
        assert info["space"] == [2 * d, 2 * d + 1] and info["data"] == [s, 2 + s]
        assert info["data_main"] == (d == 0)
        assert info["specs"] == [["data", "space"], ["data"], ["data"], ["data"]]


def test_batch_sharding_pad_and_shard():
    mesh = make_mesh(devices=[CPU] * 2)
    assert batch_sharding(mesh, 6) == [slice(0, 3), slice(3, 6)]
    with pytest.raises(ValueError, match="does not divide"):
        batch_sharding(mesh, 5)
    x = torch.arange(3)[:, None].repeat(1, 2)
    np.testing.assert_array_equal(pad_to_mesh(mesh, x)[:, 0].numpy(), [0, 1, 2, 2])
    even = x[:2]
    assert pad_to_mesh(mesh, even) is even
    a, b = shard_batch(mesh, (torch.arange(4), torch.arange(4) * 10))
    assert a[0].tolist() == [0, 1] and b[1].tolist() == [20, 30]
    assert [t.tolist() for t in shard_batch(mesh, torch.arange(4))] == [[0, 1], [2, 3]]


def test_replicated_keeps_the_module_where_it_lies():
    m = torch.nn.Linear(2, 2)
    assert replicated(make_mesh(devices=[CPU] * 2), m) == {CPU: m}


def test_process_batch_bounds_equal_fdts():
    for g, n in ((8, 2), (12, 3), (4, 4), (7, 1)):
        for i in range(n):
            assert multihost.process_batch_bounds(g, i, n) == fdt_bounds(g, i, n)
    with pytest.raises(ValueError, match="not divisible"):
        multihost.process_batch_bounds(7, 0, 2)
    assert multihost.process_batch_bounds(6) == (0, 6)  # no group: one process
    assert multihost.is_main() and multihost.group() is None
    multihost.barrier()  # nothing to wait for


@pytest.mark.watchdog(300)
def test_a_failed_rendezvous_raises():
    """Rank 0 of 2 whose peer never comes: initialize raises after its
    timeout; nothing carries on at world size 1."""
    prog = ("from fdt_torch.dist import multihost\n"
            f"multihost.initialize('127.0.0.1:{free_port()}', 2, 0, timeout_s=3)\n"
            "print('carried on')\n")
    with pytest.raises(WorkerFailure) as ei:
        python_workers([["-c", prog]], timeout=120.0, env=child_env(1), cwd=str(REPO))
    assert "carried on" not in ei.value.stdout
    assert "Error" in ei.value.stderr


# -- the CLIs --------------------------------------------------------------------

@pytest.fixture(scope="module")
def mini_train(tmp_path_factory) -> str:
    """data/mini's train anno with each image a seeded photo-like PNG large
    enough for its boxes."""
    from PIL import Image
    tmp = tmp_path_factory.mktemp("mini_train")
    lines = []
    for k, line in enumerate(MINI_TRAIN.read_text().splitlines()):
        cells = line.split()
        n = int(cells[1])
        b = np.array(cells[2:2 + 4 * n], float).reshape(n, 4)
        h, w = int((b[:, 1] + b[:, 3]).max()) + 8, int((b[:, 0] + b[:, 2]).max()) + 8
        path = tmp / (pathlib.Path(cells[0]).stem + ".png")
        Image.fromarray(chip_smoke.photo_like(h, w, k)[:, :, ::-1]).save(path)
        lines.append(" ".join([str(path)] + cells[1:]))
    anno = tmp / MINI_TRAIN.name
    anno.write_text("\n".join(lines) + "\n")
    return str(anno)


def _cli_args(anno: str, folder, *extra) -> list[str]:
    return ["--net", "try3", "--input_size", "128", "--batch_size", "2", "--iter", "2",
            "--save_point", "2", "--lr", "1e-4", "--annoPath", anno,
            "--save_folder", str(folder) + "/", "--device", "cpu", *extra]


@pytest.mark.watchdog(600)
def test_two_process_training_cli(tmp_path, mini_train):
    """--num_processes 2 over gloo (tests/test_multihost.py's CLI case):
    record shards, one checkpoint, rank 0's loss sidecar."""
    args = _cli_args(mini_train, tmp_path, "--max_gt", "8", "--num_processes", "2",
                     "--coordinator", f"127.0.0.1:{free_port()}")
    results = python_workers([["-m", "fdt_torch.cli.train_pyramid", *args,
                               "--process_id", str(i)] for i in range(2)],
                             JOB_TIMEOUT_S, env=child_env(1), cwd=str(REPO))
    assert os.path.isdir(tmp_path / "try3_pyramid_2")
    assert sorted(p.name for p in tmp_path.iterdir()) == ["try3_pyramid_2",
                                                          "try3_pyramid_loss_2.npy"]
    loss = np.load(tmp_path / "try3_pyramid_loss_2.npy")
    assert loss.shape[0] == 5 and np.isfinite(loss[0, :2]).all() and loss[0, :2].min() > 0
    lines = [ln for ln in results[0][1].splitlines() if ln.startswith("[train] ")]
    info = json.loads(lines[-1][len("[train] "):])
    assert (info["ranks"], info["global_batch"], info["step"]) == (2, 4, 2)
    assert "[train] " not in results[1][1]  # rank 0 reports


@pytest.mark.watchdog(900)
def test_dp_devices_cli_is_the_one_device_run_split(tmp_path, mini_train, capfd):
    """--dp_devices 2 --device cpu: two local ranks over gloo, each keeping
    its row of every batch of 2, take fdt's batches: the loss history is the
    one-device run's within the tolerances the port's steps are held to
    against fdt's golden (chip_smoke.TRAIN_LOSS_RTOL).  The two compute
    BatchNorm's variance by different formulas (torch's fused kernel; flax's
    E[x²] − E[x]² summed over the ranks) on try3's 2×2 maps of xavier
    weights: measured 1.2e-5 relative at step 1."""
    one, two = tmp_path / "one", tmp_path / "two"
    assert train_pyramid.main(_cli_args(mini_train, one)) == 0
    assert train_pyramid.main(_cli_args(mini_train, two, "--dp_devices", "2")) == 0
    lines = [ln for ln in capfd.readouterr().out.splitlines() if ln.startswith("[train] ")]
    assert len(lines) == 2  # one from the one-device run, one from rank 0
    info = json.loads(lines[-1][len("[train] "):])
    assert (info["ranks"], info["global_batch"], info["step"]) == (2, 2, 2)
    a, b = (np.load(d / "try3_pyramid_loss_2.npy")[:, :2] for d in (one, two))
    for step, rtol in enumerate(chip_smoke.TRAIN_LOSS_RTOL[:2]):
        np.testing.assert_allclose(b[:, step], a[:, step], rtol=rtol)


def test_serve_dp_devices_builds_a_meshed_detector():
    args = serve.build_parser().parse_args(["--net", "try3", "--weights", TRY3,
                                            "--dp_devices", "2", "--device", "cpu",
                                            "--max_batch", "4"])
    service = serve.build_service(args)
    try:
        det = service.detector
        assert det.mesh.size == 2 and det.device == CPU
        frame = chip_smoke.photo_like(96, 128, 0)
        rows = service.detect(frame)
        assert rows.ndim == 2 and rows.shape[1] == 5
    finally:
        service.close()
