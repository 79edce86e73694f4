"""The flagship training golden that chip_smoke.py's phase `train` holds the
port to on the card: fdt's own PyramidTrainer (PyramidBox-ResNet50 at 640²,
float32, precision "highest", on the CPU) from net_weight/repo_mini.npz with
fdt's zero momentum, chip_smoke.TRAIN_STEPS steps at chip_smoke.TRAIN_LR on
chip_smoke.train_batch(TRAIN_SEED, TRAIN_GOLDEN_BATCH).  It stores the five
loss parts of every step, and for every parameter and batch_stats leaf the
sum and L2 norm of its change over the steps and a few of its elements
after them (chip_smoke.train_leaf_summary), with the sha256 of the batch.

Written by

    python tests/test_torch_train_golden.py --write-golden

(~4 min, ~8 GB on the CPU) and re-made by the slow test below, which also
holds the port's CPU float32 steps to it.
"""
import argparse
import pathlib
import sys

import numpy as np
import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402

WEIGHTS = REPO / "net_weight" / "repo_mini.npz"
PARTS = ("loss", "face_loc", "face_conf", "head_loc", "head_conf")


def make_golden() -> dict:
    """fdt's flagship train steps on the CPU → the golden's arrays."""
    import jax
    import jax.numpy as jnp

    from fdt.models.loader import load_variables
    from fdt.models.pyramidbox import PyramidBox
    from fdt.train.loops import PyramidTrainer, TrainState
    from fdt_torch.models.loader import flat_variables
    model = PyramidBox()
    variables = load_variables(model, str(WEIGHTS), chip_smoke.SIZE)
    trainer = PyramidTrainer(model, "repo", input_size=chip_smoke.SIZE, precision="highest")
    params = jax.tree.map(jnp.asarray, variables["params"])
    state = TrainState(step=jnp.zeros((), jnp.int32), params=params,
                       batch_stats=jax.tree.map(jnp.asarray, variables["batch_stats"]),
                       opt_state=trainer.tx.init(params))
    batch = chip_smoke.train_batch(chip_smoke.TRAIN_SEED, chip_smoke.TRAIN_GOLDEN_BATCH)
    losses = []
    for _ in range(chip_smoke.TRAIN_STEPS):
        state, m = trainer.train_step(state, *batch, chip_smoke.TRAIN_LR)
        losses.append([float(m[k]) for k in PARTS])
    after = flat_variables({"params": jax.device_get(state.params),
                            "batch_stats": jax.device_get(state.batch_stats)})
    summary = chip_smoke.train_leaf_summary(flat_variables(variables), after)
    return {"losses": np.array(losses), "parts": np.array(PARTS),
            "seed": np.int64(chip_smoke.TRAIN_SEED),
            "batch": np.int64(chip_smoke.TRAIN_GOLDEN_BATCH),
            "size": np.int64(chip_smoke.SIZE), "steps": np.int64(chip_smoke.TRAIN_STEPS),
            "lr": np.float64(chip_smoke.TRAIN_LR),
            "batch_sha256": np.str_(chip_smoke.batch_sha256(batch)), **summary}


def test_golden_file_is_consistent():
    """The committed golden: under 1 MB, made from the batch chip_smoke
    builds, of fdt's steps at chip_smoke's settings, every leaf of the
    flagship summarised, the loss moving far more than the check's
    tolerance."""
    path = chip_smoke.TRAIN_GOLDEN
    assert path.stat().st_size < 1_000_000
    g = np.load(path)
    assert (int(g["seed"]), int(g["batch"]), int(g["size"]), int(g["steps"]), float(g["lr"])) == (
        chip_smoke.TRAIN_SEED, chip_smoke.TRAIN_GOLDEN_BATCH, chip_smoke.SIZE,
        chip_smoke.TRAIN_STEPS, chip_smoke.TRAIN_LR)
    batch = chip_smoke.train_batch(int(g["seed"]), int(g["batch"]), int(g["size"]))
    assert chip_smoke.batch_sha256(batch) == str(g["batch_sha256"])
    assert tuple(g["parts"]) == PARTS
    losses = g["losses"]
    assert losses.shape == (chip_smoke.TRAIN_STEPS, 5) and np.isfinite(losses).all()
    np.testing.assert_allclose(losses[:, 0], losses[:, 1] + losses[:, 2]
                               + 0.5 * (losses[:, 3] + losses[:, 4]), rtol=1e-5)
    moved = abs(losses[-1, 0] - losses[0, 0]) / losses[0, 0]
    assert moved > 100 * chip_smoke.TRAIN_LOSS_RTOL[0]
    from fdt_torch.models import PyramidBox
    from fdt_torch.models.loader import flax_paths
    names = sorted("/".join(p) for p in flax_paths(PyramidBox()).values())
    assert list(g["names"]) == names
    assert g["sample_index"].shape == g["sample_value"].shape == (len(names),
                                                                 chip_smoke.TRAIN_SAMPLES)
    assert (g["change_norm"] > 0).mean() > 0.95


@pytest.mark.slow
def test_golden_matches_fdt_and_the_port_on_the_cpu():
    """Re-make the golden with fdt, then hold the port's CPU float32 steps
    to it by chip_smoke's own check."""
    import torch

    from fdt_torch.models import load_pyramidbox
    from fdt_torch.train.loops import PyramidTrainer
    g = dict(np.load(chip_smoke.TRAIN_GOLDEN))
    fresh = make_golden()
    np.testing.assert_array_equal(fresh["losses"], g["losses"])
    np.testing.assert_array_equal(fresh["change_norm"], g["change_norm"])
    torch.set_num_threads(4)
    trainer = PyramidTrainer(load_pyramidbox(str(WEIGHTS)).train(), "repo",
                             input_size=chip_smoke.SIZE, precision="highest", device="cpu")
    chip_smoke.check_train_golden(trainer, g)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Write the flagship training golden")
    ap.add_argument("--write-golden", action="store_true", required=True)
    ap.parse_args(argv)
    import jax
    jax.config.update("jax_platforms", "cpu")
    golden = make_golden()
    np.savez_compressed(chip_smoke.TRAIN_GOLDEN, **golden)
    print(f"wrote {chip_smoke.TRAIN_GOLDEN.relative_to(REPO)}: losses "
          f"{golden['losses'][:, 0].round(5).tolist()}, {len(golden['names'])} leaves")
    return 0


if __name__ == "__main__":
    sys.exit(main())
