"""The FaceBoxes training golden that chip_smoke.py's phase train_families
holds the port to on the card: fdt's own FaceBoxTrainer (FaceBoxes at
1024², float32, precision "highest", on the CPU) from
chip_smoke.seeded_variables(FaceBox(), FACEBOX_WEIGHTS_SEED) with fdt's zero
momentum, FAMILY_STEPS steps at FACEBOX_TRAIN_LR on
chip_smoke.facebox_train_batch(FACEBOX_TRAIN_SEED,
FACEBOX_TRAIN_GOLDEN_BATCH).  It stores the loss parts of every step, each
leaf's change sum and norm and a few of its elements after the steps
(chip_smoke.train_leaf_summary), and the sha256 of the batch.

Written by

    python tests/test_torch_facebox_golden.py --write-golden

(~30 s on the CPU) and re-made by the slow test below, which also holds
the port's CPU steps to it by chip_smoke's own check.  The port's CPU
errors against it: the losses 1.6e-6 / 2.3e-6 / 2.0e-6 relative by step,
the change norms 7.0e-5 of the largest leaf's (3.8e-2 of a leaf's own at
most), the batch_stats samples 3.1e-4.
"""
import argparse
import pathlib
import sys

import numpy as np
import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402

GOLDEN = chip_smoke.FACEBOX_TRAIN_GOLDEN


def make_golden() -> dict:
    """fdt's FaceBoxes train steps on the CPU → the golden's arrays."""
    import jax
    import jax.numpy as jnp

    from fdt.models.facebox import FaceBox as JaxFaceBox
    from fdt.train.facebox_train import FaceBoxTrainer
    from fdt.train.loops import TrainState
    from fdt_torch.models import FaceBox
    from fdt_torch.models.loader import flat_variables
    from tests.test_torch_seeded import nest_like
    variables = nest_like(chip_smoke.seeded_variables(FaceBox(), chip_smoke.FACEBOX_WEIGHTS_SEED),
                          JaxFaceBox(), 128)
    trainer = FaceBoxTrainer(precision="highest")
    params = jax.tree.map(jnp.asarray, variables["params"])
    state = TrainState(step=jnp.zeros((), jnp.int32), params=params,
                       batch_stats=jax.tree.map(jnp.asarray, variables["batch_stats"]),
                       opt_state=trainer.tx.init(params))
    batch = chip_smoke.facebox_train_batch(chip_smoke.FACEBOX_TRAIN_SEED,
                                           chip_smoke.FACEBOX_TRAIN_GOLDEN_BATCH)
    losses = []
    for _ in range(chip_smoke.FAMILY_STEPS):
        state, m = trainer.train_step(state, *batch, chip_smoke.FACEBOX_TRAIN_LR)
        losses.append([float(m[k]) for k in chip_smoke.FAMILY_METRICS["facebox"]])
    after = flat_variables({"params": jax.device_get(state.params),
                            "batch_stats": jax.device_get(state.batch_stats)})
    summary = chip_smoke.train_leaf_summary(flat_variables(variables), after)
    return {"losses": np.array(losses), "parts": np.array(chip_smoke.FAMILY_METRICS["facebox"]),
            "seed": np.int64(chip_smoke.FACEBOX_TRAIN_SEED),
            "batch": np.int64(chip_smoke.FACEBOX_TRAIN_GOLDEN_BATCH),
            "steps": np.int64(chip_smoke.FAMILY_STEPS),
            "lr": np.float64(chip_smoke.FACEBOX_TRAIN_LR),
            "batch_sha256": np.str_(chip_smoke.batch_sha256(batch)), **summary}


def port_trainer():
    from fdt_torch.models import FaceBox, from_jax_variables
    from fdt_torch.train.facebox_train import FaceBoxTrainer
    model = FaceBox()
    model.load_state_dict(from_jax_variables(chip_smoke.seeded_variables(
        model, chip_smoke.FACEBOX_WEIGHTS_SEED)), strict=True)
    return FaceBoxTrainer(model, precision="highest", device="cpu")


def test_golden_file_is_consistent():
    """The committed golden: under 1 MB, of the batch chip_smoke builds, at
    chip_smoke's settings, every leaf of FaceBoxes summarised, the loss
    moving far more than the check's first-step tolerance."""
    assert GOLDEN.stat().st_size < 1_000_000
    g = np.load(GOLDEN)
    assert (int(g["seed"]), int(g["batch"]), int(g["steps"]), float(g["lr"])) == (
        chip_smoke.FACEBOX_TRAIN_SEED, chip_smoke.FACEBOX_TRAIN_GOLDEN_BATCH,
        chip_smoke.FAMILY_STEPS, chip_smoke.FACEBOX_TRAIN_LR)
    batch = chip_smoke.facebox_train_batch(int(g["seed"]), int(g["batch"]))
    assert chip_smoke.batch_sha256(batch) == str(g["batch_sha256"])
    losses = g["losses"]
    assert losses.shape == (chip_smoke.FAMILY_STEPS, 3) and np.isfinite(losses).all()
    np.testing.assert_allclose(losses[:, 0], losses[:, 1] + losses[:, 2], rtol=1e-6)
    moved = abs(losses[-1, 0] - losses[0, 0]) / losses[0, 0]
    assert moved > 100 * chip_smoke.FAMILY_TOL["facebox"]["loss"][-1]
    from fdt_torch.models import FaceBox
    from fdt_torch.models.loader import flax_paths
    names = sorted("/".join(p) for p in flax_paths(FaceBox()).values())
    assert list(g["names"]) == names
    assert (g["change_norm"] > 0).mean() > 0.95


@pytest.mark.slow
def test_golden_matches_fdt_and_the_port_on_the_cpu():
    """Re-make the golden with fdt, then hold the port's CPU float32 steps
    to it by chip_smoke's own check."""
    import torch
    g = dict(np.load(GOLDEN))
    fresh = make_golden()
    np.testing.assert_array_equal(fresh["losses"], g["losses"])
    np.testing.assert_array_equal(fresh["change_norm"], g["change_norm"])
    torch.set_num_threads(4)
    print(chip_smoke.check_family_golden("facebox", "", port_trainer(), g))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Write the FaceBoxes training golden")
    ap.add_argument("--write-golden", action="store_true", required=True)
    ap.parse_args(argv)
    import jax
    jax.config.update("jax_platforms", "cpu")
    golden = make_golden()
    np.savez_compressed(GOLDEN, **golden)
    print(f"wrote {GOLDEN.relative_to(REPO)}: losses {golden['losses'][:, 0].tolist()}, "
          f"{len(golden['names'])} leaves")
    g = dict(np.load(GOLDEN))
    print("port on the CPU:", chip_smoke.check_family_golden("facebox", "", port_trainer(), g))
    return 0


if __name__ == "__main__":
    sys.exit(main())
