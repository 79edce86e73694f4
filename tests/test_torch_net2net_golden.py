"""The net2net golden that chip_smoke.py's phase train_families holds the
port to on the card: for each mode, fdt's own Net2NetTrainer (teacher
PyramidBox-ResNet50 from net_weight/repo_mini.npz, student try1 from
chip_smoke.NET2NET_STUDENT, 640², float32, precision "highest", on the CPU)
with fdt's zero momentum, FAMILY_STEPS steps at the mode's NET2NET_TRAIN_LR on
chip_smoke.net2net_batch(NET2NET_TRAIN_SEED, NET2NET_TRAIN_GOLDEN_BATCH).
Per mode, under "<mode>/": the loss and its parts at every step, each
student leaf's change sum and norm and a few of its elements
(chip_smoke.train_leaf_summary), and the sha256 of the batch.

Written by

    python tests/test_torch_net2net_golden.py --write-golden

(~4 min on the CPU) and re-made by the slow test below, which also holds
the port's CPU steps to it by chip_smoke's own check.  The port's CPU
errors against it, by mode (intermedia / source / overall): the losses
1.4e-5 / 1.8e-5 / 2.4e-7 relative, the change norms 9.1e-4 / 6.6e-4 /
2.7e-5 of the largest leaf's, the batch_stats samples 1.4e-2 / 6.8e-3 /
3.8e-3 (their tolerance 5e-2: a sample near zero of a running mean).
"""
import argparse
import pathlib
import sys

import numpy as np
import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402

GOLDEN = chip_smoke.NET2NET_TRAIN_GOLDEN
TEACHER = REPO / "net_weight" / "repo_mini.npz"
N_PARTS = {"intermedia": 6, "source": 6, "overall": 4}


def make_golden(modes=chip_smoke.NET2NET_MODES) -> dict:
    """fdt's net2net steps on the CPU, each mode → the golden's arrays."""
    import jax
    import jax.numpy as jnp

    from fdt.models.loader import load_variables
    from fdt.models.pyramidbox_mobile import build_pyramidbox
    from fdt.train.loops import TrainState
    from fdt.train.net2net import Net2NetTrainer
    from fdt_torch.models.loader import flat_variables
    teacher, student = build_pyramidbox("repo"), build_pyramidbox("try1")
    teacher_vars = load_variables(teacher, str(TEACHER), chip_smoke.SIZE)
    student_vars = load_variables(student, str(chip_smoke.NET2NET_STUDENT), chip_smoke.SIZE)
    batch = chip_smoke.net2net_batch(chip_smoke.NET2NET_TRAIN_SEED,
                                     chip_smoke.NET2NET_TRAIN_GOLDEN_BATCH)
    out = {"seed": np.int64(chip_smoke.NET2NET_TRAIN_SEED),
           "batch": np.int64(chip_smoke.NET2NET_TRAIN_GOLDEN_BATCH),
           "steps": np.int64(chip_smoke.FAMILY_STEPS)}
    for mode in modes:
        trainer = Net2NetTrainer(student, teacher, mode, input_size=chip_smoke.SIZE,
                                 precision="highest")
        trainer.teacher_variables = jax.tree.map(jnp.asarray, teacher_vars)
        params = jax.tree.map(jnp.asarray, student_vars["params"])
        state = TrainState(step=jnp.zeros((), jnp.int32), params=params,
                           batch_stats=jax.tree.map(jnp.asarray, student_vars["batch_stats"]),
                           opt_state=trainer.tx.init(params))
        losses = []
        for _ in range(chip_smoke.FAMILY_STEPS):
            state, m = trainer.train_step(state, *batch, chip_smoke.NET2NET_TRAIN_LR[mode])
            losses.append([float(m["loss"])] + np.asarray(m["parts"], np.float64).tolist())
        after = flat_variables({"params": jax.device_get(state.params),
                                "batch_stats": jax.device_get(state.batch_stats)})
        summary = chip_smoke.train_leaf_summary(flat_variables(student_vars), after)
        out.update({f"{mode}/{k}": v for k, v in summary.items()})
        out[f"{mode}/losses"] = np.array(losses)
        out[f"{mode}/batch_sha256"] = np.str_(chip_smoke.batch_sha256(batch))
        out[f"{mode}/lr"] = np.float64(chip_smoke.NET2NET_TRAIN_LR[mode])
    return out


def port_trainer(mode: str):
    from fdt_torch.models import load_pyramidbox
    from fdt_torch.train.net2net import Net2NetTrainer
    return Net2NetTrainer(load_pyramidbox(str(chip_smoke.NET2NET_STUDENT), "try1"),
                          load_pyramidbox(str(TEACHER)), mode, input_size=chip_smoke.SIZE,
                          precision="highest", device="cpu")


def test_golden_file_is_consistent():
    """The committed golden: under 1 MB, of the batch chip_smoke builds, at
    chip_smoke's settings, each mode's loss the weighted sum of its parts,
    every leaf of try1 summarised, each mode moving the leaves its loss
    reaches, and each mode's loss moving more than the check's
    tolerance."""
    assert GOLDEN.stat().st_size < 1_000_000
    g = np.load(GOLDEN)
    assert (int(g["seed"]), int(g["batch"]), int(g["steps"])) == (
        chip_smoke.NET2NET_TRAIN_SEED, chip_smoke.NET2NET_TRAIN_GOLDEN_BATCH,
        chip_smoke.FAMILY_STEPS)
    batch = chip_smoke.net2net_batch(int(g["seed"]), int(g["batch"]))
    from fdt_torch.models import build_pyramidbox
    from fdt_torch.models.loader import flax_paths
    from fdt_torch.train.net2net import INTERMEDIA_WEIGHTS, OVERALL_WEIGHTS, SOURCE_WEIGHT
    names = sorted("/".join(p) for p in flax_paths(build_pyramidbox("try1")).values())
    weights = {"intermedia": INTERMEDIA_WEIGHTS, "source": (SOURCE_WEIGHT,) * 6,
               "overall": OVERALL_WEIGHTS}
    for mode in chip_smoke.NET2NET_MODES:
        assert chip_smoke.batch_sha256(batch) == str(g[f"{mode}/batch_sha256"])
        assert float(g[f"{mode}/lr"]) == chip_smoke.NET2NET_TRAIN_LR[mode]
        losses = g[f"{mode}/losses"]
        assert losses.shape == (chip_smoke.FAMILY_STEPS, 1 + N_PARTS[mode])
        assert np.isfinite(losses).all()
        np.testing.assert_allclose(losses[:, 0], losses[:, 1:] @ np.array(weights[mode]),
                                   rtol=1e-5)
        moved = abs(losses[-1, 0] - losses[0, 0]) / losses[0, 0]
        assert moved > 10 * chip_smoke.FAMILY_TOL["net2net"]["loss"][0], mode
        assert list(g[f"{mode}/names"]) == names
        # a mode trains the part of the student its loss reaches: the heads
        # only in overall (elsewhere weight decay alone, lr·1e-4 of a
        # weight, is below float32's resolution)
        changed = dict(zip(names, g[f"{mode}/change_norm"] > 0))
        heads = [n for n in names if n.startswith(("params/face_", "params/head_"))]
        assert all(changed[n] for n in heads) == (mode == "overall")
        assert any(changed[n] for n in heads) == (mode == "overall")
        backbone = [n for n in names if n.startswith("params/layer")]
        assert np.mean([changed[n] for n in backbone]) > 0.8  # overall: 0.87 at lr 1e-5


@pytest.mark.slow
def test_golden_matches_fdt_and_the_port_on_the_cpu():
    """Re-make the golden with fdt, then hold the port's CPU float32 steps
    to it by chip_smoke's own check, each mode."""
    import torch
    g = dict(np.load(GOLDEN))
    fresh = make_golden()
    for mode in chip_smoke.NET2NET_MODES:
        np.testing.assert_array_equal(fresh[f"{mode}/losses"], g[f"{mode}/losses"])
    torch.set_num_threads(4)
    for mode in chip_smoke.NET2NET_MODES:
        print(mode, chip_smoke.check_family_golden("net2net", mode, port_trainer(mode), g))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Write the net2net golden")
    ap.add_argument("--write-golden", action="store_true", required=True)
    ap.parse_args(argv)
    import jax
    jax.config.update("jax_platforms", "cpu")
    golden = make_golden()
    np.savez_compressed(GOLDEN, **golden)
    print(f"wrote {GOLDEN.relative_to(REPO)}: " + ", ".join(
        f"{m} {golden[f'{m}/losses'][:, 0].tolist()}" for m in chip_smoke.NET2NET_MODES))
    g = dict(np.load(GOLDEN))
    for mode in chip_smoke.NET2NET_MODES:
        print(mode, "port on the CPU:",
              chip_smoke.check_family_golden("net2net", mode, port_trainer(mode), g))
    return 0


if __name__ == "__main__":
    sys.exit(main())
