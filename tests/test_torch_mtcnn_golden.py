"""The MTCNN training golden that chip_smoke.py's phase train_families
holds the port to on the card: for each stage, fdt's own MTCNNStageTrainer
(float32, precision "highest", on the CPU) from
chip_smoke.seeded_variables(net, MTCNN_TRAIN_WEIGHTS_SEED) with a fresh
Adam state, FAMILY_STEPS steps at base_lr MTCNN_TRAIN_LR on
chip_smoke.mtcnn_train_batch(stage, MTCNN_TRAIN_SEED,
MTCNN_TRAIN_GOLDEN_BATCH) (12/24/48² patches, labels 1, 0, -1, -2 in
turns).  Per stage, under "<stage>/": the five metrics of every step, each
leaf's gradient norm before the first update, its change sum and norm and
a few of its elements (chip_smoke.train_leaf_summary), the sign of every
element's change (packed bits), and the sha256 of the batch.

Written by

    python tests/test_torch_mtcnn_golden.py --write-golden

(~20 s on the CPU) and re-made by the slow test below, which also holds
the port's CPU steps to it by chip_smoke's own check.  The port's CPU
errors against it: the losses 1.6e-5 relative at most, the gradient norms
9.3e-6 of their own, the change norms 3.0e-5 of their own, one element of
ONet's 224,404 changed with another sign.
"""
import argparse
import pathlib
import sys

import numpy as np
import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402

GOLDEN = chip_smoke.MTCNN_TRAIN_GOLDEN


def port_net(stage: str):
    from fdt_torch.models import ONet, PNet, RNet, from_jax_variables
    net = {"pnet": PNet, "rnet": RNet, "onet": ONet}[stage]()
    net.load_state_dict(from_jax_variables(
        chip_smoke.seeded_variables(net, chip_smoke.MTCNN_TRAIN_WEIGHTS_SEED),
        net.flatten_chw), strict=True)
    return net


def make_golden() -> dict:
    """fdt's MTCNN stage steps on the CPU → the golden's arrays."""
    import jax
    import jax.numpy as jnp

    from fdt.models import mtcnn as jax_mtcnn
    from fdt.train.mtcnn_train import MTCNNStageTrainer, MTCNNState
    from fdt_torch.models.loader import flat_variables
    from tests.test_torch_seeded import nest_like
    out = {"seed": np.int64(chip_smoke.MTCNN_TRAIN_SEED),
           "weights_seed": np.int64(chip_smoke.MTCNN_TRAIN_WEIGHTS_SEED),
           "batch": np.int64(chip_smoke.MTCNN_TRAIN_GOLDEN_BATCH),
           "steps": np.int64(chip_smoke.FAMILY_STEPS),
           "lr": np.float64(chip_smoke.MTCNN_TRAIN_LR)}
    for stage in chip_smoke.MTCNN_STAGES:
        jax_net = {"pnet": jax_mtcnn.PNet, "rnet": jax_mtcnn.RNet, "onet": jax_mtcnn.ONet}[stage]
        size = {"pnet": 12, "rnet": 24, "onet": 48}[stage]
        variables = nest_like(chip_smoke.seeded_variables(
            port_net(stage), chip_smoke.MTCNN_TRAIN_WEIGHTS_SEED), jax_net(), size)
        trainer = MTCNNStageTrainer(stage, chip_smoke.MTCNN_TRAIN_LR, precision="highest")
        params = jax.tree.map(jnp.asarray, variables["params"])
        state = MTCNNState(step=jnp.zeros((), jnp.int32), params=params,
                           opt_state=trainer.tx.init(params))
        batch = chip_smoke.mtcnn_train_batch(stage, chip_smoke.MTCNN_TRAIN_SEED,
                                             chip_smoke.MTCNN_TRAIN_GOLDEN_BATCH)
        grads = flat_variables({"params": jax.device_get(
            jax.grad(lambda p: trainer._loss(p, *batch)[0])(params))})
        losses = []
        for _ in range(chip_smoke.FAMILY_STEPS):
            state, m = trainer.train_step(state, *batch)
            losses.append([float(m[k]) for k in chip_smoke.FAMILY_METRICS["mtcnn"]])
        before = flat_variables({"params": variables["params"]})
        after = flat_variables({"params": jax.device_get(state.params)})
        summary = chip_smoke.train_leaf_summary(before, after)
        summary["grad_norm"] = np.array([np.sqrt((grads[n].astype(np.float64) ** 2).sum())
                                         for n in summary["names"]])
        summary.update(chip_smoke.pack_signs(chip_smoke.change_signs(before, after)))
        out.update({f"{stage}/{k}": v for k, v in summary.items()})
        out[f"{stage}/losses"] = np.array(losses)
        out[f"{stage}/batch_sha256"] = np.str_(chip_smoke.batch_sha256(batch))
    return out


def port_trainer(stage: str):
    from fdt_torch.train.mtcnn_train import MTCNNStageTrainer
    return MTCNNStageTrainer(stage, chip_smoke.MTCNN_TRAIN_LR, "highest", model=port_net(stage),
                             device="cpu")


def test_golden_file_is_consistent():
    """The committed golden: under 1 MB, of the batches chip_smoke builds, at
    chip_smoke's settings, each stage's loss its weighted parts, every leaf
    summarised with a gradient, each element's change sign recorded, and
    the loss moving far more than the check's tolerance."""
    from fdt_torch.models.loader import flax_paths
    from fdt_torch.train.mtcnn_train import STAGE_WEIGHTS
    assert GOLDEN.stat().st_size < 1_000_000
    g = np.load(GOLDEN)
    assert (int(g["seed"]), int(g["weights_seed"]), int(g["batch"]), int(g["steps"]),
            float(g["lr"])) == (chip_smoke.MTCNN_TRAIN_SEED, chip_smoke.MTCNN_TRAIN_WEIGHTS_SEED,
                                chip_smoke.MTCNN_TRAIN_GOLDEN_BATCH, chip_smoke.FAMILY_STEPS,
                                chip_smoke.MTCNN_TRAIN_LR)
    for stage in chip_smoke.MTCNN_STAGES:
        batch = chip_smoke.mtcnn_train_batch(stage, int(g["seed"]), int(g["batch"]))
        assert chip_smoke.batch_sha256(batch) == str(g[f"{stage}/batch_sha256"])
        losses = g[f"{stage}/losses"]
        assert losses.shape == (chip_smoke.FAMILY_STEPS, 5) and np.isfinite(losses).all()
        np.testing.assert_allclose(losses[:, 0], losses[:, 1:4] @ np.array(STAGE_WEIGHTS[stage]),
                                   rtol=1e-6)
        assert ((losses[:, 4] >= 0) & (losses[:, 4] <= 1)).all()
        moved = abs(losses[-1, 0] - losses[0, 0]) / losses[0, 0]
        assert moved > 100 * chip_smoke.FAMILY_TOL["mtcnn"]["loss"][-1], stage
        names = sorted("/".join(p) for p in flax_paths(port_net(stage)).values())
        assert list(g[f"{stage}/names"]) == names
        assert (g[f"{stage}/grad_norm"] > 0).all()
        n = sum(p.numel() for p in port_net(stage).parameters())
        signs = chip_smoke.unpack_signs(g, f"{stage}/")
        assert signs.size == n and (signs != 0).mean() > 0.99


@pytest.mark.slow
def test_golden_matches_fdt_and_the_port_on_the_cpu():
    """Re-make the golden with fdt, then hold the port's CPU float32 steps
    to it by chip_smoke's own check, each stage."""
    g = dict(np.load(GOLDEN))
    fresh = make_golden()
    for stage in chip_smoke.MTCNN_STAGES:
        np.testing.assert_array_equal(fresh[f"{stage}/losses"], g[f"{stage}/losses"])
        print(stage, chip_smoke.check_family_golden("mtcnn", stage, port_trainer(stage), g))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Write the MTCNN training golden")
    ap.add_argument("--write-golden", action="store_true", required=True)
    ap.parse_args(argv)
    import jax
    jax.config.update("jax_platforms", "cpu")
    golden = make_golden()
    np.savez_compressed(GOLDEN, **golden)
    print(f"wrote {GOLDEN.relative_to(REPO)}: " + ", ".join(
        f"{s} {golden[f'{s}/losses'][:, 0].tolist()}" for s in chip_smoke.MTCNN_STAGES))
    g = dict(np.load(GOLDEN))
    for stage in chip_smoke.MTCNN_STAGES:
        print(stage, "port on the CPU:",
              chip_smoke.check_family_golden("mtcnn", stage, port_trainer(stage), g))
    return 0


if __name__ == "__main__":
    sys.exit(main())
