"""fdt_torch's MTCNN stage training (the masked losses, Adam, the stage
trainer, train_stage, checkpoints, the train_mtcnn CLI and the whole
P → R → O workflow) against fdt's (fdt/train/mtcnn_train.py).

The steps run each stage at batch 64 (12/24/48² patches with labels 1, 0,
-1, -2 in turns) from chip_smoke.seeded_variables on both sides, float32
precision "highest", Adam at lr 1e-3 for 3 steps.  Adam's first steps
move every element by about ±lr whatever the size of its gradient, so an
element whose gradient is within float noise of zero could move the other
way; the steps are held where that cannot hide a fault:
  * the losses: the five metrics within 1e-5 relative at step 1 (measured
    3.1e-7) and 2e-4 at steps 2-3 (measured 1.6e-5);
  * each leaf's gradient norm before the first update within 1e-4
    (measured 9.3e-6);
  * each leaf's change norm within 1e-3 relative (measured 3.0e-5);
  * at most 1e-3 of the elements change with another sign (measured
    4.5e-6: one of ONet's 224,404).
The losses on their own are held to 1e-6 with every mask empty in turn.
"""
import io
import pathlib
import sys
from contextlib import redirect_stdout

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402
from fdt.models import mtcnn as jax_mtcnn  # noqa: E402
from fdt.models.loader import load_variables  # noqa: E402
from fdt.train import mtcnn_train as jax_train  # noqa: E402
from fdt_torch.models import ONet, PNet, RNet, from_jax_variables  # noqa: E402
from fdt_torch.models.loader import flat_variables, to_jax_variables  # noqa: E402
from fdt_torch.train import mtcnn_train  # noqa: E402
from fdt_torch.train.checkpoint import (load_model_weights, restore_checkpoint,  # noqa: E402
                                        save_checkpoint)
from fdt_torch.train.mtcnn_train import MTCNNStageTrainer, lecun_init  # noqa: E402
from tests.test_torch_seeded import nest_like  # noqa: E402

torch.set_num_threads(1)

NETS = {"pnet": (PNet, jax_mtcnn.PNet, 12), "rnet": (RNet, jax_mtcnn.RNet, 24),
        "onet": (ONet, jax_mtcnn.ONet, 48)}
BATCH, STEPS, LR, WEIGHTS_SEED = 64, 3, 1e-3, 2
LOSS_RTOL = (1e-5, 2e-4, 2e-4)
GRAD_RTOL, NORM_RTOL, SIGN_SHARE = 1e-4, 1e-3, 1e-3


def loss_case(seed: int, labels=None, n: int = 32):
    rng = np.random.RandomState(seed)
    label = (rng.choice([1, 0, -1, -2], size=n) if labels is None
             else np.resize(np.array(labels), n)).astype(np.float32)
    prob = rng.rand(n, 1).astype(np.float32) * 0.98 + 0.01
    prob[:3] = [[0.0], [1.0], [0.6]]  # the clip's ends and the threshold itself
    return (label, prob, rng.randn(n, 4).astype(np.float32), rng.randn(n, 4).astype(np.float32),
            rng.randn(n, 10).astype(np.float32), rng.randn(n, 10).astype(np.float32))


LOSS_CASES = {"mixed-0": (0, None), "mixed-1": (1, None), "mixed-2": (2, None),
              "no-cls-label": (3, [-1, -2]), "no-box-label": (4, [0]),
              "no-landmark-label": (5, [1, 0, -1]), "landmarks-only": (6, [-2])}


@pytest.mark.parametrize("case", list(LOSS_CASES))
def test_losses_and_accuracy_match_fdt(case):
    """cls, box, landmark and accuracy against fdt's, each mask empty in
    turn (a masked mean over max(Σ mask, 1) is 0 then)."""
    label, prob, bbox, pred_box, lm, pred_lm = loss_case(*LOSS_CASES[case])
    t, j = torch.from_numpy, jnp.asarray
    pairs = [(mtcnn_train.cls_loss(t(label), t(prob)), jax_train.cls_loss(j(label), j(prob))),
             (mtcnn_train.box_loss(t(label), t(bbox), t(pred_box)),
              jax_train.box_loss(j(label), j(bbox), j(pred_box))),
             (mtcnn_train.landmark_loss(t(label), t(lm), t(pred_lm)),
              jax_train.landmark_loss(j(label), j(lm), j(pred_lm))),
             (mtcnn_train.compute_accuracy(t(prob), t(label)),
              jax_train.compute_accuracy(j(prob), j(label)))]
    for got, want in pairs:
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6, atol=1e-7)
    if case == "no-cls-label":
        assert float(pairs[0][0]) == 0 and float(pairs[3][0]) == 0
    if case == "no-box-label":
        assert float(pairs[1][0]) == 0
    if case in ("no-landmark-label", "no-box-label"):
        assert float(pairs[2][0]) == 0


def test_stage_constants_match_fdt():
    assert mtcnn_train.STAGE_WEIGHTS == jax_train.STAGE_WEIGHTS
    assert mtcnn_train.STAGE_SIZES == jax_train.STAGE_SIZES


def test_adam_is_optax_adam():
    """torch.optim.Adam(betas (0.9, 0.999), eps 1e-8) follows optax.adam's
    updates for 6 steps of seeded gradients (magnitudes 1e-9 to 10), each
    step from the same parameters, within one float32 ulp of each parameter
    (2.5e-7 relative) or 1e-7 (1e-5 of a step) near zero; the moment
    buffers carry across the steps."""
    rng = np.random.RandomState(0)
    p0 = rng.randn(1000).astype(np.float32)
    grads = [rng.randn(1000).astype(np.float32) * 10.0 ** rng.randint(-9, 2) for _ in range(6)]
    tx = optax.adam(1e-2)
    params = jnp.asarray(p0)
    state = tx.init(params)
    p = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    opt = torch.optim.Adam([p], lr=1e-2, betas=(0.9, 0.999), eps=1e-8)
    for g in grads:
        with torch.no_grad():  # from the same parameters each step: no drift of roundings
            p.copy_(torch.from_numpy(np.array(params)))
        updates, state = tx.update(jnp.asarray(g), state, params)
        params = optax.apply_updates(params, updates)
        p.grad = torch.from_numpy(g)
        opt.step()
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(params), rtol=2.5e-7,
                                   atol=1e-7)


def test_lecun_init_is_flaxs_law_and_deterministic():
    """Kernels ~ truncated normal of variance 1/fan_in (within ±2σ of the
    untruncated law), biases 0, slopes 0.01; the same seed gives the same
    weights, another seed others."""
    a, b, c = lecun_init(ONet(), 0), lecun_init(ONet(), 0), lecun_init(ONet(), 1)
    with torch.no_grad():
        for (name, p), q, r in zip(a.named_parameters(), b.parameters(), c.parameters()):
            torch.testing.assert_close(p, q, rtol=0, atol=0)
            if name.endswith("bias"):
                assert not p.any()
            elif p.numel() == 1:
                assert float(p) == pytest.approx(0.01)
            else:
                fan_in = p[0].numel()
                if p.numel() > 500:  # enough draws for the standard deviation
                    assert abs(float(p.std()) * np.sqrt(fan_in) - 1) < 0.2
                assert float(p.abs().max()) <= 2 / 0.87962566103423978 / np.sqrt(fan_in) + 1e-6
                assert not torch.equal(p, r)


def port_trainer(stage: str, **kw) -> MTCNNStageTrainer:
    net = NETS[stage][0]()
    net.load_state_dict(from_jax_variables(chip_smoke.seeded_variables(net, WEIGHTS_SEED),
                                           net.flatten_chw), strict=True)
    return MTCNNStageTrainer(stage, LR, "highest", model=net, device="cpu", **kw)


def fdt_variables(stage: str) -> dict:
    net, jax_net, size = NETS[stage]
    return nest_like(chip_smoke.seeded_variables(net(), WEIGHTS_SEED), jax_net(), size)


@pytest.mark.parametrize("stage", ["pnet", "rnet", "onet"])
def test_stage_steps_match_fdt(stage):
    """3 Adam steps of each stage against fdt's MTCNNStageTrainer."""
    trainer = jax_train.MTCNNStageTrainer(stage, LR, precision="highest")
    variables = fdt_variables(stage)
    params = jax.tree.map(jnp.asarray, variables["params"])
    state = jax_train.MTCNNState(step=jnp.zeros((), jnp.int32), params=params,
                                 opt_state=trainer.tx.init(params))
    batch = chip_smoke.mtcnn_train_batch(stage, 0, BATCH)
    grads = flat_variables({"params": jax.device_get(
        jax.grad(lambda p: trainer._loss(p, *batch)[0])(params))})
    want = []
    for _ in range(STEPS):
        state, m = trainer.train_step(state, *batch)
        want.append([float(m[k]) for k in chip_smoke.FAMILY_METRICS["mtcnn"]])
    after = flat_variables({"params": jax.device_get(state.params)})

    port = port_trainer(stage)
    before = flat_variables(to_jax_variables(port.model))
    assert set(before) == set(after)
    got_grads = chip_smoke.mtcnn_grad_norms(port, batch)
    for k, g in grads.items():
        norm = np.sqrt((g.astype(np.float64) ** 2).sum())
        assert abs(got_grads[k] - norm) <= GRAD_RTOL * norm, k
    for step in range(STEPS):
        m = port.train_step(*batch)
        got = [float(m[k]) for k in chip_smoke.FAMILY_METRICS["mtcnn"]]
        np.testing.assert_allclose(got, want[step], rtol=LOSS_RTOL[step],
                                   err_msg=f"step {step + 1}")
    ours = flat_variables(to_jax_variables(port.model))
    for k in after:
        w, o = np.linalg.norm(after[k] - before[k]), np.linalg.norm(ours[k] - before[k])
        assert abs(o - w) <= NORM_RTOL * w, k
    signs = chip_smoke.change_signs(before, ours), chip_smoke.change_signs(before, after)
    flipped = np.mean(signs[0] != signs[1])
    assert flipped <= SIGN_SHARE
    assert port.step == STEPS


def test_unknown_stage_and_no_card(monkeypatch):
    with pytest.raises(ValueError, match="unknown MTCNN stage"):
        MTCNNStageTrainer("qnet", device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        MTCNNStageTrainer("pnet")


def test_checkpoints_cross_load_with_fdt(tmp_path):
    """A checkpoint of each stage loads into fdt (load_variables) bit-equal
    to the port's parameters, with fdt's tree structure, and fdt's
    MTCNNDetector's nets on those three checkpoints answer as the port's;
    fdt's own npz loads into the port bit-equal; a restored
    trainer's Adam state (mu, nu, count) steps as the saved one."""
    from fdt.infer.mtcnn import MTCNNDetector as JaxDetector
    from fdt.models.loader import init_template, save_variables_npz as jax_save_npz
    from fdt_torch.infer.mtcnn import MTCNNDetector
    trainers, fdt_vars = {}, {}
    for stage, (_, jax_net, size) in NETS.items():
        trainer = port_trainer(stage)
        trainer.train_step(*chip_smoke.mtcnn_train_batch(stage, 0, 8))
        path = save_checkpoint(trainer, str(tmp_path), f"{stage}_epoch", 1)
        variables = load_variables(jax_net(), f"{path}/variables.npz", size)
        template = init_template(jax_net(), size)
        assert (jax.tree_util.tree_structure(variables["params"])
                == jax.tree_util.tree_structure(template["params"]))
        assert variables["batch_stats"] == {}
        ours = flat_variables(to_jax_variables(trainer.model))
        assert set(ours) == set(flat_variables({"params": variables["params"]}))
        for k, v in flat_variables({"params": variables["params"]}).items():
            np.testing.assert_array_equal(v, ours[k], err_msg=k)
        trainers[stage], fdt_vars[stage] = trainer, {"params": variables["params"]}
    theirs = JaxDetector(fdt_vars["pnet"], fdt_vars["rnet"], fdt_vars["onet"])
    ours = MTCNNDetector(*(trainers[s].model for s in NETS), device="cpu")
    rng = np.random.RandomState(0)
    for stage, size in (("pnet", 30), ("rnet", 24), ("onet", 48)):
        x = rng.rand(4, size, size, 3).astype(np.float32)
        want = getattr(theirs, f"_{stage}_fwd")(theirs.vars[stage], jnp.asarray(x))
        with torch.no_grad():
            got = getattr(ours, stage)(torch.from_numpy(x).permute(0, 3, 1, 2))
        for a, b in zip(got, want):
            b = np.asarray(b)
            a = a.numpy().transpose(0, 2, 3, 1) if a.dim() == 4 else a.numpy()
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-5 * max(np.abs(b).max(), 1))
    # fdt → port
    for stage, (net, _, _) in NETS.items():
        jax_save_npz(fdt_variables(stage), str(tmp_path / f"{stage}.npz"), dtype=np.float32)
        model = load_model_weights(str(tmp_path / f"{stage}.npz"), net())
        got = flat_variables(to_jax_variables(model))
        for k, v in flat_variables({"params": fdt_variables(stage)["params"]}).items():
            np.testing.assert_array_equal(got[k], v, err_msg=k)
    # Adam's state round trip
    trainer = trainers["onet"]
    path = save_checkpoint(trainer, str(tmp_path), "onet_epoch", 2)
    with np.load(f"{path}/opt_state.npz") as z:
        assert int(z["count"]) == 1 and int(z["step"]) == 1
        assert {k.split("/")[0] for k in z.files} == {"mu", "nu", "count", "step"}
    resumed = restore_checkpoint(path, port_trainer("onet"))
    batch = chip_smoke.mtcnn_train_batch("onet", 1, 8)
    a, b = trainer.train_step(*batch), resumed.train_step(*batch)
    for k in a:
        assert float(a[k]) == float(b[k]), k
    for (k, p), q in zip(trainer.model.named_parameters(), resumed.model.parameters()):
        torch.testing.assert_close(p, q, rtol=0, atol=0, msg=k)


def test_train_stage_writes_a_checkpoint_every_epoch(tmp_path):
    """train_stage over written patches: two epochs, shuffled batches, the
    checkpoints pnet_epoch_1 and pnet_epoch_2, the log lines."""
    from fdt_torch.data.image_io import imwrite
    lines = []
    images, labels, bbox, _ = chip_smoke.mtcnn_train_batch("pnet", 3, 24)
    for i, (im, lab, b) in enumerate(zip(images, labels, bbox)):
        imwrite(str(tmp_path / f"{i}.png"), im)
        lines.append(f"{tmp_path / f'{i}.png'} {int(lab)} " + " ".join(f"{v:.2f}" for v in b))
    from fdt_torch.data.mtcnn_data import parse_mtcnn_imdb
    (tmp_path / "anno.txt").write_text("\n".join(lines) + "\n")
    imdb = [dict(r, image=r["image"][:-4]) for r in parse_mtcnn_imdb(str(tmp_path / "anno.txt"))]
    log = []
    trainer = mtcnn_train.train_stage("pnet", imdb, 2, 8, str(tmp_path / "store"), frequent=1,
                                      log=log.append, device="cpu")
    assert trainer.step == 6 and len(log) == 6
    assert {p.name for p in (tmp_path / "store").iterdir()} == {"pnet_epoch_1", "pnet_epoch_2"}
    assert log[0].startswith("pnet epoch 1 step 0 acc ")


def test_cli_help_defaults_and_refusal(monkeypatch, capsys, tmp_path):
    from fdt_torch.cli import train_mtcnn
    with pytest.raises(SystemExit) as e:
        train_mtcnn.main(["--help"])
    assert e.value.code == 0
    args = train_mtcnn.build_parser().parse_args(["rnet", "--anno", "a.txt"])
    assert (args.stage, args.prefix, args.epochs, args.batch_size, args.lr, args.store,
            args.no_flip, args.device) == ("rnet", "", 10, 512, 0.01, "model_store/", False, None)
    with pytest.raises(SystemExit):
        train_mtcnn.build_parser().parse_args(["pnet"])  # --anno is required
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        with redirect_stdout(io.StringIO()):
            (tmp_path / "empty.txt").write_text("")
            train_mtcnn.main(["pnet", "--anno", str(tmp_path / "empty.txt"), "--epochs", "0"])


def test_p_r_o_workflow_on_the_cpu(tmp_path):
    """The whole chain through the CLIs on 6 seeded scenes, one epoch a
    stage at batch 16: PNet patches, PNet, hard examples mined with it, RNet,
    then ONet's hard examples (PNet + RNet) and landmark patches, ONet; every
    stage's checkpoint is written, and the trained PNet mines patches."""
    from fdt_torch.cli import gen_mtcnn_data, train_mtcnn
    from fdt_torch.data.mtcnn_data import gen_landmark_data
    torch.set_num_threads(2)
    anno = chip_smoke.write_mtcnn_set(tmp_path, n=6)
    chain = chip_smoke.mtcnn_chain(tmp_path / "m", anno, "cpu", batch_size=16)
    assert chain["pnet"]["pos"] > 0 and chain["pnet"]["part"] > 0 and chain["pnet"]["neg"] > 0
    assert sum(chain["rnet"].values()) > 0
    ck = chain["checkpoints"]
    data = tmp_path / "m" / "data_48"
    buf = io.StringIO()
    with redirect_stdout(buf):
        gen_mtcnn_data.main(["onet", "--anno", str(anno), "--out", str(data), "--pnet_ckpt",
                             ck["pnet"], "--rnet_ckpt", ck["rnet"], "--device", "cpu"])
    assert buf.getvalue().startswith("pos ")
    lm_anno = tmp_path / "lm.txt"
    rows = []
    for line in anno.read_text().splitlines():
        path, *c = line.split()
        x1, y1, x2, y2 = map(float, c[:4])
        pts = np.array([[0.3, 0.35], [0.7, 0.35], [0.5, 0.55], [0.35, 0.75], [0.65, 0.75]])
        pts = pts * [x2 - x1, y2 - y1] + [x1, y1]
        rows.append(f"{path} {x1} {x2} {y1} {y2} " + " ".join(f"{v:.1f}" for v in pts.ravel()))
    lm_anno.write_text("\n".join(rows) + "\n")
    assert gen_landmark_data(str(lm_anno), "", str(data)) == 6
    lists = [str(data / "anno_store" / f) for f in ("pos_48.txt", "neg_48.txt", "part_48.txt",
                                                     "landmark_48.txt")]
    lists = [f for f in lists if pathlib.Path(f).stat().st_size]
    with redirect_stdout(io.StringIO()):
        gen_mtcnn_data.main(["assemble", "--out", str(tmp_path / "imglist_48.txt"),
                             "--files", *lists])
        train_mtcnn.main(["onet", "--anno", str(tmp_path / "imglist_48.txt"), "--epochs", "1",
                          "--batch_size", "4", "--store", str(tmp_path / "m" / "store"),
                          "--device", "cpu"])
    assert (tmp_path / "m" / "store" / "onet_epoch_1" / "variables.npz").exists()


@pytest.mark.slow
def test_p_r_o_workflow_at_fdts_size(tmp_path):
    """fdt's e2e sizes (tests/test_mtcnn_e2e.py) on seeded scenes: PNet 6
    epochs at batch 32, mined with fdt's low cascade thresholds, RNet 2
    epochs; the trained PNet separates positives from negatives."""
    from fdt_torch.config import MTCNNConfig
    from fdt_torch.data.mtcnn_data import (append_flipped_images, assemble_annotations,
                                           gen_hard_example_data, gen_pnet_train_data,
                                           mtcnn_batches, parse_mtcnn_imdb)
    from fdt_torch.infer.mtcnn import MTCNNDetector
    anno = str(chip_smoke.write_mtcnn_set(tmp_path, n=6))
    gen_pnet_train_data(anno, "", str(tmp_path / "d12"), np.random.RandomState(0),
                        neg_per_image=10)
    store = tmp_path / "d12" / "anno_store"
    assemble_annotations(str(tmp_path / "l12.txt"), [str(store / f"{k}_12.txt")
                                                     for k in ("pos", "neg", "part")])
    imdb = append_flipped_images(parse_mtcnn_imdb(str(tmp_path / "l12.txt")))
    p = mtcnn_train.train_stage("pnet", imdb, 6, 32, str(tmp_path / "ck"), log=lambda s: None,
                                device="cpu")
    probs = {}
    for label in (1, 0):
        recs = [r for r in imdb if r["label"] == label][:64]
        ims = next(mtcnn_batches(recs, len(recs), shuffle=False))[0]
        with torch.no_grad():
            out = p.model(torch.from_numpy(ims).float().permute(0, 3, 1, 2) / 255)
        probs[label] = float(out[0].mean())
    assert probs[1] > probs[0] + 0.2, probs
    det = MTCNNDetector(p.model, lecun_init(RNet()), lecun_init(ONet()),
                        cfg=MTCNNConfig(min_face_size=40.0, thresholds=(0.4, 0.2, 0.1)),
                        device="cpu")
    st = gen_hard_example_data(lambda im: det.detect_pnet(im)[1], anno, "",
                               str(tmp_path / "d24"), 24, neg_cap_per_image=10)
    assert st.neg > 0 and st.pos + st.part > 0, st
