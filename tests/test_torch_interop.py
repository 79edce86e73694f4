"""Reference torch state dicts both ways: fdt_torch.models.torch_convert and
the `.pth` paths of the loader, the checkpoints and the CLIs, against fdt's
torch_convert / load_variables / save_variables_pth.

Every `.pth` here is made in the test from the repo's npz files (fdt's
save_variables_pth, the port's save_variables_pth) or from seeded weights
(chip_smoke.seeded_variables).  Weights move as float32 without arithmetic,
so every comparison is exact: torch.equal / assert_array_equal, no tolerance.
"""
import pathlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402
from fdt.models.facebox import FaceBox as JaxFaceBox  # noqa: E402
from fdt.models.loader import load_variables  # noqa: E402
from fdt.models.loader import save_variables_pth as fdt_save_pth  # noqa: E402
from fdt.models.mtcnn import ONet as JaxONet  # noqa: E402
from fdt.models.mtcnn import PNet as JaxPNet  # noqa: E402
from fdt.models.mtcnn import RNet as JaxRNet  # noqa: E402
from fdt.models.mtcnn import mtcnn_export_extras, mtcnn_linear_transforms  # noqa: E402
from fdt.models.pyramidbox_mobile import build_pyramidbox as jax_build  # noqa: E402
from fdt.models.torch_convert import flax_to_torch, torch_to_flax  # noqa: E402
from fdt.models.torch_convert import load_torch_state_dict as fdt_load_sd  # noqa: E402
from fdt_torch.models import (FaceBox, ONet, PNet, RNet, build_pyramidbox,  # noqa: E402
                              from_jax_variables, load_mtcnn_files, load_npz,
                              load_pyramidbox, load_pyramidbox_detector,
                              load_reference_state_dict, load_torch_state_dict,
                              load_weights_file, reference_state_dict, save_variables_pth)
from fdt_torch.models.loader import to_jax_variables  # noqa: E402
from tests.test_torch_seeded import nest_like  # noqa: E402

torch.set_num_threads(1)

NPZ = {"repo": REPO / "net_weight" / "repo_mini.npz",
       "try3": REPO / "net_weight" / "try3_mini.npz",
       "try1": REPO / "net_weight" / "try1_distilled_mini.npz"}
MTCNN = {"pnet": (PNet, JaxPNet, 12), "rnet": (RNet, JaxRNet, 24), "onet": (ONet, JaxONet, 48)}
SIZE = 128


def fdt_tree(tree):
    """A variables tree with numpy leaves (fdt's load_variables may give jax
    arrays) as nested plain dicts."""
    return jax.tree.map(np.asarray, jax.device_get(tree))


def assert_trees_equal(got, want):
    g = dict(jax.tree_util.tree_leaves_with_path(got))
    w = dict(jax.tree_util.tree_leaves_with_path(want))
    assert g.keys() == w.keys(), sorted(set(map(str, g)) ^ set(map(str, w)))[:6]
    for k in w:
        np.testing.assert_array_equal(np.asarray(g[k]), np.asarray(w[k]), err_msg=str(k))


def assert_sd_equal(got: dict, want: dict):
    assert got.keys() == want.keys(), sorted(set(got) ^ set(want))[:6]
    for k in want:
        w = torch.as_tensor(np.asarray(want[k]))
        assert got[k].dtype == w.dtype and got[k].is_contiguous(), k
        assert torch.equal(got[k], w), k


def seeded(family: str, seed: int = 3):
    """(the port's model, fdt's nested tree, fdt's module, template size) of
    seeded weights for 'facebox', 'pnet'/'rnet'/'onet' or a pyramid variant."""
    if family == "facebox":
        model, jax_model, size = FaceBox(), JaxFaceBox(), SIZE
    elif family in MTCNN:
        net, jax_net, size = MTCNN[family]
        model, jax_model = net(), jax_net()
    else:
        model, jax_model, size = build_pyramidbox(family), jax_build(family), SIZE
    flat = chip_smoke.seeded_variables(model, seed)
    model.load_state_dict(from_jax_variables(flat, getattr(model, "flatten_chw", None)))
    return model.eval(), nest_like(flat, jax_model, size), jax_model, size


def fdt_export(family: str, tree) -> dict:
    """fdt's flax_to_torch of a tree, with MTCNN's fixups and dead heads."""
    if family in MTCNN:
        return flax_to_torch(tree, inverse_transforms=mtcnn_linear_transforms(family, True),
                             extra=mtcnn_export_extras(family))
    return flax_to_torch(tree)


@pytest.mark.parametrize("variant", ["try3", "try1"])
def test_fdt_pth_detects_as_the_npz(tmp_path, variant):
    """fdt's save_variables_pth of the repo's npz loads into the port, whose
    detect rows on a seeded frame equal the npz-loaded detector's bit for
    bit (torch.equal)."""
    path = str(tmp_path / f"{variant}.pth")
    fdt_save_pth(load_variables(None, str(NPZ[variant]), 0), path)
    frame = np.random.RandomState(5).randint(0, 256, (2, 160, 160, 3), np.uint8)
    rows = [load_pyramidbox_detector(variant, w, device="cpu").detect_tensor(
        frame, conf_thresh=0.05) for w in (str(NPZ[variant]), path)]
    assert (rows[0][:, 1, :, 0] > 0.05).any()  # rows to compare
    assert np.array_equal(rows[0], rows[1])


@pytest.mark.parametrize("variant", ["repo", "try3", "try1"])
def test_save_variables_pth_is_flax_to_torch_of_the_npz(tmp_path, variant):
    """The port's save_variables_pth of an npz-loaded model is fdt's
    flax_to_torch of the same npz, key for key (num_batches_tracked 0
    included), every tensor float32, contiguous and torch.equal: the f16
    values widened exactly."""
    model = load_pyramidbox(str(NPZ[variant]), variant)
    save_variables_pth(model, str(tmp_path / "port.pth"))
    got = torch.load(tmp_path / "port.pth", weights_only=True)
    want = flax_to_torch(load_variables(None, str(NPZ[variant]), 0))
    assert_sd_equal(got, want)
    # from a variables tree (export_weights' path) too
    save_variables_pth(load_npz(str(NPZ[variant])), str(tmp_path / "tree.pth"))
    assert_sd_equal(torch.load(tmp_path / "tree.pth", weights_only=True), got)


@pytest.mark.parametrize("family", ["facebox", "pnet", "rnet", "onet", "try2"])
def test_reference_state_dict_is_flax_to_torch_of_seeded_weights(family):
    """FaceBoxes, the MTCNN nets (PReLU slopes of shape (1,), the Linear
    columns put back in NCHW order as fdt's inverse transforms do, the dead
    landmark heads zero-filled) and a seeded pyramid variant."""
    model, tree, _, _ = seeded(family)
    want = fdt_export(family, tree)
    assert_sd_equal(reference_state_dict(model), want)
    if family in ("pnet", "rnet"):
        assert set(model.reference_extras) <= set(want)


@pytest.mark.parametrize("family", ["repo", "try3", "try1", "try2", "try4", "try5",
                                    "facebox", "pnet", "rnet", "onet"])
def test_fdt_load_variables_reads_the_port_pth_back(tmp_path, family):
    """fdt's load_variables of the port's .pth gives back fdt's variables
    exactly: the repo's npz where there is one, seeded weights otherwise
    (FaceBoxes and MTCNN strict, MTCNN through fdt's linear transforms)."""
    path = str(tmp_path / "port.pth")
    if family in NPZ:
        save_variables_pth(load_pyramidbox(str(NPZ[family]), family), path)
        want = load_variables(None, str(NPZ[family]), 0)
        got = load_variables(jax_build(family), path, SIZE)
        assert_trees_equal(fdt_tree(got), {k: want[k] for k in ("params", "batch_stats")})
        return
    model, tree, jax_model, size = seeded(family)
    save_variables_pth(model, path)
    kw = ({"strict": True, "transforms": mtcnn_linear_transforms(family)} if family in MTCNN
          else {"strict": family == "facebox"})
    got = load_variables(jax_model, path, size, **kw)
    assert_trees_equal(fdt_tree(got), tree)


@pytest.mark.parametrize("family", ["facebox", "pnet", "rnet", "onet", "try3"])
def test_fdt_pth_loads_into_the_port_and_back(tmp_path, family):
    """fdt's save_variables_pth (with MTCNN's fixups and heads) loads strict
    into the port's module; reference_state_dict of it equals the file."""
    model, tree, _, _ = seeded(family)
    path = str(tmp_path / "fdt.pth")
    want = fdt_export(family, tree)
    torch.save({k: torch.from_numpy(np.asarray(v)) for k, v in want.items()}, path)
    fresh = type(model)() if family != "try3" else build_pyramidbox("try3")
    load_weights_file(fresh, path, strict=True)
    assert_sd_equal(reference_state_dict(fresh), want)


def test_mtcnn_pt_files_load_as_their_npz(tmp_path):
    """load_mtcnn_files (the cascades' and load_mtcnn_detector's loader) of
    three .pt files gives the nets of the same weights as npz files."""
    paths = {}
    nets = {}
    for name in MTCNN:
        model, tree, _, _ = seeded(name, seed=4)
        nets[name] = model
        paths[name] = str(tmp_path / f"{name}.pt")
        torch.save({k: torch.from_numpy(np.asarray(v))
                    for k, v in fdt_export(name, tree).items()}, paths[name])
    loaded = load_mtcnn_files(paths["pnet"], paths["rnet"], paths["onet"])
    for got, want in zip(loaded, nets.values()):
        assert not got.training
        for k, v in want.state_dict().items():
            assert torch.equal(got.state_dict()[k], v), k


def _flagship_sd():
    return {k: v for k, v in reference_state_dict(load_pyramidbox(str(NPZ["try3"]), "try3"))
            .items() if not k.endswith("num_batches_tracked")}


def test_prefix_is_stripped_as_fdt_prepends_it():
    """A DataParallel-style dict ("module." before every key) loads with
    prefix="module." to the values fdt's torch_to_flax reads with it."""
    sd = {"module." + k: v for k, v in _flagship_sd().items()}
    model = load_reference_state_dict(build_pyramidbox("try3"), sd, strict=True,
                                      prefix="module.")
    jax_model = jax_build("try3")
    template = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), jax.eval_shape(
        lambda: jax_model.init(jax.random.PRNGKey(0), jnp.zeros((1, SIZE, SIZE, 3)))))
    want = torch_to_flax({k: v.numpy() for k, v in sd.items()}, template, strict=True,
                         prefix="module.")
    assert_trees_equal(to_jax_variables(model), fdt_tree(want))
    with pytest.raises(KeyError, match="missing"):  # without the prefix: nothing found
        load_reference_state_dict(build_pyramidbox("try3"), sd, strict=True)
    # a transform applies to the file's tensor of its key, as fdt's does
    key = next(k for k in _flagship_sd() if k.endswith(".weight"))
    fix = {key: lambda w: w * 2}
    model = load_reference_state_dict(build_pyramidbox("try3"), sd, prefix="module.",
                                      transforms=fix)
    want = torch_to_flax({k: v.numpy() for k, v in sd.items()}, template, prefix="module.",
                         transforms={"module." + key: fix[key]})
    assert_trees_equal(to_jax_variables(model), fdt_tree(want))
    assert torch.equal(model.state_dict()[key], sd["module." + key] * 2)


def test_shape_mismatch_raises_as_in_fdt(tmp_path):
    sd = _flagship_sd()
    key = next(k for k in sd if k.endswith("conv.weight") or k.endswith(".weight"))
    sd[key] = sd[key][:1]
    with pytest.raises(ValueError, match="shape mismatch"):
        load_reference_state_dict(build_pyramidbox("try3"), sd, strict=False)
    path = str(tmp_path / "bad.pth")
    torch.save(sd, path)
    with pytest.raises(ValueError, match="shape mismatch"):
        load_variables(jax_build("try3"), path, SIZE)


def test_missing_key_strict_raises_and_otherwise_is_fdt_zero(tmp_path):
    """strict=True raises KeyError on a missing key (fdt too); strict=False
    (the PyramidBox load) leaves it at fdt's zero template: a missing conv
    weight and a missing running_var are zeros in both, the rest equal."""
    sd = _flagship_sd()
    gone = [k for k in sd if k.endswith(".weight") and sd[k].dim() == 4][3]
    gone_var = next(k for k in sd if k.endswith("running_var"))
    del sd[gone], sd[gone_var]
    path = str(tmp_path / "partial.pth")
    torch.save(sd, path)
    with pytest.raises(KeyError, match="missing"):
        load_reference_state_dict(build_pyramidbox("try3"), sd, strict=True)
    with pytest.raises(KeyError, match="missing"):
        load_variables(jax_build("try3"), path, SIZE, strict=True)
    model = load_pyramidbox(path, "try3")  # the front door: strict=False, as fdt
    state = model.state_dict()
    assert not state[gone].any() and not state[gone_var].any()
    want = fdt_tree(load_variables(jax_build("try3"), path, SIZE))
    assert_trees_equal(to_jax_variables(model), want)


def test_unexpected_keys_dead_heads_and_full_module_pickle(tmp_path):
    """The reference's dead MTCNN heads are skipped by a strict load, and
    only they: another unexpected key raises under strict=True (fdt ignores
    every such key: a divergence) and is ignored under strict=False.  A file
    that pickles a whole module is refused by both loaders (weights_only)."""
    model, tree, _, _ = seeded("rnet")
    sd = {k: torch.from_numpy(np.asarray(v)) for k, v in fdt_export("rnet", tree).items()}
    assert "conv5_3.weight" in sd
    load_reference_state_dict(RNet(), sd, strict=True)
    sd["conv9.weight"] = torch.zeros(3)
    with pytest.raises(KeyError, match="unexpected"):
        load_reference_state_dict(RNet(), sd, strict=True)
    got = load_reference_state_dict(RNet(), sd, strict=False)
    assert torch.equal(got.conv4.weight, model.conv4.weight)
    path = str(tmp_path / "module.pth")
    torch.save(torch.nn.Linear(2, 2), path)
    with pytest.raises(ValueError, match="weights_only"):
        load_torch_state_dict(path)
    with pytest.raises(Exception, match="Weights only load failed"):
        fdt_load_sd(path)


def test_load_torch_state_dict_drops_num_batches_tracked_as_fdt(tmp_path):
    path = str(tmp_path / "fb.pth")
    save_variables_pth(seeded("facebox")[0], path)
    got, want = load_torch_state_dict(path), fdt_load_sd(path)
    assert got.keys() == want.keys() and not any("num_batches" in k for k in got)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)


def test_checkpoint_readers_take_a_pth(tmp_path):
    """read_variables / load_model_weights / load_weights (--resume of every
    training CLI, net2net's --teacher_weights) read a .pth instead of
    refusing it; a .pth without the model to read it through is refused."""
    from fdt_torch.train.checkpoint import load_model_weights, load_weights, read_variables
    from fdt_torch.train.loops import PyramidTrainer
    path = str(tmp_path / "try3.pth")
    save_variables_pth(load_pyramidbox(str(NPZ["try3"]), "try3"), path)
    assert_trees_equal(read_variables(path, build_pyramidbox("try3")),
                       read_variables(str(NPZ["try3"])))
    with pytest.raises(ValueError, match="model="):
        read_variables(path)
    a = load_model_weights(path, build_pyramidbox("try3"))
    b = load_model_weights(str(NPZ["try3"]), build_pyramidbox("try3"))
    for k, v in b.state_dict().items():
        assert torch.equal(a.state_dict()[k], v), k
    trainer = PyramidTrainer(build_pyramidbox("try3"), "try3", input_size=SIZE, device="cpu")
    load_weights(path, trainer, strict=False)
    assert trainer.model.training  # the trainer's mode is kept
    for k, v in b.state_dict().items():
        assert torch.equal(trainer.model.state_dict()[k], v), k


def test_gen_mtcnn_data_mining_nets_take_pt_files(tmp_path):
    """gen_mtcnn_data --pnet_ckpt/--rnet_ckpt take the reference's .pt files."""
    from fdt_torch.cli.gen_mtcnn_data import mining_detector
    paths = {}
    for name in ("pnet", "rnet"):
        model, tree, _, _ = seeded(name, seed=6)
        paths[name] = (str(tmp_path / f"{name}.pt"), model)
        save_variables_pth(model, paths[name][0])
    det = mining_detector(paths["pnet"][0], paths["rnet"][0], device="cpu")
    for got, (_, want) in zip((det.pnet, det.rnet), paths.values()):
        for k, v in want.state_dict().items():
            assert torch.equal(got.state_dict()[k], v), k
