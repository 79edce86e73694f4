"""fdt_torch's Inception-ResNet-v2 against fdt's flax module
(fdt/models/inception_resnet_v2.py): the full model's state-dict names are
fdt's torch names (fdt's _torch_key over its abstract init, no compile), the
reduced towers (2, 3, 2) at 299² (the floor the final 8×8 pool sets) give
fdt's logits on the same seeded variables within fdt's own 2e-4, and a
`.pth` of it round-trips.  The weights are chip_smoke.seeded_inception's:
fdt's test's random BatchNorm affine parameters and the statistics of a
seeded calibration batch, so that the logits depend on the image.
"""
import pathlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import torch

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402
from fdt.models.inception_resnet_v2 import InceptionResnetV2 as JaxInception  # noqa: E402
from fdt.models.torch_convert import _torch_key  # noqa: E402
from fdt_torch.models import (InceptionResnetV2, load_reference_state_dict,  # noqa: E402
                              load_torch_state_dict, save_variables_pth)
from fdt_torch.models.loader import flax_paths, to_jax_variables  # noqa: E402

torch.set_num_threads(1)

REDUCED = (2, 3, 2)
TOL = 2e-4  # fdt's own tolerance against the reference torch module


def test_full_model_names_are_fdt_torch_keys():
    """Every parameter and running statistic of the full (10, 20, 9) model
    is named as fdt's converter names fdt's variable, and flax_paths maps
    each back to fdt's path."""
    model = JaxInception()
    shapes = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0),
                                               jnp.zeros((1, 299, 299, 3))))
    names = {}
    jax.tree_util.tree_map_with_path(
        lambda p, s: names.__setitem__(_torch_key(p), (tuple(str(k.key) for k in p), s.shape)),
        shapes)
    ours = InceptionResnetV2()
    state = {k: v for k, v in ours.state_dict().items() if not k.endswith("num_batches_tracked")}
    assert state.keys() == names.keys()
    paths = flax_paths(ours)
    for key, (path, shape) in names.items():
        assert paths[key] == path, key
        v = state[key]
        assert (v.permute(2, 3, 1, 0).shape if v.dim() == 4 else
                v.T.shape if v.dim() == 2 else v.shape) == shape, key
    assert sum(p.numel() for p in ours.parameters()) == 55_845_001


def test_reduced_towers_match_fdt_forward():
    """Every block type (stem, Mixed_5b/6a/7a, Block35/17/8, the last
    Block8, conv, pool, classif) on the same seeded variables, float32
    "highest" on both sides, within fdt's 2e-4."""
    model = chip_smoke.seeded_inception(REDUCED)
    images = chip_smoke.inception_images(2)
    with torch.no_grad():
        got = model(images).numpy()
    assert np.isfinite(got).all()
    assert chip_smoke.inception_spread(torch.from_numpy(got)) > chip_smoke.INCEPTION_SPREAD_MIN
    with jax.default_matmul_precision("highest"):
        want = np.asarray(JaxInception(repeats=REDUCED).apply(
            to_jax_variables(model), jnp.asarray(images.numpy().transpose(0, 2, 3, 1))))
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def test_pth_round_trip(tmp_path):
    """save_variables_pth → load_torch_state_dict → a strict
    load_reference_state_dict gives every tensor back (torch.equal) and the
    same logits."""
    model = chip_smoke.seeded_inception(REDUCED)
    path = str(tmp_path / "inception.pth")
    save_variables_pth(model, path)
    fresh = load_reference_state_dict(InceptionResnetV2(repeats=REDUCED),
                                      load_torch_state_dict(path), strict=True).eval()
    assert chip_smoke.same_state(fresh, model)
    x = chip_smoke.inception_images(1)
    with torch.no_grad():
        assert torch.equal(fresh(x), model(x))
