"""Seeded weights for the port's model tests.

chip_smoke.seeded_variables makes a flat flax-layout tree for a port model
from a numpy seed (the goldens and chip_smoke.py make the same weights, so
no weight file is committed); `nest_like` places that tree into fdt's nested
flax tree, so that both packages run the same weights.  The tests here check
that the two trees hold the same leaves for FaceBoxes, every mobile
variant and MTCNN's PNet, RNet and ONet.
"""
import pathlib
import sys

import jax
import jax.numpy as jnp
import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402
from fdt.models import mtcnn as jax_mtcnn  # noqa: E402
from fdt.models.facebox import FaceBox as JaxFaceBox  # noqa: E402
from fdt.models.pyramidbox_mobile import build_pyramidbox as jax_build  # noqa: E402
from fdt_torch.models import (ONet, PNet, RNet, FaceBox, build_pyramidbox,  # noqa: E402
                              from_jax_variables)


def nest_like(flat: dict, jax_model, size: int) -> dict:
    """Place chip_smoke.seeded_variables' flat tree into the nested flax tree
    of `jax_model`; every leaf must be found with its shape."""
    shapes = jax.eval_shape(lambda: jax_model.init(jax.random.PRNGKey(0),
                                                   jnp.zeros((1, size, size, 3))))

    def fill(path, s):
        leaf = flat[path[0].key]["__".join(k.key for k in path[1:-1])][path[-1].key]
        assert leaf.shape == s.shape, (path, leaf.shape, s.shape)
        return leaf

    tree = jax.tree_util.tree_map_with_path(fill, shapes)
    return {k: dict(v) for k, v in tree.items()}


# leaves (params and batch statistics) of each model's tree
LEAVES = {"facebox": 174, "try1": 330, "try2": 429, "try3": 378, "try4": 423, "try5": 423,
          "pnet": 13, "rnet": 16, "onet": 21}
MTCNN_NETS = {"pnet": (PNet, jax_mtcnn.PNet, 12), "rnet": (RNet, jax_mtcnn.RNet, 24),
              "onet": (ONet, jax_mtcnn.ONet, 48)}


@pytest.mark.parametrize("name", list(LEAVES))
def test_seeded_variables_fill_fdt_tree_exactly(name):
    """Every leaf of fdt's tree comes from the flat seeded tree, which loads
    strict into the port, and nothing is left over; BN variances are
    positive."""
    size = 128
    if name == "facebox":
        model, jax_model = FaceBox(), JaxFaceBox()
    elif name in MTCNN_NETS:
        net, jax_net, size = MTCNN_NETS[name]
        model, jax_model = net(), jax_net()
    else:
        model, jax_model = build_pyramidbox(name), jax_build(name)
    flat = chip_smoke.seeded_variables(model, 0)
    variables = nest_like(flat, jax_model, size)
    model.load_state_dict(from_jax_variables(flat, getattr(model, "flatten_chw", None)),
                          strict=True)
    n_flat = sum(len(v) for col in flat.values() for v in col.values())
    n_port = sum(not k.endswith("num_batches_tracked") for k in model.state_dict())
    assert n_flat == len(jax.tree.leaves(variables)) == n_port == LEAVES[name]
    assert all(v["var"].min() > 0 for v in flat["batch_stats"].values())
    slopes = [v["negative_slope"] for v in flat["params"].values() if "negative_slope" in v]
    assert all(0.1 <= s <= 0.3 for s in slopes) and bool(slopes) == (name in MTCNN_NETS)
