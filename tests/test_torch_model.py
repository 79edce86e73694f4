"""fdt_torch PyramidBox and the flax → torch weight carry-across against
fdt's PyramidBox.apply, on a numpy-seeded flax variable tree."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fdt.models.pyramidbox import PyramidBox as JaxPyramidBox
from fdt_torch.models import PyramidBox, from_jax_variables, load_npz, load_pyramidbox
from fdt_torch.models.common import max_in_out_conf

torch.set_num_threads(1)

CUT = (1, 1, 1, 1)


def seeded_variables(model, seed=0, size=64):
    """The flax variable tree of `model`, filled by numpy: He-scaled conv
    kernels, small biases, BN statistics away from identity."""
    shapes = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0),
                                               jnp.zeros((1, size, size, 3))))
    rng = np.random.RandomState(seed)

    def fill(path, s):
        name = path[-1].key
        if name == "kernel":
            fan_in = int(np.prod(s.shape[:-1]))
            return (rng.randn(*s.shape) * np.sqrt(2.0 / fan_in)).astype(np.float32)
        if name == "bias":
            return (rng.randn(*s.shape) * 0.05).astype(np.float32)
        if name in ("scale", "var"):
            return rng.uniform(0.5, 1.5, s.shape).astype(np.float32)
        if name == "mean":
            return (rng.randn(*s.shape) * 0.1).astype(np.float32)
        raise KeyError(name)

    tree = jax.tree_util.tree_map_with_path(fill, shapes)
    return jax.tree.map(np.asarray, {k: dict(v) for k, v in tree.items()})


@pytest.fixture(scope="module")
def variables():
    return seeded_variables(JaxPyramidBox(num_blocks=CUT))


def test_from_jax_variables_layout(variables):
    sd = from_jax_variables(variables)
    model = PyramidBox(CUT)
    assert set(sd) == set(model.state_dict())
    k = variables["params"]["layer1"]["0"]["downsample__0"]["kernel"]      # HWIO
    np.testing.assert_array_equal(sd["layer1.0.downsample.0.weight"].numpy(),
                                  k.transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(sd["face_conf.3.bias"].numpy(),
                                  variables["params"]["face_conf__3"]["bias"])
    bn = variables["batch_stats"]["layer5"]["4"]
    np.testing.assert_array_equal(sd["layer5.4.running_var"].numpy(), bn["var"])
    np.testing.assert_array_equal(sd["layer5.4.weight"].numpy(),
                                  variables["params"]["layer5"]["4"]["scale"])
    assert int(sd["bn1.num_batches_tracked"]) == 0


@pytest.mark.parametrize("height,width", [(128, 128), (150, 130)], ids=["even", "odd"])
def test_forward_matches_flax(variables, height, width):
    """face_loc and face_conf agree to 1e-5 of the largest magnitude: float32
    on both sides with convolutions summed in another order; the LFPN adds
    unnormalized maps, so outputs reach ~1e4 and an absolute bound would not
    scale.  150x130 makes the LFPN crop its upsampled maps."""
    x = (np.random.RandomState(height).rand(1, height, width, 3) * 255 - 117).astype(np.float32)
    want = JaxPyramidBox(num_blocks=CUT).apply(variables, jnp.asarray(x))
    model = PyramidBox(CUT)
    model.load_state_dict(from_jax_variables(variables), strict=True)
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(x).permute(0, 3, 1, 2).contiguous())
    assert got["source_shapes"] == want["source_shapes"]
    for key in ("face_loc", "face_conf"):
        ref = np.asarray(want[key])
        assert got[key].shape == ref.shape
        scale = np.abs(ref).max()
        np.testing.assert_allclose(got[key].numpy(), ref, rtol=0, atol=1e-5 * scale)


@pytest.mark.parametrize("first", [True, False])
def test_max_in_out_conf_matches_fdt(first):
    from fdt.models.common import max_in_out_conf as jax_max_in_out
    x = np.random.RandomState(int(first)).randn(2, 5, 7, 4).astype(np.float32)
    np.testing.assert_array_equal(max_in_out_conf(torch.from_numpy(x), first).numpy(),
                                  np.asarray(jax_max_in_out(jnp.asarray(x), first)))


def test_repo_mini_loads_strict_into_full_depth_model():
    variables = load_npz("net_weight/repo_mini.npz")
    n = sum(1 for col in variables.values() for _ in jax.tree.leaves(col))
    assert n == 417
    model = load_pyramidbox("net_weight/repo_mini.npz")
    sd = model.state_dict()
    assert all(v.dtype in (torch.float32, torch.int64) for v in sd.values())
    # the head branch is loaded although detection never computes it
    assert sd["head_conf.4.weight"].shape == (2, 512, 3, 3)
    np.testing.assert_array_equal(
        sd["conv1.weight"].numpy(),
        variables["params"]["conv1"]["kernel"].transpose(3, 2, 0, 1))
