"""fdt_torch's int8 quantization (fdt_torch/ops/quant.py) against fdt's
(fdt/ops/quant.py), on the same numpy inputs and weights.

fdt's detectors run Int8Conv inside a jitted graph, so fdt's side here is
always jitted: XLA compiles `amax / 127.0` into a product with the float32
reciprocal, and the float32 epilogue `float(acc) * s + bias` into one FMA.
The port computes the product (bit-equal), and rounds `float(acc) * s`
before adding the bias, as fdt's source and the card's kernel K4 do; so its
float32 outputs of a conv with a bias are within one float32 ulp of the
product plus one of the output from fdt's (measured: 9.5e-7 at outputs of
order 10), and bit-equal without a bias and in bf16 (where XLA rounds the
product to bf16 before the add too).  The quantized tensors, the scales and
the int32 accumulators are bit-equal.  On the CPU the wrappers run their
plain versions; tests/test_torch_cuda.py holds the kernels to them.
"""
import pathlib
import sys

import flax.linen as jnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402
from fdt.models.common import conv as jax_conv  # noqa: E402
from fdt.ops.quant import Int8Conv as JaxInt8Conv  # noqa: E402
from fdt.ops.quant import quantize_symmetric as jax_quantize  # noqa: E402
from fdt_torch.models.common import conv  # noqa: E402
from fdt_torch.ops import quant  # noqa: E402
from fdt_torch.ops.quant import (MIN_QUANT_REDUCTION, Int8Conv2d, int8_convs,  # noqa: E402
                                 quant_mode, quantize_symmetric, quantized)

torch.set_num_threads(1)


def _jax_q(x, axes):
    q, s = jax.jit(lambda a: jax_quantize(a, axes=axes))(jnp.asarray(x))
    return np.asarray(q), np.asarray(s, np.float32)


def _values(case: str, rng) -> np.ndarray:
    x = (rng.randn(2, 9, 7, 12) * 3).astype(np.float32)
    if case == "zero":
        x[:] = 0
    elif case == "nan-inf":
        x.flat[5], x.flat[40] = np.nan, np.inf
    elif case == "inf":
        x.flat[3] = -np.inf
    elif case == "ties":  # exact halves of the scale: round half to even
        x = (np.arange(-254, 256, dtype=np.float32) / 2).reshape(2, 5, 3, 17)
    return x


@pytest.mark.parametrize("case", ["noise", "zero", "nan-inf", "inf", "ties"])
def test_per_tensor_quantize_bit_equal_to_fdt(case):
    """NHWC numpy → fdt's jitted quantize_symmetric(axes=None); the port's on
    the same values in NCHW: q, scale bit-equal, and K5's plain version
    writes q NHWC.  A NaN gives 0, a NaN amax scale 1, an inf amax scale inf
    (every q 0), as fdt does."""
    x = _values(case, np.random.RandomState(0))
    want_q, want_s = _jax_q(x, None)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    q, s = quantize_symmetric(xt)
    np.testing.assert_array_equal(q.permute(0, 2, 3, 1).numpy(), want_q)
    np.testing.assert_array_equal(s.numpy().reshape(-1), want_s.reshape(-1))
    q5, s5 = quant.quantize_int8(xt.contiguous(memory_format=torch.channels_last))
    assert q5.shape == x.shape and q5.is_contiguous() and s5.shape == (1,)
    np.testing.assert_array_equal(q5.numpy(), want_q)
    if case == "zero":
        assert float(s5) == 1.0 and not q5.any()


def test_per_channel_quantize_bit_equal_to_fdt():
    """fdt quantizes a HWIO kernel over axes (0, 1, 2); the port an OIHW
    weight over dims (1, 2, 3): the same int8 weights and scales, a zero
    channel included (scale 1)."""
    kernel = (np.random.RandomState(1).randn(3, 3, 16, 8) * 0.05).astype(np.float32)
    kernel[..., 5] = 0
    want_q, want_s = _jax_q(kernel, (0, 1, 2))
    q, s = quantize_symmetric(torch.from_numpy(kernel.transpose(3, 2, 0, 1).copy()), (1, 2, 3))
    np.testing.assert_array_equal(q.numpy(), want_q.transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(s.numpy().reshape(-1), want_s.reshape(-1))
    assert s.reshape(-1)[5] == 1.0


def test_reciprocal_of_127_is_the_float32_quotient():
    """The port's constant is XLA's: float32(1/127) equals 1/127 rounded once."""
    assert quant._INV127.item() == np.float32(1) / np.float32(127)


def test_bf16_activation_widened_before_the_division():
    x = (np.random.RandomState(2).randn(1, 6, 5, 32) * 3).astype(np.float32)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    want_q, want_s = jax.jit(lambda a: jax_quantize(a, axes=None))(xb)
    q, s = quant.quantize_int8(torch.from_numpy(x).to(torch.bfloat16).permute(0, 3, 1, 2))
    np.testing.assert_array_equal(q.numpy(), np.asarray(want_q))
    assert s.item() == float(np.asarray(want_s).reshape(()))


# (groups, stride, pad, dilation, cin, cout, kernel, x scale): the four
# geometries of tests/test_quant.py:61-66, the flagship's 7×7/2 stem (K =
# 147), a 2-channel head and a grouped 1×1 (try1's latlayer_fc_my, narrowed)
GEOMETRIES = {
    "plain-3x3": (1, 1, 1, 1, 64, 32, 3, 3.0),
    "strided": (1, 2, 1, 1, 64, 32, 3, 3.0),
    "dilated": (1, 1, 2, 2, 64, 32, 3, 3.0),
    "grouped": (2, 1, 1, 1, 64, 32, 3, 3.0),
    "stem-k147": (1, 2, 3, 1, 3, 16, 7, 60.0),
    "head-n2": (1, 1, 1, 1, 32, 2, 3, 3.0),
    "grouped-1x1": (4, 1, 0, 1, 256, 64, 1, 3.0),
}


def _pair(name: str, dtype, bias: bool = True):
    """fdt's Int8Conv and the port's Int8Conv2d on the same seeded weights,
    bias and input: (fdt's jitted output, fdt's module and variables, the
    port's module, x as numpy NHWC float32)."""
    groups, stride, pad, dil, cin, cout, k, scale = GEOMETRIES[name]
    rng = np.random.RandomState(sum(map(ord, name)))
    x = (rng.randn(2, 14, 12, cin) * scale).astype(np.float32)
    kernel = (rng.randn(k, k, cin // groups, cout) * 0.05).astype(np.float32)
    b = rng.randn(cout).astype(np.float32)
    m = JaxInt8Conv(cout, (k, k), strides=(stride, stride), padding=((pad, pad), (pad, pad)),
                    feature_group_count=groups, kernel_dilation=(dil, dil), use_bias=bias,
                    dtype=dtype)
    params = {"kernel": jnp.asarray(kernel)}
    if bias:
        params["bias"] = jnp.asarray(b)
    v = {"params": params}
    want = np.asarray(jax.jit(m.apply)(v, jnp.asarray(x).astype(dtype)).astype(jnp.float32))
    c = Int8Conv2d(cin, cout, k, stride, pad, dilation=dil, groups=groups, bias=bias)
    c.load_state_dict({"weight": torch.from_numpy(kernel.transpose(3, 2, 0, 1).copy()),
                       **({"bias": torch.from_numpy(b)} if bias else {})})
    return want, m, v, c, x


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", list(GEOMETRIES))
def test_int8_conv_matches_fdt(name, dtype):
    """Quantized input, weights, scales and int32 accumulators bit-equal to
    fdt's; outputs bit-equal in bf16 and within the FMA bound in float32."""
    jdt = getattr(jnp, dtype)
    want, m, v, c, x = _pair(name, jdt)
    groups, stride, pad, dil, cin, cout, k, _ = GEOMETRIES[name]
    assert quant.reduction(c) >= MIN_QUANT_REDUCTION
    tdt = getattr(torch, dtype)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).to(tdt).contiguous(
        memory_format=torch.channels_last if tdt == torch.bfloat16 else torch.contiguous_format)
    c = c.to(tdt)
    with torch.no_grad():
        got = c(xt)
    assert got.dtype == tdt and got.is_contiguous(
        memory_format=torch.channels_last if tdt == torch.bfloat16 else torch.contiguous_format)
    got = got.float().permute(0, 2, 3, 1).numpy()

    xq_j, sx_j = _jax_q(jnp.asarray(x).astype(jdt), None)
    wq_j, sw_j = _jax_q(v["params"]["kernel"], (0, 1, 2))
    xq, sx = quant.quantize_int8(xt)
    wpack, sw = c._int8
    np.testing.assert_array_equal(xq.numpy(), xq_j)
    assert sx.item() == float(sx_j.reshape(()))
    np.testing.assert_array_equal(quant.unpack_weight(wpack, cout, cin // groups, (k, k)).numpy(),
                                  wq_j.transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(sw.numpy(), sw_j.reshape(-1))
    dn = jax.lax.conv_dimension_numbers(xq_j.shape, wq_j.shape, ("NHWC", "HWIO", "NHWC"))
    acc_j = np.asarray(jax.lax.conv_general_dilated(
        jnp.asarray(xq_j), jnp.asarray(wq_j), (stride, stride), ((pad, pad), (pad, pad)),
        rhs_dilation=(dil, dil), dimension_numbers=dn, feature_group_count=groups,
        preferred_element_type=jnp.int32))
    acc = torch.nn.functional.conv2d(
        xq.permute(0, 3, 1, 2).double(),
        quant.unpack_weight(wpack, cout, cin // groups, (k, k)).double(), None, stride, pad,
        dil, groups).to(torch.int32)
    np.testing.assert_array_equal(acc.permute(0, 2, 3, 1).numpy(), acc_j)

    if dtype == "bfloat16":
        np.testing.assert_array_equal(got, want)
    else:
        product = np.abs(acc_j.astype(np.float32) * (sx.item() * sw.numpy()))
        bound = np.spacing(product.astype(np.float32)) + np.spacing(np.abs(want))
        assert np.all(np.abs(got - want) <= bound)


@pytest.mark.parametrize("name", ["plain-3x3", "stem-k147"])
def test_int8_conv_without_bias_bit_equal_to_fdt(name):
    """No bias, no FMA: the float32 outputs are fdt's bit for bit."""
    want, _, _, c, x = _pair(name, jnp.float32, bias=False)
    with torch.no_grad():
        got = c(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    np.testing.assert_array_equal(got, want)


def test_context_scoping_and_nesting():
    assert quant_mode() is None
    with quantized("int8"):
        assert quant_mode() == "int8"
        with quantized(None):
            assert quant_mode() is None
        assert quant_mode() == "int8"
    assert quant_mode() is None
    with pytest.raises(ValueError):
        with quantized("int4"):
            pass


def test_conv_helper_swaps_module_inside_context():
    """fdt_torch.models.common.conv builds Int8Conv2d inside the switch, as
    fdt's conv() builds Int8Conv; the switch is read when the model is built."""
    assert type(conv(8, 4, 3, padding=1)) is nn.Conv2d
    with quantized("int8"):
        c_q = conv(8, 4, 3, padding=1)
    assert isinstance(c_q, Int8Conv2d)
    assert isinstance(jax_conv(4, 3, padding=1), jnn.Conv)


def test_state_dict_loads_unchanged():
    """A float model's state dict loads strict into the same model built under
    quantized("int8") (same names and shapes), the load re-quantizes the
    weights, and int8_convs keeps the float model's state dict."""
    from fdt_torch.models import build_pyramidbox

    float_model = build_pyramidbox("try1").eval()
    with quantized("int8"):
        q_model = build_pyramidbox("try1").eval()
    swapped = [m for m in q_model.modules() if isinstance(m, Int8Conv2d)]
    assert len(swapped) == COUNTS["try1"][0]  # the float-path convs stay nn.Conv2d
    state = float_model.state_dict()
    q_model.load_state_dict(state, strict=True)
    for m in swapped:
        wq, sw = quantize_symmetric(m.weight.detach(), (1, 2, 3))
        assert torch.equal(m._int8[1], sw.reshape(-1))
    out = int8_convs(float_model).state_dict()
    assert list(out) == list(state) and all(torch.equal(out[k], state[k]) for k in state)


def test_small_conv_falls_back_to_float():
    """reduction < MIN_QUANT_REDUCTION (a 3-channel 3×3, a depthwise 3×3)
    keeps the float path: such a conv stays an nn.Conv2d, built inside the
    switch or passed to int8_convs, and Int8Conv2d refuses its geometry."""
    assert 3 * 3 * 3 < MIN_QUANT_REDUCTION
    x = torch.from_numpy(np.random.RandomState(1).randn(1, 3, 8, 8).astype(np.float32))
    with quantized("int8"):
        c_q = conv(3, 8, 3, padding=1)
    assert type(c_q) is nn.Conv2d
    c_f = nn.Conv2d(3, 8, 3, padding=1)
    c_f.load_state_dict(c_q.state_dict())
    with torch.no_grad():
        assert torch.equal(c_f(x), c_q(x))
    depthwise = nn.Conv2d(16, 16, 3, padding=1, groups=16)
    assert type(int8_convs(nn.Sequential(depthwise))[0]) is nn.Conv2d
    assert int8_convs(depthwise) is depthwise
    with pytest.raises(ValueError, match="MIN_QUANT_REDUCTION"):
        Int8Conv2d(3, 8, 3, padding=1)


# int8 convs, float fallbacks, grouped int8 convs of each model
COUNTS = {"repo": (121, 0, 0), "try1": (89, 16, 3), "try3": (85, 23, 0), "facebox": (33, 0, 0)}


@pytest.mark.parametrize("name", list(COUNTS))
def test_int8_convs_counts_and_leaves_the_model_unchanged(name):
    """int8_convs swaps, in place, every conv of reduction ≥ 32 (the
    flagship's 10 head-supervision convs too, which a detect never runs),
    each Int8Conv2d holding the conv's parameter objects; place_model
    quantizes and casts a copy, leaving the model it was given unchanged,
    and refuses a model already cast from float32."""
    from fdt_torch.infer.pyramidbox import place_model
    from fdt_torch.models import FaceBox, build_pyramidbox

    model = FaceBox() if name == "facebox" else build_pyramidbox(name)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    placed = place_model(model, torch.device("cpu"), torch.bfloat16, torch.channels_last, "int8")
    assert all(p.dtype == torch.bfloat16 for p in placed.parameters())
    assert not any(isinstance(m, Int8Conv2d) for m in model.modules())
    state = model.state_dict()  # a bf16 int8 detector leaves the model float32
    assert all(torch.equal(state[k], v) and state[k].dtype == v.dtype for k, v in before.items())
    params = dict(model.named_parameters())
    q = int8_convs(model)
    assert q is model
    convs = [m for m in q.modules() if isinstance(m, nn.Conv2d)]
    int8 = [m for m in convs if isinstance(m, Int8Conv2d)]
    assert (len(int8), len(convs) - len(int8), sum(m.groups > 1 for m in int8)) == COUNTS[name]
    assert all(p is params[k] for k, p in q.named_parameters())
    with pytest.raises(ValueError, match="float32"):
        place_model(model.to(torch.bfloat16), torch.device("cpu"), torch.bfloat16,
                    torch.channels_last, "int8")


def test_wrappers_refuse_what_they_do_not_take():
    x = torch.zeros(1, 8, 4, 4)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        quant.quantize_int8(x.double())
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        quant.quantize_int8(x[0])
    c = Int8Conv2d(8, 4, 3, padding=1)
    c.quantize_weights()
    xq, sx = quant.quantize_int8(x)
    wpack, sw = c._int8
    args = dict(kernel=(3, 3), stride=(1, 1), padding=(1, 1), dilation=(1, 1), groups=1,
                out_dtype=torch.float32, channels_last=False)
    with pytest.raises(ValueError, match="int8"):
        quant.conv_int8(xq.float(), sx, wpack, sw, None, **args)
    with pytest.raises(ValueError, match="pack_weight"):
        quant.conv_int8(xq, sx, wpack[:, :, :16], sw, None, **args)
    with pytest.raises(ValueError, match="bias"):
        quant.conv_int8(xq, sx, wpack, sw, torch.zeros(4, dtype=torch.bfloat16), **args)
    with pytest.raises(ValueError, match="out_dtype"):
        quant.conv_int8(xq, sx, wpack, sw, None, **{**args, "out_dtype": torch.float16})
    with pytest.raises(ValueError, match="groups"):
        quant.conv_int8(xq, sx, wpack, sw, None, **{**args, "groups": 3})


@pytest.mark.parametrize("name", list(chip_smoke.INT8_EDGES))
def test_card_edge_cases_run_on_the_cpu(name):
    """chip_smoke's K4/K5 edge cases through the wrappers on the CPU (their
    plain versions): the shapes, layouts and dtypes the card's check asks
    for, a scale of 1 for the zero tensor, NaN only where fdt's arithmetic
    gives it (an inf amax)."""
    x, c, cl = chip_smoke.int8_edge_case(name)
    with torch.no_grad():
        y = c(x)
    b, _, h, w = x.shape
    assert y.dtype == x.dtype and y.shape[:2] == (b, c.out_channels)
    assert quant.is_channels_last(y) == (cl and y.shape[2] * y.shape[3] > 1)
    fill = chip_smoke.INT8_EDGES[name][-1]
    assert (x.storage_offset() == 1) == (fill == "offset")
    assert bool(torch.isnan(y).any()) == (fill == "inf")
    if fill == "zero":
        assert quant.quantize_int8(x)[1].item() == 1.0
    assert chip_smoke.check_int8_conv(c, x) == (0.0, 0.0)
