"""The fold of conv → BatchNorm → ReLU chains (fdt_torch/models/fused.py) on
the CPU, where a folded chain runs the fused call's plain version: F.conv2d
with the folded weight and bias, then the add, then the ReLU.

Each chain kind's folded forward equals its modules' eval forward in
float64; the model's state dict and storage are untouched; train mode,
float32 detectors and int8 convs keep the modules; an in-place load folds
again before the next forward; ReLU6 chains are left alone; and the
counters read what each benchmarked model folds.
"""
import pathlib
import sys

import pytest
import torch
from torch import nn

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

from fdt_torch.infer.pyramidbox import PyramidBoxDetector  # noqa: E402
from fdt_torch.models import fused  # noqa: E402
from fdt_torch.models.common import SSHContext, batch_norm, conv  # noqa: E402
from fdt_torch.models.pyramidbox import (Bottleneck, ExtraLayer, resnet_stem,  # noqa: E402
                                         stem_chains)
from fdt_torch.models.pyramidbox_mobile import build_pyramidbox  # noqa: E402
from fdt_torch.models.retinaface import SSH, RetinaFace, conv_bn  # noqa: E402
from fdt_torch.ops.quant import Int8Conv2d, int8_convs  # noqa: E402

torch.set_num_threads(1)


def _seeded(module: nn.Module, seed: int = 0) -> nn.Module:
    """`module` in eval mode with every BatchNorm's affine and statistics
    drawn away from the identity, and every conv bias non-zero."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, nn.BatchNorm2d):
                m.weight.copy_(torch.rand(m.num_features, generator=g) + 0.5)
                m.bias.copy_(torch.rand(m.num_features, generator=g) - 0.5)
                m.running_mean.copy_(torch.rand(m.num_features, generator=g) - 0.5)
                m.running_var.copy_(torch.rand(m.num_features, generator=g) + 0.5)
            elif isinstance(m, nn.Conv2d) and m.bias is not None:
                m.bias.copy_(torch.rand(m.out_channels, generator=g) - 0.5)
    return module.eval()


class _Stem(nn.Module):
    """The ResNet stem of resnet50_trunk alone: conv 7×7/2 → BN → ReLU → pool."""

    def __init__(self):
        super().__init__()
        self.conv1 = conv(3, 64, 7, 2, 3, bias=False)
        self.bn1 = batch_norm(64)

    def conv_chains(self):
        return stem_chains(self)

    def forward(self, x):
        return resnet_stem(self, x)


class _SSH(nn.Module):
    """An SSHContext whose conv → ReLU chains are declared, as the flagship
    declares its own."""

    def __init__(self, cin: int, xchannels: int):
        super().__init__()
        self.ssh = SSHContext(cin, xchannels)

    def conv_chains(self):
        return self.ssh.relu_chains()

    def forward(self, x):
        return self.ssh(x)


# chain kind → (module, input channels, input side)
CHAINS = {
    "bottleneck": (lambda: Bottleneck(64, 16), 64, 12),
    "bottleneck_downsample": (lambda: Bottleneck(32, 16, stride=2), 32, 13),
    "bottleneck_widening": (lambda: Bottleneck(16, 8), 16, 9),
    "stem": (_Stem, 3, 20),
    "extra_layer": (lambda: ExtraLayer(24, 12, 16), 24, 11),
    "ssh_context": (lambda: _SSH(16, 32), 16, 10),
    "retina_conv_bn_relu": (lambda: conv_bn(16, 24), 16, 10),
    "retina_conv_bn_1x1": (lambda: conv_bn(16, 24, 1), 16, 10),
    "retina_ssh_over_cat": (lambda: SSH(32, 32), 32, 10),
}


@pytest.mark.parametrize("kind", sorted(CHAINS))
def test_folded_chain_equals_the_modules_in_float64(kind):
    make, cin, side = CHAINS[kind]
    module = _seeded(make().double())
    folding = fused.fold(module)
    assert folding is not None and folding.entries
    x = torch.randn(2, cin, side, side, dtype=torch.float64,
                    generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        want = module(x)
        with fused.active(folding):
            got = module(x)
    assert got.shape == want.shape
    assert torch.allclose(got, want, rtol=0, atol=1e-10), (got - want).abs().max()


def test_retina_ssh_is_biubug6s_relu_over_the_concatenation():
    """RetinaFace's SSH, unfolded, takes the ReLU in each branch: equal, bit
    for bit, to biubug6's ReLU after the concatenation of its three
    conv_bn_no_relu branches (conv → BatchNorm)."""
    ssh = _seeded(SSH(32, 32).double())
    x = torch.randn(2, 32, 10, 10, dtype=torch.float64)

    def no_relu(m, y):
        return m[1](m[0](y))

    with torch.no_grad():
        t = ssh.conv5X5_1(x)
        want = torch.relu(torch.cat([no_relu(ssh.conv3X3, x), no_relu(ssh.conv5X5_2, t),
                                     no_relu(ssh.conv7x7_3, ssh.conv7X7_2(t))], dim=1))
        got = ssh(x)
    assert (want == 0).any() and (want > 0).any()
    assert torch.equal(got, want)


def test_downsample_runs_bare_with_its_bias_in_the_last_conv():
    block = _seeded(Bottleneck(32, 16, stride=2).double())
    folding = fused.fold(block)
    ds, last = folding.entries[block.downsample[0]], folding.entries[block.conv3]
    assert ds.bare and last.carried is ds
    x = torch.randn(1, 32, 9, 9, dtype=torch.float64)
    with torch.no_grad(), fused.active(folding):
        sc = fused.conv_bn(*block.downsample, x, relu=False)
        bare = nn.functional.conv2d(x, ds.weight, None, 2)
    assert torch.equal(sc, bare)


def test_folding_leaves_the_model_as_it_was():
    """state_dict keys, values and every tensor's storage are unchanged;
    the folded copies are outside parameters() and buffers()."""
    model = _seeded(RetinaFace())
    before = {k: (v.clone(), v.data_ptr()) for k, v in model.state_dict().items()}
    n_params, n_buffers = len(list(model.parameters())), len(list(model.buffers()))
    folding = fused.fold(model)
    after = model.state_dict()
    assert list(after) == list(before)
    for k, v in after.items():
        assert torch.equal(v, before[k][0]) and v.data_ptr() == before[k][1], k
    assert len(list(model.parameters())) == n_params
    assert len(list(model.buffers())) == n_buffers
    owned = {t.data_ptr() for t in [*model.parameters(), *model.buffers()]}
    copies = [e.weight for e in folding.entries.values() if e.weight is not None]
    assert copies and not any(t.data_ptr() in owned for t in copies)


def test_train_mode_runs_the_modules():
    block = _seeded(Bottleneck(32, 16, stride=2))
    folding = fused.fold(block)
    block.train()
    x = torch.randn(4, 32, 8, 8)
    fused.fused_convs.reset()
    with torch.no_grad(), fused.active(folding):
        block(x)
    assert fused.fused_convs.count == 0


@pytest.mark.parametrize("device,dtype,quant,folds", [
    ("cuda", torch.bfloat16, None, True),
    ("cuda", torch.float16, None, False),
    ("cuda", torch.float32, None, False),
    ("cuda", torch.bfloat16, "int8", False),
    ("cpu", torch.bfloat16, None, False),
    ("cpu", torch.float32, None, False),
])
def test_which_detectors_fold(device, dtype, quant, folds):
    assert fused.applies(torch.device(device), dtype, quant) is folds


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cpu_detectors_keep_the_modules(dtype):
    det = PyramidBoxDetector(build_pyramidbox("try1").eval(), "try1", dtype=dtype, device="cpu")
    assert det._folds == {}


def test_int8_convs_are_not_folded():
    """An int8 flagship's convs are Int8Conv2d: none of its chains folds,
    and a plain conv beside one still does."""
    stem = int8_convs(_seeded(_Stem()))
    assert type(stem.conv1) is Int8Conv2d
    assert fused.fold(stem) is None
    context = _SSH(16, 32)
    assert fused.fold(context) is not None
    int8_convs(context)
    assert fused.fold(context) is None
    block = _seeded(Bottleneck(64, 16))
    block.conv2 = int8_convs(block.conv2)
    folding = fused.fold(block)
    assert set(folding.entries) == {block.conv1, block.conv3}


@pytest.mark.parametrize("assign", [False, True])
def test_load_in_place_folds_again_before_the_next_forward(assign):
    """An in-place load_state_dict (select_checkpoint's), or one that
    assigns new tensors: refresh() folds again, into the same storage, and
    the folded forward is the new weights' modules' forward."""
    model = _seeded(ExtraLayer(24, 12, 16).double(), seed=0)
    new = _seeded(ExtraLayer(24, 12, 16).double(), seed=5).state_dict()
    folding = fused.fold(model)
    entry = folding.entries[model[0]]
    ptrs = entry.weight.data_ptr(), entry.bias.data_ptr()
    assert folding.refresh() is False
    model.load_state_dict(new, assign=assign)
    assert folding.refresh() is True
    assert (entry.weight.data_ptr(), entry.bias.data_ptr()) == ptrs
    assert folding.refresh() is False
    x = torch.randn(1, 24, 9, 9, dtype=torch.float64)
    with torch.no_grad():
        want = model(x)
        with fused.active(folding):
            got = model(x)
    assert torch.allclose(got, want, rtol=0, atol=1e-10)


def test_a_model_built_in_inference_mode_is_not_folded():
    """Its parameters are inference tensors, which keep no version: a load
    in place could not be seen, so it keeps its modules."""
    with torch.inference_mode():
        model = ExtraLayer(8, 4, 8).eval()
    assert fused.fold(model) is None


def test_a_single_statistic_changed_in_place_is_seen():
    block = _seeded(Bottleneck(32, 16, stride=2).double())
    folding = fused.fold(block)
    with torch.no_grad():
        block.downsample[1].running_mean.add_(0.25)  # reaches conv3's epilogue bias
    assert folding.refresh() is True
    x = torch.randn(1, 32, 9, 9, dtype=torch.float64)
    with torch.no_grad():
        want = block(x)
        with fused.active(folding):
            got = block(x)
    assert torch.allclose(got, want, rtol=0, atol=1e-10)


class _Depthwise(nn.Module):
    """A depthwise conv → BatchNorm → ReLU that declares its chain."""

    def __init__(self, channels: int):
        super().__init__()
        self.conv = conv(channels, channels, 3, 1, 1, groups=channels, bias=False)
        self.bn = batch_norm(channels)

    def conv_chains(self):
        return [(self.conv, self.bn)]


def test_grouped_convs_and_try1_keep_their_batchnorms():
    """A depthwise chain is not folded (the rule is by conv type: groups 1),
    and try1 declares no chain: its ReLU6 blocks, depthwise convs, stem and
    SSH keep their modules."""
    assert fused.fold(_seeded(_Depthwise(16))) is None
    assert fused.fold(build_pyramidbox("try1").eval()) is None


# variant → (fused_convs, bn_unfused) of one folded forward: the flagship's
# stem, 16 bottlenecks × 3, 2 extra layers × 2 and 6 SSH × 5; RetinaFace's
# stem, 48, FPN 5 and SSH 3 × 5; try1 folds nothing: its 41 BatchNorms run
COUNTS = {"repo": (83, 0), "retina": (69, 0), "try1": (0, 41)}


@pytest.mark.parametrize("variant", sorted(COUNTS))
def test_counters_read_what_each_model_folds(variant):
    model = RetinaFace() if variant == "retina" else build_pyramidbox(variant)
    model = _seeded(model)
    folding = fused.fold(model)
    x = torch.randn(1, 3, 64, 64)
    with torch.no_grad():
        fused.fused_convs.reset()
        fused.bn_unfused.reset()
        want = model(x)
        n_bn = fused.bn_unfused.count
        with fused.active(folding):
            got = model(x)
    assert fused.fused_convs.count == COUNTS[variant][0]
    assert fused.bn_unfused.count - n_bn == COUNTS[variant][1]
    for k in ("face_loc", "face_conf"):
        assert torch.allclose(got[k], want[k], rtol=1e-4, atol=1e-4), k
