"""fdt_torch and chip_smoke.py run where there is no jax, flax or cv2: they
import none of those, nor anything of the JAX package fdt.  Checked on the
sources with ast, so that `fdt_torch` is not mistaken for `fdt`."""
import ast
import pathlib

import pytest
import torch

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parent.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax", "cv2", "fdt"}
SOURCES = sorted((REPO / "fdt_torch").rglob("*.py")) + [REPO / "chip_smoke.py",
                                                      REPO / "profile_nms.py"]


def imported_roots(path: pathlib.Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            roots |= {alias.name.split(".")[0] for alias in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
              and node.func.attr == "import_module" and node.args
              and isinstance(node.args[0], ast.Constant)):
            roots.add(str(node.args[0].value).split(".")[0])
    return roots


def test_sources_found():
    assert len(SOURCES) > 10
    assert imported_roots(REPO / "fdt" / "geometry" / "nms.py") >= {"jax", "fdt"}


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_flax_cv2_or_fdt_import(path):
    assert not imported_roots(path) & FORBIDDEN


def test_every_module_imports_without_building_kernels():
    """Importing builds and loads nothing: a kernel is built at first launch."""
    import importlib
    import pkgutil

    import fdt_torch
    from fdt_torch.ops import _build
    names = [m.name for m in pkgutil.walk_packages(fdt_torch.__path__, "fdt_torch.")]
    assert {"fdt_torch.ops.nms", "fdt_torch.apps.serving", "fdt_torch.infer.facebox",
            "fdt_torch.models.facebox", "fdt_torch.models.pyramidbox_mobile",
            "fdt_torch.anchors.densified", "fdt_torch.models.mtcnn",
            "fdt_torch.infer.mtcnn_device", "fdt_torch.track.iou_tracker",
            "fdt_torch.track.device_tracker", "fdt_torch.track.fused",
            "fdt_torch.ops.track", "fdt_torch.geometry.track", "fdt_torch.infer.mtcnn",
            "fdt_torch.data.frames", "fdt_torch.track.display", "fdt_torch.apps.video",
            "fdt_torch.cli.track_video", "fdt_torch.cli.track_display",
            "fdt_torch.cli.video_demo", "fdt_torch.ops.quant", "fdt_torch.geometry.matching",
            "fdt_torch.train.multibox_loss", "fdt_torch.train.loops",
            "fdt_torch.train.checkpoint", "fdt_torch.train.driver", "fdt_torch.utils.watchdog",
            "fdt_torch.data.resize", "fdt_torch.data.augment", "fdt_torch.data.widerface",
            "fdt_torch.cli.train_pyramid", "fdt_torch.train.facebox_train",
            "fdt_torch.train.net2net", "fdt_torch.train.mtcnn_train",
            "fdt_torch.data.mtcnn_data", "fdt_torch.cli.train_facebox",
            "fdt_torch.cli.train_net2net", "fdt_torch.cli.train_mtcnn",
            "fdt_torch.cli.gen_mtcnn_data", "fdt_torch.models.torch_convert",
            "fdt_torch.models.inception_resnet_v2", "fdt_torch.cli.train_chained",
            "fdt_torch.cli.export_weights", "fdt_torch.cli.select_checkpoint",
            "fdt_torch.cli.gen_anno", "fdt_torch.utils.visualize"} <= set(names)
    for name in names:
        importlib.import_module(name)
    assert _build._lib is None
