"""What the benchmark loads: nothing whose top-level module is jax, jaxlib,
flax or fdt (the JAX package; fdt_torch, the port, is a name of its own),
and the reference nothing of the port either."""
import subprocess
import sys

from portbench.tests.conftest import REPO

PROBE = """
import sys
sys.path.insert(0, {root!r})
{imports}
import json
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def _top_level_modules(imports: str) -> set:
    out = subprocess.run([sys.executable, "-c", PROBE.format(root=str(REPO), imports=imports)],
                         capture_output=True, text=True, check=True, timeout=300,
                         env={"PATH": "/usr/bin:/bin", "USE_FLAX": "0"})
    import json
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_harness_and_metrics_load_no_jax_and_no_fdt():
    mods = _top_level_modules(
        "import pathlib, importlib, importlib.util\n"
        "import portbench.harness, portbench.check, portbench.tools.calibrate\n"
        "import portbench.tools.sweep\n"
        "for d in ('entries', 'families'):\n"
        "    for p in sorted(pathlib.Path(portbench.harness.__file__).parent.glob(d + '/*.py')):\n"
        "        importlib.import_module(f'portbench.{d}.{p.stem}')\n"
        "from fdt_torch.apps.serving import DetectionService\n"
        "from fdt_torch.models.loader import load_pyramidbox_detector\n"
        "for p in sorted(pathlib.Path(portbench.harness.__file__).parent.glob('metrics/*.py')):\n"
        "    s = importlib.util.spec_from_file_location('m_' + p.stem, p)\n"
        "    s.loader.exec_module(importlib.util.module_from_spec(s))\n")
    assert "fdt_torch" in mods and "portbench" in mods
    assert not mods & {"jax", "jaxlib", "flax", "fdt"}


def test_reference_loads_nothing_of_the_port():
    mods = _top_level_modules("import portbench.reference.pyramidbox, portbench.reference.detect")
    assert not mods & {"jax", "jaxlib", "flax", "fdt", "fdt_torch"}


def test_harness_names_jax_or_fdt_when_loaded():
    from portbench import harness
    saved = sys.modules.get("fdt")
    sys.modules["fdt"] = type(sys)("fdt")
    try:
        assert "fdt" in harness.forbidden_modules()
    finally:
        if saved is None:
            del sys.modules["fdt"]
        else:
            sys.modules["fdt"] = saved
    assert "fdt_torch" not in harness.forbidden_modules()
