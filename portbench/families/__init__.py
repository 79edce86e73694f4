"""What a configuration is built from, on both sides: one module a model
family, in a file named as the family (`<family>.py`), which a
configuration's file names under "family".  A family module provides

  build(cell, quant=None)  the program's detector for the configuration
                           (fdt_torch), in its dtype on the cell's card;
                           `quant` switches on a lower-precision path
                           of the program's own (the control)
  reference(cell)          the plain reference (portbench/reference/),
                           called as ref(frames_u8, head) → one result an
                           image (portbench.reference.detect.ImageResult)
  flops_per_image(cell)    the network's operations for one image at the
                           cell's size, counted from the reference's
                           frozen architecture
  SERVICE                  the detector's name in fdt_torch's
                           DetectionService
"""
from __future__ import annotations

import importlib
import importlib.util
import re

FAMILY = re.compile(r"^[A-Za-z][A-Za-z0-9_]*$")


def load(family: str):
    """The module of a family, or None when there is none."""
    if not FAMILY.match(family) or importlib.util.find_spec(f"{__name__}.{family}") is None:
        return None
    return importlib.import_module(f"{__name__}.{family}")
