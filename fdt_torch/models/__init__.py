from fdt_torch.models.loader import from_jax_variables, load_npz, load_pyramidbox
from fdt_torch.models.pyramidbox import PyramidBox

__all__ = ["PyramidBox", "from_jax_variables", "load_npz", "load_pyramidbox"]
