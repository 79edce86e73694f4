from fdt_torch.models.facebox import FaceBox
from fdt_torch.models.loader import (from_jax_variables, load_facebox_detector,
                                     load_mtcnn_cascade, load_mtcnn_nets,
                                     load_npz, load_pyramidbox,
                                     load_pyramidbox_detector)
from fdt_torch.models.mtcnn import ONet, PNet, RNet
from fdt_torch.models.pyramidbox import PyramidBox
from fdt_torch.models.pyramidbox_mobile import (PyramidBoxMobileV1,
                                                PyramidBoxMobileV2,
                                                build_pyramidbox)

__all__ = ["PyramidBox", "PyramidBoxMobileV1", "PyramidBoxMobileV2", "FaceBox",
           "PNet", "RNet", "ONet", "build_pyramidbox", "from_jax_variables", "load_npz",
           "load_pyramidbox", "load_pyramidbox_detector", "load_facebox_detector",
           "load_mtcnn_nets", "load_mtcnn_cascade"]
