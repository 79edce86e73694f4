from fdt_torch.models.facebox import FaceBox
from fdt_torch.models.inception_resnet_v2 import InceptionResnetV2
from fdt_torch.models.loader import (from_jax_variables, load_facebox_detector,
                                     load_mtcnn_cascade, load_mtcnn_files, load_mtcnn_nets,
                                     load_npz, load_pyramidbox, load_pyramidbox_detector,
                                     load_retinaface, load_retinaface_detector,
                                     load_weights_file, save_variables_pth)
from fdt_torch.models.mtcnn import ONet, PNet, RNet
from fdt_torch.models.pyramidbox import PyramidBox
from fdt_torch.models.pyramidbox_mobile import (PyramidBoxMobileV1,
                                                PyramidBoxMobileV2,
                                                build_pyramidbox)
from fdt_torch.models.retinaface import RetinaFace
from fdt_torch.models.torch_convert import (load_reference_state_dict, load_torch_state_dict,
                                            reference_state_dict)

__all__ = ["PyramidBox", "PyramidBoxMobileV1", "PyramidBoxMobileV2", "FaceBox",
           "PNet", "RNet", "ONet", "InceptionResnetV2", "build_pyramidbox",
           "from_jax_variables", "load_npz", "load_pyramidbox", "load_pyramidbox_detector",
           "load_facebox_detector", "load_mtcnn_nets", "load_mtcnn_files",
           "load_mtcnn_cascade", "load_weights_file", "save_variables_pth",
           "load_torch_state_dict", "load_reference_state_dict", "reference_state_dict",
           "RetinaFace", "load_retinaface", "load_retinaface_detector"]
