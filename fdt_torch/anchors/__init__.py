from fdt_torch.anchors.densified import facebox_default_boxes
from fdt_torch.anchors.priors import (feature_map_sizes, prior_grid,
                                      pyramid_face_priors, pyramid_head_priors,
                                      retina_priors)

__all__ = ["prior_grid", "pyramid_face_priors", "pyramid_head_priors",
           "feature_map_sizes", "facebox_default_boxes", "retina_priors"]
