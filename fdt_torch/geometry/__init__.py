from fdt_torch.geometry.boxes import (center_size, decode, encode, intersect,
                                      iou_matrix, pair_distance, point_form)
from fdt_torch.geometry.matching import match_default, match_ensure_max_prior
from fdt_torch.geometry.nms import nms_keep_mask, nms_numpy, nms_padded

__all__ = ["point_form", "center_size", "intersect", "iou_matrix", "pair_distance",
           "encode", "decode", "nms_numpy", "nms_keep_mask", "nms_padded",
           "match_default", "match_ensure_max_prior"]
