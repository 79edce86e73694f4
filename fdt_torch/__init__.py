"""fdt_torch — the PyTorch/CUDA port of fdt for NVIDIA Hopper.

A second package beside `fdt` (the JAX reference, which it never imports).
Layering mirrors fdt's, bottom → top:
  fdt_torch.config    config dataclasses (a copy of fdt.config's PyramidBox,
                      FaceBoxes, MTCNN and tracker parts)
  fdt_torch.anchors   SSD priors and FaceBoxes default boxes (numpy, bit-equal
                      to fdt.anchors)
  fdt_torch.geometry  box algebra, the greedy-NMS fixpoint and nms_padded, the
                      tracker's slot state and plain greedy association
  fdt_torch.ops       hand-written CUDA kernels (built with nvcc, bound with ctypes)
  fdt_torch.models    nn.Module model zoo (NCHW: PyramidBox-ResNet50, the mobile
                      variants try1–try5, FaceBoxes, MTCNN's PNet/RNet/ONet) and
                      the flax-npz loader
  fdt_torch.infer     end-to-end detection (preprocess → forward → decode → NMS)
                      and the MTCNN device cascade
  fdt_torch.track     IoU tracking: the host tracker, the device association
                      (kernel K3 on the card) and fused detect + associate
  fdt_torch.apps      micro-batching DetectionService (pyramidbox, facebox, mtcnn)

Entry points run on the CUDA card unless the caller passes device="cpu".
"""

__version__ = "0.1.0"
