"""The plain float32 reference that decides `correct`: PyramidBox-ResNet50
and the MobileNet "try1" (pyramidbox.py), their priors, decode, greedy NMS
and rows (detect.py).  It reads the weights npz itself and imports nothing
of fdt_torch, fdt or JAX."""
