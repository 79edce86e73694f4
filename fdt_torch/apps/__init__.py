from fdt_torch.apps.serving import DetectionService, MicroBatcher

__all__ = ["DetectionService", "MicroBatcher"]
