"""PyramidBox training (counterpart of fdt/train: the MultiBox loss, the SGD
trainer, checkpoints and the driver)."""
from fdt_torch.train.checkpoint import (latest_checkpoint, restore_checkpoint,
                                        save_checkpoint)
from fdt_torch.train.loops import (LossHistory, PyramidTrainer, pad_targets,
                                   sgd_optimizer, xavier_init)
from fdt_torch.train.multibox_loss import (MultiBoxLossConfig, multibox_loss,
                                           multibox_loss_from_targets)

__all__ = ["multibox_loss", "multibox_loss_from_targets", "MultiBoxLossConfig",
           "PyramidTrainer", "LossHistory", "sgd_optimizer", "pad_targets", "xavier_init",
           "save_checkpoint", "restore_checkpoint", "latest_checkpoint"]
