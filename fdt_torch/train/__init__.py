"""Training (counterpart of fdt/train: the MultiBox loss, the PyramidBox and
FaceBoxes SGD trainers, checkpoints and the driver; net2net and the MTCNN
stage trainers in their modules)."""
from fdt_torch.train.checkpoint import (latest_checkpoint, restore_checkpoint,
                                        save_checkpoint)
from fdt_torch.train.facebox_train import FaceBoxTrainer
from fdt_torch.train.loops import (LossHistory, PyramidTrainer, pad_targets,
                                   sgd_optimizer, xavier_init)
from fdt_torch.train.multibox_loss import (MultiBoxLossConfig, multibox_loss,
                                           multibox_loss_from_targets)

__all__ = ["multibox_loss", "multibox_loss_from_targets", "MultiBoxLossConfig",
           "PyramidTrainer", "FaceBoxTrainer", "LossHistory", "sgd_optimizer", "pad_targets",
           "xavier_init", "save_checkpoint", "restore_checkpoint", "latest_checkpoint"]
