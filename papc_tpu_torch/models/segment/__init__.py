"""Part segmentation models of the port (counterpart of
``papc_tpu.models.segment``)."""

from papc_tpu_torch.models.segment.pointnet2 import (PointNet2MSGSeg,
                                                     PointNet2SSGSeg)

__all__ = ["PointNet2MSGSeg", "PointNet2SSGSeg"]
