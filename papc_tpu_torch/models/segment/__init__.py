"""Part segmentation models of the port (counterpart of
``papc_tpu.models.segment``)."""

from papc_tpu_torch.models.segment.kdunet import KDUNet
from papc_tpu_torch.models.segment.pointnet import PointNetSeg
from papc_tpu_torch.models.segment.pointnet2 import (PointNet2MSGSeg,
                                                     PointNet2SSGSeg)
from papc_tpu_torch.models.segment.pointnet_basic import PointNetBasicSeg
from papc_tpu_torch.models.segment.vfe import VFESeg

__all__ = ["KDUNet", "PointNet2MSGSeg", "PointNet2SSGSeg",
           "PointNetBasicSeg", "PointNetSeg", "VFESeg"]
