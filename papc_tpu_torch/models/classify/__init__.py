"""Classifiers of the port (counterpart of ``papc_tpu.models.classify``)."""

from papc_tpu_torch.models.classify.kdnet import KDNet
from papc_tpu_torch.models.classify.pointnet import (PointNetClas,
                                                     PointNetConv2DClas)
from papc_tpu_torch.models.classify.pointnet2 import (PointNet2MSGClas,
                                                      PointNet2SSGClas)
from papc_tpu_torch.models.classify.pointnet_basic import PointNetBasicClas
from papc_tpu_torch.models.classify.vfe import VFEClas
from papc_tpu_torch.models.classify.voxnet import VoxNet

__all__ = ["KDNet", "PointNet2MSGClas", "PointNet2SSGClas",
           "PointNetBasicClas", "PointNetClas", "PointNetConv2DClas",
           "VFEClas", "VoxNet"]
