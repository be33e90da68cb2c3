"""Classifiers of the port (counterpart of ``papc_tpu.models.classify``)."""

from papc_tpu_torch.models.classify.pointnet2 import (PointNet2MSGClas,
                                                      PointNet2SSGClas)

__all__ = ["PointNet2MSGClas", "PointNet2SSGClas"]
