"""Modules of the port (counterpart of ``papc_tpu.nn``)."""

from papc_tpu_torch.nn.layers import (BN_EPS, BN_MOMENTUM, BatchNorm, MLPHead,
                                      PointMLP, SegHead, TNet,
                                      global_max_pool)
from papc_tpu_torch.nn.pointnet2 import (FeaturePropagation, SetAbstraction,
                                         SetAbstractionMsg)

__all__ = ["BN_EPS", "BN_MOMENTUM", "BatchNorm", "FeaturePropagation",
           "MLPHead", "PointMLP", "SegHead", "SetAbstraction",
           "SetAbstractionMsg", "TNet", "global_max_pool"]
