"""Modules of the port (counterpart of ``papc_tpu.nn``)."""

from papc_tpu_torch.nn.layers import BN_EPS, BN_MOMENTUM, BatchNorm, MLPHead, PointMLP
from papc_tpu_torch.nn.pointnet2 import SetAbstraction

__all__ = ["BN_EPS", "BN_MOMENTUM", "BatchNorm", "MLPHead", "PointMLP",
           "SetAbstraction"]
