"""Dataset loaders of the port (counterpart of ``papc_tpu.data``)."""

from papc_tpu_torch.data.dispatch import make_dataloader
from papc_tpu_torch.data.kd import KDBatch, KDLoader, build_kd_tree
from papc_tpu_torch.data.prefetch import prefetch_to_device
from papc_tpu_torch.data.shapenet import Batch, ShapeNetLoader
from papc_tpu_torch.data.synthetic import SyntheticLoader, make_cloud
from papc_tpu_torch.data.voxel import (VoxBatch, VoxelFileLoader,
                                       VoxelLoader, rasterize)

__all__ = ["Batch", "KDBatch", "KDLoader", "ShapeNetLoader",
           "SyntheticLoader", "VoxBatch", "VoxelFileLoader", "VoxelLoader",
           "build_kd_tree", "make_cloud", "make_dataloader",
           "prefetch_to_device", "rasterize"]
