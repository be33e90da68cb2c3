"""Dataset loaders of the port (counterpart of ``papc_tpu.data``)."""

from papc_tpu_torch.data.prefetch import prefetch_to_device
from papc_tpu_torch.data.shapenet import Batch, ShapeNetLoader
from papc_tpu_torch.data.synthetic import SyntheticLoader, make_cloud

__all__ = ["Batch", "ShapeNetLoader", "SyntheticLoader", "make_cloud",
           "prefetch_to_device"]
