"""Loader dispatch (counterpart of ``papc_tpu/data/dispatch.py``): the
loader family of a (model_name, mode) combo comes from the registry's
``input_kind``, so every registered model is loadable."""

from __future__ import annotations

from papc_tpu_torch.data.kd import KDLoader
from papc_tpu_torch.data.shapenet import ShapeNetLoader
from papc_tpu_torch.data.voxel import VoxelLoader
from papc_tpu_torch.models.registry import input_kind


def make_dataloader(model_name: str, max_point: int, batchsize: int,
                    path: str = "./data/", mode1: str = "clas",
                    mode2: str = "train", seed: int = 0):
    """The loader of split ``mode2`` for ``model_name`` in mode ``mode1``
    (part labels in ``seg`` mode); unknown modes and names raise JAX's
    ``SystemExit`` messages."""
    if mode1 not in ("clas", "seg"):
        raise SystemExit('Error: mode should be "clas", "detect" or "seg"')
    kind = input_kind(model_name, mode1)
    if kind == "voxel":
        return VoxelLoader(path, mode2, max_point, batchsize, seed=seed)
    if kind == "kd":
        return KDLoader(path, mode2, max_point, batchsize,
                        with_pid=mode1 == "seg", seed=seed)
    return ShapeNetLoader(path, mode2, max_point, batchsize,
                          with_pid=mode1 == "seg", seed=seed)
