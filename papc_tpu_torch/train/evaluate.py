"""Offline evaluation: the serving path of the port
(counterpart of ``papc_tpu/train/trainer.py::evaluate`` and ``eval_step``).

The model runs in eval mode under :func:`torch.inference_mode` on an
explicit device: running BatchNorm statistics, no dropout, so the logits
are a deterministic function of the weights and the input. Weights come
from a checkpoint of the trainer (``checkpoint_path``, or the latest one
under ``model_dir``, as JAX's ``evaluate`` finds it), or from flax
variables (a nested dict or a flat ``.npz``, see
:mod:`papc_tpu_torch.convert`).

The model's inputs follow its ``input_kind`` and ``mode``, as JAX's
``model_inputs`` gives them: ``(voxels,)``, ``(points, split_dims)`` for
the kd-tree models, ``(points, label)`` for part segmentation, else
``(points,)``. Classification scores ``label`` by accuracy, part
segmentation the per-point ``pid`` by mean IoU. The default loader is
:func:`~papc_tpu_torch.data.make_dataloader`'s for the model.
"""

from __future__ import annotations

from collections.abc import Callable, Mapping
from pathlib import Path

import numpy as np
import torch

from papc_tpu_torch.convert import load_flax_weights
from papc_tpu_torch.models import init_model
from papc_tpu_torch.train import metrics as M


def batch_dict(raw) -> dict:
    """A loader ``Batch`` namedtuple or dict → dict without ``None``s."""
    if isinstance(raw, Mapping):
        return dict(raw)
    return {k: v for k, v in raw._asdict().items() if v is not None}


def _tensor(value, device: torch.device) -> torch.Tensor:
    if isinstance(value, torch.Tensor):
        return value.to(device)
    return torch.as_tensor(np.asarray(value), device=device)


def batch_tensor(batch: dict, key: str, device: torch.device):
    """``batch[key]`` as a tensor on ``device`` (a tensor already there,
    as the prefetch leaves it, is returned as it is); a tuple or list of
    arrays, as ``split_dims``, as a tuple of tensors."""
    value = batch[key]
    if isinstance(value, (tuple, list)):
        return tuple(_tensor(v, device) for v in value)
    return _tensor(value, device)


def model_inputs(model, batch: dict, device: torch.device) -> tuple:
    """The positional inputs of ``model`` (a model or its ``ModelSpec``:
    anything with ``input_kind`` and ``mode``) for a batch."""
    if model.input_kind == "voxel":
        keys = ("voxels",)
    elif model.input_kind == "kd":
        keys = ("points", "split_dims")
    elif model.mode == "seg":
        keys = ("points", "label")
    else:
        keys = ("points",)
    return tuple(batch_tensor(batch, k, device) for k in keys)


def targets_of(mode: str, batch: dict, device: torch.device) -> torch.Tensor:
    """``pid [B, N]`` for segmentation, else ``label [B]``."""
    return batch_tensor(batch, "pid" if mode == "seg" else "label", device)


def metric_of(model: torch.nn.Module, logits: torch.Tensor,
              targets: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Mean IoU over the model's parts for segmentation, else accuracy."""
    if model.mode == "seg":
        return M.mean_iou(logits, targets, model.num_parts, mask)
    return M.accuracy(logits, targets, mask)


def metric_name(mode: str) -> str:
    return "miou" if mode == "seg" else "accuracy"


def eval_step(model: torch.nn.Module, batch: dict, device: torch.device,
              impl: str | None = None):
    """One batch: ``(logits, loss, metric)`` on ``device``, loss and
    metric over the rows ``batch["mask"]`` marks valid."""
    inputs = model_inputs(model, batch, device)
    targets = targets_of(model.mode, batch, device)
    mask = batch_tensor(batch, "mask", device)
    with torch.inference_mode():
        logits = model(*inputs, impl=impl)
        loss = M.softmax_cross_entropy(logits, targets, mask)
        metric = metric_of(model, logits, targets, mask)
    return logits, loss, metric


def evaluate(
    model_name: str = "pointnet_basic",
    mode: str = "clas",
    max_point: int = 1024,
    num_classes: int = 16,
    num_parts: int = 50,
    batchsize: int = 32,
    path: str = "./dataset/",
    weights: str | Path | Mapping | None = None,
    split: str = "test",
    make_loader: Callable | None = None,
    *,
    checkpoint_path: str | None = None,
    model_dir: str = "./model",
    device: str | torch.device = "cuda",
    impl: str | None = None,
    log: Callable[[str], None] = print,
) -> dict:
    """Evaluate a model on a ShapeNet split: flax ``weights``, else the
    checkpoint at ``checkpoint_path``, else the latest
    ``{model_dir}/{model_name}_<epoch>`` checkpoint (logged; with none
    there, ``FileNotFoundError``, as in JAX).

    ``make_loader(split)`` returns an epoch callable yielding batches
    (default: :func:`~papc_tpu_torch.data.make_dataloader`'s loader over
    ``path`` for the model, with the part labels in ``seg`` mode).
    ``impl`` is passed to every op
    of the forward: ``None`` runs the CUDA kernels on a CUDA device and
    the plain versions on the CPU.

    Returns ``{"loss", "accuracy" | "miou", "num_samples", "logits"}``;
    ``logits`` holds the valid rows of every batch in loader order, on
    the CPU (``[n, classes]``, or ``[n, N, parts]`` for segmentation).
    """
    if weights is None:
        from papc_tpu_torch.train.trainer import (checkpoint_variables,
                                                  latest_checkpoint_path,
                                                  read_checkpoint)

        if checkpoint_path is None:
            # the latest trainer checkpoint: scoring a freshly initialised
            # model would be no evaluation
            checkpoint_path = latest_checkpoint_path(model_name, model_dir)
            if checkpoint_path is None:
                raise FileNotFoundError(
                    f"no {model_dir}/{model_name}_<epoch> checkpoint found "
                    "— train first or pass --checkpoint explicitly")
            log(f"eval: restoring latest checkpoint {checkpoint_path}")
        weights = checkpoint_variables(read_checkpoint(checkpoint_path))
    device = torch.device(device)
    if make_loader is None:
        from papc_tpu_torch.data import make_dataloader

        def make_loader(split_):
            return make_dataloader(model_name, max_point, batchsize, path,
                                   mode, split_)

    spec = init_model(model_name, mode, num_classes, num_parts, max_point,
                      device=device)
    model = load_flax_weights(spec.model, weights).to(device)
    losses, metrics, counts, kept = [], [], [], []
    for raw in make_loader(split)():
        batch = batch_dict(raw)
        logits, loss, metric = eval_step(model, batch, device, impl)
        valid = batch_tensor(batch, "mask", device)
        w = float(valid.sum())
        losses.append(float(loss) * w)
        metrics.append(float(metric) * w)
        counts.append(w)
        kept.append(logits[valid].cpu())
    total = max(sum(counts), 1.0)
    result = {
        "loss": sum(losses) / total,
        metric_name(mode): sum(metrics) / total,
        "num_samples": int(total),  # 1 on an empty split, as in JAX
    }
    log(f"eval[{split}]: " + ", ".join(
        f"{k}={v:.6f}" if isinstance(v, float) else f"{k}={v}"
        for k, v in result.items()
    ))
    empty = (0, max_point, num_parts) if mode == "seg" else (0, num_classes)
    result["logits"] = torch.cat(kept) if kept else torch.zeros(empty)
    return result
