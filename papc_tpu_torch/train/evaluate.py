"""Offline evaluation: the serving path of the port
(counterpart of ``papc_tpu/train/trainer.py::evaluate`` and ``eval_step``).

The model runs in eval mode under :func:`torch.inference_mode` on an
explicit device: running BatchNorm statistics, no dropout, so the logits
are a deterministic function of the weights and the input. Weights come
from flax variables (a nested dict or a flat ``.npz``, see
:mod:`papc_tpu_torch.convert`) in place of an Orbax checkpoint.

Classification takes ``points`` and scores ``label`` by accuracy; part
segmentation takes ``(points, label)`` and scores the per-point ``pid``
by mean IoU (``model_inputs`` / ``targets_of`` in the JAX trainer).
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


def batch_tensor(batch: dict, key: str,
                 device: torch.device) -> torch.Tensor:
    """``batch[key]`` as a tensor on ``device``."""
    return torch.as_tensor(np.asarray(batch[key]), device=device)


def model_inputs(mode: str, batch: dict, device: torch.device) -> tuple:
    """The model's positional inputs: ``(points,)``, or ``(points,
    label)`` for segmentation."""
    if mode == "seg":
        return (batch_tensor(batch, "points", device),
                batch_tensor(batch, "label", device))
    return (batch_tensor(batch, "points", device),)


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
    inputs = model_inputs(model.mode, batch, device)
    targets = targets_of(model.mode, batch, device)
    mask = batch_tensor(batch, "mask", device)
    with torch.inference_mode():
        logits = model(*inputs, impl=impl)
        loss = M.softmax_cross_entropy(logits, targets, mask)
        metric = metric_of(model, logits, targets, mask)
    return logits, loss, metric


def evaluate(
    model_name: str = "pointnet2_ssg",
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
    device: str | torch.device = "cuda",
    impl: str | None = None,
    log: Callable[[str], None] = print,
) -> dict:
    """Evaluate flax ``weights`` on a ShapeNet split.

    ``make_loader(split)`` returns an epoch callable yielding batches
    (default: :class:`~papc_tpu_torch.data.ShapeNetLoader` over ``path``,
    with the part labels in ``seg`` mode). ``impl`` is passed to every op
    of the forward: ``None`` runs the CUDA kernels on a CUDA device and
    the plain versions on the CPU.

    Returns ``{"loss", "accuracy" | "miou", "num_samples", "logits"}``;
    ``logits`` holds the valid rows of every batch in loader order, on
    the CPU (``[n, classes]``, or ``[n, N, parts]`` for segmentation).
    """
    if weights is None:
        raise ValueError(
            "evaluate needs weights: flax variables as a nested dict or a "
            "flat .npz (papc_tpu_torch.convert)"
        )
    device = torch.device(device)
    if make_loader is None:
        from papc_tpu_torch.data import ShapeNetLoader

        def make_loader(split_):
            return ShapeNetLoader(path, split_, max_point, batchsize,
                                  with_pid=mode == "seg")

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
        "num_samples": int(sum(counts)),
    }
    log(f"eval[{split}]: " + ", ".join(
        f"{k}={v:.6f}" if isinstance(v, float) else f"{k}={v}"
        for k, v in result.items()
    ))
    result["logits"] = (torch.cat(kept) if kept
                        else torch.zeros((0, num_classes)))
    return result
