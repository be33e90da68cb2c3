"""Offline evaluation: the serving path of the port
(counterpart of ``papc_tpu/train/trainer.py::evaluate`` and ``eval_step``).

The model runs in eval mode under :func:`torch.inference_mode` on an
explicit device: running BatchNorm statistics, no dropout, so the logits
are a deterministic function of the weights and the input. Weights come
from flax variables (a nested dict or a flat ``.npz``, see
:mod:`papc_tpu_torch.convert`) in place of an Orbax checkpoint.
"""

from __future__ import annotations

from collections.abc import Callable, Mapping
from pathlib import Path

import numpy as np
import torch

from papc_tpu_torch.convert import load_flax_weights
from papc_tpu_torch.models import init_model
from papc_tpu_torch.train import metrics as M


def _batch_dict(raw) -> dict:
    """A loader ``Batch`` namedtuple or dict → dict without ``None``s."""
    if isinstance(raw, Mapping):
        return dict(raw)
    return {k: v for k, v in raw._asdict().items() if v is not None}


def eval_step(model: torch.nn.Module, batch: dict, device: torch.device,
              impl: str | None = None):
    """One batch: ``(logits [B, classes], loss, accuracy)`` on ``device``,
    loss and accuracy over the rows ``batch["mask"]`` marks valid."""
    points = torch.as_tensor(np.asarray(batch["points"]), device=device)
    labels = torch.as_tensor(np.asarray(batch["label"]), device=device)
    mask = torch.as_tensor(np.asarray(batch["mask"]), device=device)
    with torch.inference_mode():
        logits = model(points, impl=impl)
        loss = M.softmax_cross_entropy(logits, labels, mask)
        acc = M.accuracy(logits, labels, mask)
    return logits, loss, acc


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
    (default: :class:`~papc_tpu_torch.data.ShapeNetLoader` over ``path``).
    ``impl`` is passed to every op of the forward: ``None`` runs the CUDA
    kernels on a CUDA device and the plain versions on the CPU.

    Returns ``{"loss", "accuracy", "num_samples", "logits"}``; ``logits``
    holds the valid rows of every batch in loader order, on the CPU.
    """
    if weights is None:
        raise ValueError(
            "evaluate needs weights: flax variables as a nested dict or a "
            "flat .npz (papc_tpu_torch.convert)"
        )
    if mode != "clas":
        raise NotImplementedError(
            f"mode {mode!r} is not ported yet (ROADMAP.md, Queue 1)")
    device = torch.device(device)
    if make_loader is None:
        from papc_tpu_torch.data import ShapeNetLoader

        def make_loader(split_):
            return ShapeNetLoader(path, split_, max_point, batchsize)

    spec = init_model(model_name, mode, num_classes, num_parts, max_point)
    model = load_flax_weights(spec.model, weights).to(device)
    losses, accs, counts, kept = [], [], [], []
    for raw in make_loader(split)():
        batch = _batch_dict(raw)
        logits, loss, acc = eval_step(model, batch, device, impl)
        valid = torch.as_tensor(np.asarray(batch["mask"]), device=device)
        w = float(valid.sum())
        losses.append(float(loss) * w)
        accs.append(float(acc) * w)
        counts.append(w)
        kept.append(logits[valid].cpu())
    total = max(sum(counts), 1.0)
    result = {
        "loss": sum(losses) / total,
        "accuracy": sum(accs) / total,
        "num_samples": int(sum(counts)),
    }
    log(f"eval[{split}]: " + ", ".join(
        f"{k}={v:.6f}" if isinstance(v, float) else f"{k}={v}"
        for k, v in result.items()
    ))
    result["logits"] = (torch.cat(kept) if kept
                        else torch.zeros((0, num_classes)))
    return result
