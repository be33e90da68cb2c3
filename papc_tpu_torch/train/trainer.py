"""Training of the port (counterpart of ``papc_tpu/train/trainer.py``).

The same public ``train(...)`` as the JAX package (minus ``precision``
and ``scan_steps``, see ``ROADMAP.md``), the same Adam with L2 added to
the gradient before the Adam step, the same masked loss and log lines,
a val pass per epoch, and a weights file every ``save_iter`` epochs.

The model trains in place on an explicit device, eagerly: one
``train_step`` is the forward in train mode (batch statistics, dropout
from an explicit ``torch.Generator``, running statistics updated as flax
does), the backward through the port's kernels on a CUDA device (their
plain versions on the CPU), and one optimizer step. A weights file is
the flat flax variables ``{model_dir}/{name}_{epoch}.npz``
(:func:`papc_tpu_torch.convert.state_dict_to_flax`), which
``evaluate(weights=...)`` and ``python -m papc_tpu_torch --evaluate``
serve. Optimizer state and resume are not saved yet.
"""

from __future__ import annotations

import os
import time
from collections.abc import Callable, Sequence

import numpy as np
import torch

from papc_tpu_torch.convert import state_dict_to_flax
from papc_tpu_torch.models import init_model
from papc_tpu_torch.train import metrics as M
from papc_tpu_torch.train.evaluate import (batch_dict, batch_tensor,
                                           eval_step, metric_name, metric_of,
                                           model_inputs, targets_of)


def make_optimizer(params, learning_rate: float,
                   weight_decay: float) -> torch.optim.Optimizer:
    """Adam with paddle-style L2: ``weight_decay·param`` is added to the
    gradient BEFORE the Adam moments, as ``optax.chain(add_decayed_weights,
    adam)`` does. This is ``torch.optim.Adam``'s ``weight_decay``, not
    AdamW's decoupled decay."""
    return torch.optim.Adam(params, lr=learning_rate,
                            weight_decay=weight_decay)


def train_step(model: torch.nn.Module, opt: torch.optim.Optimizer,
               batch: dict, device: torch.device,
               generator: torch.Generator | None = None,
               impl: str | None = None,
               dropout_masks: Sequence[torch.Tensor] | None = None):
    """One step on ``batch``: ``(loss, metric)`` as 0-d tensors on
    ``device``, the loss over the rows ``batch["mask"]`` marks valid; the
    metric is the accuracy, or the mean IoU over the parts for a
    segmentation model (``model.mode``).

    The gradients stay in the parameters' ``.grad`` after the step.
    Dropout masks come from ``generator``, or from ``dropout_masks``.
    """
    inputs = model_inputs(model.mode, batch, device)
    targets = targets_of(model.mode, batch, device)
    mask = batch_tensor(batch, "mask", device)
    model.train()
    logits = model(*inputs, impl=impl, generator=generator,
                   dropout_masks=dropout_masks)
    loss = M.softmax_cross_entropy(logits, targets, mask)
    opt.zero_grad(set_to_none=True)
    loss.backward()
    opt.step()
    with torch.no_grad():
        metric = metric_of(model, logits, targets, mask)
    return loss.detach(), metric


def _save(model: torch.nn.Module, model_dir: str, name: str,
          epoch: int) -> None:
    os.makedirs(model_dir, exist_ok=True)
    np.savez(os.path.join(model_dir, f"{name}_{epoch}.npz"),
             **state_dict_to_flax(model.state_dict()))


def train(
    model_name: str = "pointnet2_ssg",
    mode: str = "clas",
    max_point: int = 1024,
    num_classes: int = 16,
    num_parts: int = 50,
    learning_rate: float = 0.001,
    weight_decay: float = 0.001,
    epoch_num: int = 10,
    batchsize: int = 32,
    info_iter: int = 40,
    save_iter: int = 2,
    path: str = "./dataset/",
    model_dir: str = "./model/",
    seed: int = 0,
    make_loader: Callable | None = None,
    *,
    device: str | torch.device = "cuda",
    impl: str | None = None,
    log: Callable[[str], None] = print,
):
    """Train a model of the registry; returns ``(model, history)``.

    ``make_loader(split)`` returns an epoch callable yielding batches
    (default: :class:`~papc_tpu_torch.data.ShapeNetLoader` over ``path``,
    the train split shuffled by ``RandomState(0)`` whatever ``seed`` is,
    as the JAX package's ``make_dataloader`` does, with the part labels in
    ``seg`` mode). Weights start from ``seed``; dropout draws from a CPU
    ``torch.Generator`` seeded with ``seed``. ``history`` holds one dict
    per epoch: ``epoch``, ``epoch_time`` (s, host clock, synchronized),
    ``train_loss`` (every step's loss), ``val_loss`` and ``val_metric``
    (the accuracy, or the mean IoU in ``seg`` mode).
    """
    device = torch.device(device)
    if make_loader is None:
        from papc_tpu_torch.data import ShapeNetLoader

        def make_loader(split):  # shuffled by RandomState(0), as in JAX
            return ShapeNetLoader(path, split, max_point, batchsize,
                                  with_pid=mode == "seg")

    train_loader, val_loader = make_loader("train"), make_loader("val")
    model = init_model(model_name, mode, num_classes, num_parts, max_point,
                       seed=seed, device=device).model
    opt = make_optimizer(model.parameters(), learning_rate, weight_decay)
    generator = torch.Generator().manual_seed(seed)
    history = []
    name = metric_name(mode)
    for epoch in range(epoch_num):
        log("=" * 35 + "train" + "=" * 43)
        t0 = time.time()
        losses = []
        for batch_id, raw in enumerate(train_loader()):
            loss, metric = train_step(model, opt, batch_dict(raw), device,
                                      generator, impl)
            losses.append(loss)
            if batch_id % info_iter == 0:
                log(f"epoch: {epoch}, batch_id: {batch_id}, "
                    f"loss is: [{float(loss):.6f}], "
                    f"{name} is: [{float(metric):.6f}]")
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        epoch_time = time.time() - t0

        if epoch % save_iter == 0:
            _save(model, model_dir, model_name, epoch)

        log("=" * 35 + "val" + "=" * 45)
        model.eval()
        v_losses, v_metrics = [], []
        for batch_id, raw in enumerate(val_loader()):
            _, loss, metric = eval_step(model, batch_dict(raw), device, impl)
            v_losses.append(float(loss))
            v_metrics.append(float(metric))
            if batch_id % info_iter == 0:
                log(f"epoch: {epoch}, batch_id: {batch_id}, "
                    f"loss is: [{float(loss):.6f}], "
                    f"{name} is: [{float(metric):.6f}]")
        model.train()
        history.append({
            "epoch": epoch,
            "epoch_time": epoch_time,
            "train_loss": torch.stack(losses).tolist() if losses else [],
            "val_loss": sum(v_losses) / max(len(v_losses), 1),
            "val_metric": sum(v_metrics) / max(len(v_metrics), 1),
        })
    return model, history
