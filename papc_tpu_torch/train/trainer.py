"""Training of the port (counterpart of ``papc_tpu/train/trainer.py``).

The same public ``train(...)`` as the JAX package (minus ``scan_steps``,
see ``ROADMAP.md``), the same Adam with L2 added to the gradient before
the Adam step, the same masked loss and log lines, a val pass per
epoch, and a checkpoint every ``save_iter`` epochs. Each training batch
is copied to the device inside its step, where JAX's ``train`` feeds
them through ``prefetch_to_device``, which costs the port's host-bound
step (``data/prefetch.py``).

The model trains in place on an explicit device, eagerly: one
``train_step`` is the forward in train mode (batch statistics, dropout
from an explicit ``torch.Generator``, running statistics updated as flax
does), the backward through the port's kernels on a CUDA device (their
plain versions on the CPU), and one optimizer step. ``precision="bf16"``
is JAX's bf16 step (``make_train_step``): the forward and backward run
on bf16 copies of the f32 parameters and of the batch's float arrays,
the loss is taken in f32, and the parameters, Adam's moments and the
BatchNorm running statistics stay f32.

A checkpoint is JAX's layout without Orbax: one directory
``{model_dir}/{name}_{epoch}`` a save (so JAX's ``name_(\\d+)`` discovery
finds it), holding one ``numpy.savez`` file of flat keys: ``params/...``
and ``batch_stats/...`` (flax variables,
:func:`papc_tpu_torch.convert.state_dict_to_flax`), ``opt_state/count``,
``opt_state/mu/...`` and ``opt_state/nu/...`` (optax's
``ScaleByAdamState`` fields, :func:`~papc_tpu_torch.convert.optimizer_state_to_optax`)
and ``step``. ``restore_checkpoint`` loads all four; ``evaluate`` serves
the latest one. As in JAX, ``train()`` does not resume.
"""

from __future__ import annotations

import os
import re
import shutil
import time
from collections.abc import Callable, Sequence

import numpy as np
import torch

from papc_tpu_torch.convert import (load_flax_weights,
                                    optimizer_state_from_optax,
                                    optimizer_state_to_optax,
                                    state_dict_to_flax)
from papc_tpu_torch.models import init_model
from papc_tpu_torch.train import metrics as M
from papc_tpu_torch.train.evaluate import (batch_dict, batch_tensor,
                                           eval_step, metric_name, metric_of,
                                           model_inputs, targets_of)
from papc_tpu_torch.train.precision import (bf16_call, cast_floating,
                                             is_bf16)

CHECKPOINT_FILE = "checkpoint.npz"  # the one file of a checkpoint directory


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
               dropout_masks: Sequence[torch.Tensor] | None = None,
               precision: str = "fp32"):
    """One step on ``batch``: ``(loss, metric)`` as 0-d tensors on
    ``device``, the loss over the rows ``batch["mask"]`` marks valid; the
    metric is the accuracy, or the mean IoU over the parts for a
    segmentation model (``model.mode``).

    The gradients stay in the parameters' ``.grad`` after the step.
    Dropout masks come from ``generator``, or from ``dropout_masks``.
    ``precision="bf16"`` runs the forward and backward on bf16 casts of
    the parameters and of the batch's float arrays (JAX's ``loss_fn``);
    the parameters take their gradients in f32, the BatchNorm running
    statistics update in place in f32, and the loss is taken on the f32
    logits. Any other precision than ``"fp32"`` or ``"bf16"`` raises
    ``ValueError``.
    """
    bf16 = is_bf16(precision)
    inputs = model_inputs(model, batch, device)
    targets = targets_of(model.mode, batch, device)
    mask = batch_tensor(batch, "mask", device)
    model.train()
    kwargs = {"impl": impl, "generator": generator,
              "dropout_masks": dropout_masks}
    if bf16:
        mask = cast_floating(mask, torch.bfloat16)
        logits = bf16_call(model, *inputs, **kwargs)
    else:
        logits = model(*inputs, **kwargs)
    loss = M.softmax_cross_entropy(logits.float(), targets, mask)
    opt.zero_grad(set_to_none=True)
    loss.backward()
    opt.step()
    with torch.no_grad():
        metric = metric_of(model, logits, targets, mask)
    return loss.detach(), metric


def save_checkpoint(model: torch.nn.Module, opt: torch.optim.Optimizer,
                    model_dir: str, name: str, epoch: int,
                    step: int) -> str:
    """Write ``{model_dir}/{name}_{epoch}`` (see the module docstring):
    the model's variables, Adam's state and ``step``. The directory is
    written under a temporary name and renamed into place, so a
    checkpoint of the same name is replaced whole, as Orbax's
    ``force=True`` save replaces it. Returns its absolute path."""
    path = os.path.abspath(os.path.join(model_dir, f"{name}_{epoch}"))
    os.makedirs(os.path.dirname(path), exist_ok=True)
    adam = optimizer_state_to_optax(model, opt)
    arrays = dict(state_dict_to_flax(model.state_dict()))
    arrays["opt_state/count"] = adam["count"]
    for part in ("mu", "nu"):
        arrays.update({f"opt_state/{part}/{k}": v
                       for k, v in adam[part].items()})
    arrays["step"] = np.asarray(step, np.int32)
    tmp = f"{path}.tmp-{os.getpid()}"
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    np.savez(os.path.join(tmp, CHECKPOINT_FILE), **arrays)
    old = None
    if os.path.exists(path):
        old = f"{path}.old-{os.getpid()}"
        os.replace(path, old)
    os.replace(tmp, path)
    if old is not None:
        shutil.rmtree(old)
    return path


def latest_checkpoint_path(name: str,
                           model_dir: str = "./model") -> str | None:
    """The highest-epoch ``{model_dir}/{name}_<epoch>`` entry, or None
    (JAX's ``latest_checkpoint_path``: other names are ignored)."""
    best, best_epoch = None, -1
    if not os.path.isdir(model_dir):
        return None
    for entry in os.listdir(model_dir):
        m = re.fullmatch(re.escape(name) + r"_(\d+)", entry)
        if m and int(m.group(1)) > best_epoch:
            best_epoch = int(m.group(1))
            best = os.path.join(model_dir, entry)
    return best


def read_checkpoint(path: str) -> dict[str, np.ndarray]:
    """The flat arrays of a checkpoint directory (no pickles)."""
    with np.load(os.path.join(path, CHECKPOINT_FILE),
                 allow_pickle=False) as npz:
        return {k: npz[k] for k in npz.files}


def checkpoint_variables(arrays: dict) -> dict[str, np.ndarray]:
    """The flax variables (``params/...``, ``batch_stats/...``) of a
    checkpoint's arrays."""
    return {k: v for k, v in arrays.items()
            if k.startswith(("params/", "batch_stats/"))}


def restore_checkpoint(model: torch.nn.Module, opt: torch.optim.Optimizer,
                       path: str) -> int:
    """Load a checkpoint's variables into ``model`` and its Adam state
    into ``opt`` (``make_optimizer`` over ``model.parameters()``);
    returns its ``step``."""
    arrays = read_checkpoint(path)
    load_flax_weights(model, checkpoint_variables(arrays))
    adam = {"count": arrays["opt_state/count"]}
    for part in ("mu", "nu"):
        prefix = f"opt_state/{part}/"
        adam[part] = {k[len(prefix):]: v for k, v in arrays.items()
                      if k.startswith(prefix)}
    optimizer_state_from_optax(model, opt, adam)
    return int(arrays["step"])


def train(
    model_name: str = "pointnet_basic",
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
    precision: str = "fp32",
    device: str | torch.device = "cuda",
    impl: str | None = None,
    log: Callable[[str], None] = print,
):
    """Train a model of the registry; returns ``(model, history)``.

    ``make_loader(split)`` returns an epoch callable yielding batches
    (default: :func:`~papc_tpu_torch.data.make_dataloader`'s loader over
    ``path`` for the model, the train split shuffled by ``RandomState(0)``
    whatever ``seed`` is, as in JAX, with the part labels in ``seg``
    mode). Weights start from ``seed``; dropout draws from a CPU
    ``torch.Generator`` seeded with ``seed``. ``history`` holds one dict
    per epoch: ``epoch``, ``epoch_time`` (s, host clock, synchronized),
    ``train_loss`` (every step's loss), ``val_loss`` and ``val_metric``
    (the accuracy, or the mean IoU in ``seg`` mode). ``precision``: the
    step's, ``"fp32"`` or ``"bf16"`` (:func:`train_step`); the val pass
    runs in f32 either way, as JAX's ``eval_step`` does. Every
    ``save_iter`` epochs a checkpoint is written (:func:`save_checkpoint`).
    """
    is_bf16(precision)  # an unknown precision raises before any work
    device = torch.device(device)
    if make_loader is None:
        from papc_tpu_torch.data import make_dataloader

        def make_loader(split):  # shuffled by RandomState(0), as in JAX
            return make_dataloader(model_name, max_point, batchsize, path,
                                   mode, split)

    train_loader, val_loader = make_loader("train"), make_loader("val")
    model = init_model(model_name, mode, num_classes, num_parts, max_point,
                       seed=seed, device=device).model
    opt = make_optimizer(model.parameters(), learning_rate, weight_decay)
    generator = torch.Generator().manual_seed(seed)
    history = []
    name = metric_name(mode)
    step = 0
    for epoch in range(epoch_num):
        log("=" * 35 + "train" + "=" * 43)
        t0 = time.time()
        losses = []
        for batch_id, raw in enumerate(train_loader()):
            loss, metric = train_step(model, opt, batch_dict(raw), device,
                                      generator, impl, precision=precision)
            step += 1
            losses.append(loss)
            if batch_id % info_iter == 0:
                log(f"epoch: {epoch}, batch_id: {batch_id}, "
                    f"loss is: [{float(loss):.6f}], "
                    f"{name} is: [{float(metric):.6f}]")
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        epoch_time = time.time() - t0

        if epoch % save_iter == 0:
            save_checkpoint(model, opt, model_dir, model_name, epoch, step)

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
