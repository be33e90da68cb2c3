"""Indexed checkpoint manager (counterpart of
``papc_tpu/train/checkpoint.py``).

A ``checkpoints.json`` in the model directory maps each model name to
its latest checkpoint and to all kept ones, in the JAX package's schema
(``{"latest_ckpt": {name: "name-step"}, "all_ckpts": {name: [...]}}``).
Beyond ``max_to_keep`` the oldest saves go (``keep_latest``) or the
smallest steps. A checkpoint ``name-step`` is a directory holding one
flat ``numpy.savez`` file (no pickles): the model's parameters and BN
buffers under their flax keys (``params/...``, ``batch_stats/...``), the
optimizer's state in optax's form (``opt_state/count``,
``opt_state/<field>/...``) and ``step``. It is written under a
temporary name and renamed into place, with SIGINT held back until the
rename (:class:`DelayedKeyboardInterrupt`).
"""

from __future__ import annotations

import json
import os
import shutil
import signal

import numpy as np
import torch

from papc_tpu_torch.convert import (load_flax_weights,
                                    optimizer_state_from_optax,
                                    optimizer_state_to_optax,
                                    state_dict_to_flax)

CHECKPOINT_FILE = "checkpoint.npz"


class DelayedKeyboardInterrupt:
    """Make a checkpoint write SIGINT-atomic: Ctrl-C during the block is
    deferred until it completes."""

    def __enter__(self):
        self._received = None
        try:
            self._old = signal.signal(signal.SIGINT, self._handler)
        except ValueError:  # not the main thread: nothing to defer
            self._old = None
        return self

    def _handler(self, sig, frame):
        self._received = (sig, frame)

    def __exit__(self, *exc):
        if self._old is not None:
            signal.signal(signal.SIGINT, self._old)
            if self._received is not None:
                self._old(*self._received)
        return False


def _index_path(model_dir: str) -> str:
    return os.path.join(model_dir, "checkpoints.json")


def _load_index(model_dir: str) -> dict:
    p = _index_path(model_dir)
    if os.path.exists(p):
        with open(p) as f:
            return json.load(f)
    return {"latest_ckpt": {}, "all_ckpts": {}}


def _save_index(model_dir: str, index: dict) -> None:
    with open(_index_path(model_dir), "w") as f:
        json.dump(index, f, indent=2)


def latest_checkpoint(model_dir: str, model_name: str) -> str | None:
    """The path of ``model_name``'s latest checkpoint, or None."""
    ckpt = _load_index(model_dir)["latest_ckpt"].get(model_name)
    if ckpt is None:
        return None
    path = os.path.join(model_dir, ckpt)
    return path if os.path.exists(path) else None


def _write(path: str, arrays: dict) -> None:
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


def save(model_dir: str, model_name: str, arrays: dict, global_step: int,
         max_to_keep: int = 8, keep_latest: bool = True) -> str:
    """Write ``arrays`` (flat keys → numpy arrays) as ``model_name``'s
    checkpoint at ``global_step`` and update the index, dropping the
    checkpoints beyond ``max_to_keep``. Returns its absolute path."""
    os.makedirs(model_dir, exist_ok=True)
    name = f"{model_name}-{global_step}"
    path = os.path.abspath(os.path.join(model_dir, name))
    with DelayedKeyboardInterrupt():
        _write(path, arrays)

    index = _load_index(model_dir)
    all_ckpts = index["all_ckpts"].setdefault(model_name, [])
    all_ckpts.append(name)
    index["latest_ckpt"][model_name] = name
    if len(all_ckpts) > max_to_keep:
        if keep_latest:
            drop = all_ckpts[:len(all_ckpts) - max_to_keep]
            keep = all_ckpts[len(all_ckpts) - max_to_keep:]
        else:
            by_step = sorted(all_ckpts, key=lambda n: int(n.rsplit("-", 1)[1]))
            drop = by_step[:len(by_step) - max_to_keep]
            keep = [n for n in all_ckpts if n not in drop]
        for name_ in drop:
            p = os.path.join(model_dir, name_)
            if os.path.exists(p) and name_ not in keep:
                shutil.rmtree(p)
        index["all_ckpts"][model_name] = keep
    _save_index(model_dir, index)
    return path


def read(path: str) -> dict[str, np.ndarray]:
    """The flat arrays of a checkpoint directory."""
    with np.load(os.path.join(path, CHECKPOINT_FILE),
                 allow_pickle=False) as npz:
        return {k: npz[k] for k in npz.files}


def try_restore_latest(model_dir: str, model_name: str) -> dict | None:
    """The arrays of ``model_name``'s latest checkpoint, or None."""
    path = latest_checkpoint(model_dir, model_name)
    return None if path is None else read(path)


def training_arrays(model: torch.nn.Module, opt: torch.optim.Optimizer,
                    scheduler, step: int) -> dict[str, np.ndarray]:
    """A training state as checkpoint arrays: the model's variables, the
    optimizer's state (its count from ``scheduler``) and ``step``."""
    arrays = dict(state_dict_to_flax(model.state_dict()))
    opt_state = optimizer_state_to_optax(model, opt, scheduler)
    arrays["opt_state/count"] = opt_state.pop("count")
    for field, tree in opt_state.items():
        arrays.update({f"opt_state/{field}/{k}": v for k, v in tree.items()})
    arrays["step"] = np.asarray(step, np.int64)
    return arrays


def restore_training(arrays: dict, model: torch.nn.Module,
                     opt: torch.optim.Optimizer | None = None,
                     scheduler=None) -> int:
    """Load checkpoint ``arrays`` into ``model`` (and the optimizer's
    state into ``opt`` and ``scheduler`` where given); returns the step."""
    load_flax_weights(model, {k: v for k, v in arrays.items()
                              if k.startswith(("params/", "batch_stats/"))})
    if opt is not None:
        opt_state = {"count": arrays["opt_state/count"]}
        for key, value in arrays.items():
            if key.startswith("opt_state/") and key != "opt_state/count":
                field, flax_key = key[len("opt_state/"):].split("/", 1)
                opt_state.setdefault(field, {})[flax_key] = value
        optimizer_state_from_optax(model, opt, opt_state, scheduler)
    return int(arrays["step"])
