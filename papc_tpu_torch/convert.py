"""flax variables → the port's ``state_dict``, and back.

The port's modules carry the flax tree's names, so a flax leaf
``params/SetAbstraction_0/PointMLP_0/Dense_0/kernel`` is the tensor
``SetAbstraction_0.PointMLP_0.Dense_0.weight``. Per leaf:

- Dense ``kernel [in, out]`` → Linear ``weight [out, in]``; ``bias`` → ``bias``;
- Conv ``kernel [kh, kw, in, out]`` (HWIO) → Conv2d ``weight [out, in, kh,
  kw]`` (OIHW);
- Conv ``kernel [kd, kh, kw, in, out]`` (DHWIO) → Conv3d ``weight [out,
  in, kd, kh, kw]`` (OIDHW);
- ConvTranspose ``kernel [s, s, in, out]`` → ConvTranspose2d ``weight [in,
  out, s, s]``, mirrored: ``weight[c, o, p, q] = kernel[s-1-p, s-1-q, c, o]``,
  because ``lax.conv_transpose`` applies the kernel mirrored where
  ``conv_transpose2d`` does not; and ``kernel [s, in, out]`` →
  ConvTranspose1d ``weight [in, out, s]``, ``weight[c, o, p] =
  kernel[s-1-p, c, o]``;
- BatchNorm ``scale`` / ``bias`` → ``weight`` / ``bias``;
- ``batch_stats`` ``mean`` / ``var`` → ``running_mean`` / ``running_var``.

A source is either the nested variables dict (``{"params": ..., "batch_stats":
...}``, leaves as numpy or jax arrays) or a flat ``.npz`` whose keys are
the ``/``-joined paths. The conversion fails on any key it cannot place,
any tensor it does not fill, and any shape that does not match.
"""

from __future__ import annotations

from collections.abc import Mapping
from pathlib import Path

import numpy as np
import torch
from torch import nn

_PARAM_LEAVES = {"bias": "bias", "scale": "weight"}
_STAT_LEAVES = {"mean": "running_mean", "var": "running_var"}


def flatten(variables: Mapping, prefix: str = "") -> dict[str, np.ndarray]:
    """Nested flax variables → ``{"params/A/B/kernel": array, ...}``."""
    flat = {}
    for name, value in variables.items():
        key = f"{prefix}/{name}" if prefix else str(name)
        if isinstance(value, Mapping):
            flat.update(flatten(value, key))
        else:
            flat[key] = np.asarray(value)
    return flat


def _torch_key(flax_key: str, value: np.ndarray) -> tuple[str, np.ndarray]:
    collection, *path, leaf = flax_key.split("/")
    if collection == "params" and leaf == "kernel":
        name = "weight"
        transposed = bool(path) and path[-1].startswith("ConvTranspose")
        if value.ndim == 2:
            value = value.T
        elif value.ndim == 3 and transposed:
            value = value[::-1].transpose(1, 2, 0)
        elif value.ndim == 4 and transposed:
            value = value[::-1, ::-1].transpose(2, 3, 0, 1)
        elif value.ndim == 4:
            value = value.transpose(3, 2, 0, 1)
        elif value.ndim == 5 and not transposed:
            value = value.transpose(4, 3, 0, 1, 2)
        else:
            raise KeyError(f"{flax_key}: a {value.ndim}-D kernel has no "
                           "counterpart in the port")
    elif collection == "params" and leaf in _PARAM_LEAVES:
        name = _PARAM_LEAVES[leaf]
    elif collection == "batch_stats" and leaf in _STAT_LEAVES:
        name = _STAT_LEAVES[leaf]
    else:
        raise KeyError(f"{flax_key}: no counterpart in the port")
    return ".".join([*path, name]), value


def flax_to_state_dict(source, model: nn.Module) -> dict[str, torch.Tensor]:
    """Map flax variables (nested dict, flat dict or ``.npz`` path) onto
    ``model``'s ``state_dict`` keys, checking coverage and shapes."""
    if isinstance(source, (str, Path)):
        with np.load(source) as npz:
            flat = {k: npz[k] for k in npz.files}
    elif any(isinstance(v, Mapping) for v in source.values()):
        flat = flatten(source)
    else:
        flat = dict(source)
    want = model.state_dict()
    out, unused = {}, []
    for flax_key, value in flat.items():
        try:
            key, value = _torch_key(flax_key, np.asarray(value))
        except KeyError:
            unused.append(flax_key)
            continue
        if key not in want or value.ndim != want[key].dim():
            # a kernel of another rank (a 5-D Conv where the port's is 2-D)
            # has no counterpart there
            unused.append(flax_key)
            continue
        if tuple(value.shape) != tuple(want[key].shape):
            raise ValueError(
                f"{flax_key}: shape {value.shape} does not fit {key} "
                f"{tuple(want[key].shape)}"
            )
        out[key] = torch.from_numpy(np.array(value, dtype=np.float32))
    missing = sorted(set(want) - set(out))
    if unused or missing:
        raise KeyError(
            f"flax → torch: unused flax keys {sorted(unused)}, "
            f"tensors left unfilled {missing}"
        )
    return out


def load_flax_weights(model: nn.Module, source) -> nn.Module:
    """Fill ``model`` in place from flax variables; returns the model."""
    model.load_state_dict(flax_to_state_dict(source, model), strict=True)
    return model


def _flax_kernel(module: str, weight: np.ndarray) -> np.ndarray:
    if weight.ndim == 2:  # Dense
        return weight.T
    if module.startswith("ConvTranspose") and weight.ndim == 3:
        return np.ascontiguousarray(weight.transpose(2, 0, 1)[::-1])
    if module.startswith("ConvTranspose"):
        return np.ascontiguousarray(weight.transpose(2, 3, 0, 1)[::-1, ::-1])
    if weight.ndim == 5:  # Conv3d: OIDHW → DHWIO
        return weight.transpose(2, 3, 4, 1, 0)
    return weight.transpose(2, 3, 1, 0)  # Conv: OIHW → HWIO


def state_dict_to_flax(state_dict: Mapping[str, torch.Tensor]) -> dict[str, np.ndarray]:
    """The inverse mapping: ``state_dict`` → flat flax keys, ready for
    ``np.savez``. The weights of ``Dense_*``, ``Conv_*`` and
    ``ConvTranspose_*`` modules are kernels."""
    flat = {}
    for key, t in state_dict.items():
        *path, name = key.split(".")
        arr = t.detach().cpu().numpy()
        if name in ("running_mean", "running_var"):
            leaf = "mean" if name == "running_mean" else "var"
            flat["/".join(["batch_stats", *path, leaf])] = arr
        elif path[-1].startswith(("Dense", "Conv")):
            leaf = "kernel" if name == "weight" else name
            flat["/".join(["params", *path, leaf])] = (
                _flax_kernel(path[-1], arr) if name == "weight" else arr)
        else:
            leaf = "scale" if name == "weight" else name
            flat["/".join(["params", *path, leaf])] = arr
    return flat


# the fields of optax's optimizer state → the state keys of the port's
# optimizer of the same rule (``detect.builders.build_optimizer``):
# Adam's ``ScaleByAdamState``, SGD's ``TraceState``, RMSProp's
# ``ScaleByRmsState`` and ``TraceState``; every chain's ``count``
OPTAX_FIELDS = {
    "Adam": {"mu": "exp_avg", "nu": "exp_avg_sq"},
    "SGD": {"trace": "momentum_buffer"},
    "RMSProp": {"nu": "nu", "trace": "trace"},
}


def _optax_fields(opt_state) -> dict:
    """``{"count", <field>: tree}`` of an optax state: a dict with those
    keys, or the nested state of an optax chain (its NamedTuples' fields;
    Adam's count and the schedule's are the same)."""
    if isinstance(opt_state, Mapping):
        return dict(opt_state)
    fields = {}
    for s in _walk_tuples(opt_state):
        for name in getattr(s, "_fields", ()):
            if name in ("count", "mu", "nu", "trace"):
                fields.setdefault(name, getattr(s, name))
    return fields


def _walk_tuples(tree):
    yield tree
    if isinstance(tree, tuple) and not hasattr(tree, "_fields"):
        for child in tree:
            yield from _walk_tuples(child)


def optimizer_state_from_optax(model: nn.Module, opt: torch.optim.Optimizer,
                               opt_state, scheduler=None) -> None:
    """Fill ``opt`` (over ``model.parameters()``: Adam, SGD or the port's
    RMSProp) with optax's state of the same rule: each field's tree (flat
    flax param keys ``A/B/kernel`` or nested) onto the parameter's state
    key (``OPTAX_FIELDS``; Dense kernels transposed, as the weights are),
    ``count`` onto Adam's ``step`` and onto ``scheduler``'s count. Both
    packages then continue the same run."""
    fields = _optax_fields(opt_state)
    count = int(np.asarray(fields["count"]))
    names = OPTAX_FIELDS[type(opt).__name__]
    moments = {}
    for field, name in names.items():
        for flax_key, value in flatten(fields[field]).items():
            key, value = _torch_key(f"params/{flax_key}", np.asarray(value))
            moments.setdefault(key, {})[name] = value
    params = dict(model.named_parameters())
    if set(moments) != set(params):
        raise KeyError(
            f"optax → torch: moments without a parameter "
            f"{sorted(set(moments) - set(params))}, parameters without "
            f"moments {sorted(set(params) - set(moments))}")
    for key, p in params.items():
        state = {}
        if type(opt).__name__ == "Adam":
            state["step"] = torch.tensor(float(count), dtype=torch.float32)
        for name, value in moments[key].items():
            if tuple(value.shape) != tuple(p.shape):
                raise ValueError(f"{key}: {name} shape {value.shape} does "
                                 f"not fit {tuple(p.shape)}")
            state[name] = torch.from_numpy(
                np.array(value, dtype=np.float32)).to(p.device)
        opt.state[p] = state
    if scheduler is not None:
        scheduler.set_count(count)


def optimizer_state_to_optax(model: nn.Module, opt: torch.optim.Optimizer,
                             scheduler=None) -> dict:
    """The inverse of :func:`optimizer_state_from_optax`: ``{"count",
    <field>: {flat param key: array}}``, numpy f32 leaves and ``count``
    int32 (``scheduler``'s count where given, else Adam's ``step``). A
    parameter that has not been stepped has zero moments, as optax's
    ``init`` gives."""
    names = OPTAX_FIELDS[type(opt).__name__]
    count = 0 if scheduler is None else scheduler.last_epoch
    out = {field: {} for field in names}
    for key, p in model.named_parameters():
        state = opt.state.get(p, {})
        if scheduler is None and "step" in state:
            count = int(float(state["step"]))
        for field, name in names.items():
            value = state.get(name)
            value = torch.zeros_like(p) if value is None else value
            (flax_key, arr), = state_dict_to_flax({key: value}).items()
            out[field][flax_key.split("/", 1)[1]] = arr.astype(np.float32)
    out["count"] = np.asarray(count, np.int32)
    return out
