"""Boundaries of the port: what it imports, how its kernels bind, and
that nothing in it hides the device or the build."""

import ast
import ctypes
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from papc_tpu_torch import _build
from papc_tpu_torch.ops.kernels import (ball_query, fps, gather, nms, samlp,
                                        samlp_train, scatter_rows)

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "papc_tpu_torch"
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax", "papc_tpu"}
KERNEL_MODULES = (fps, ball_query, gather, samlp)
TRAINING_KERNELS = (gather.SCATTER_KERNEL, *samlp_train.KERNELS,
                    scatter_rows.KERNEL)
NMS_KERNELS = nms.KERNELS


def _imported_roots(path: Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__")
              and node.args and isinstance(node.args[0], ast.Constant)):
            roots.add(str(node.args[0].value).split(".")[0])
    return roots


@pytest.mark.parametrize(
    "path", sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"],
    ids=lambda p: str(p.relative_to(ROOT)))
def test_port_never_imports_jax_flax_or_the_jax_package(path):
    assert not _imported_roots(path) & FORBIDDEN


def test_package_import_loads_no_jax_and_builds_nothing():
    code = ("import sys, papc_tpu_torch, papc_tpu_torch.train, "
            "papc_tpu_torch.train.trainer, papc_tpu_torch.__main__, "
            "papc_tpu_torch.ops.fused_mlp, papc_tpu_torch.detect.train, "
            "papc_tpu_torch.detect.builders, papc_tpu_torch.ops.nms, "
            "papc_tpu_torch.data.synthetic_kitti, "
            "papc_tpu_torch.models.segment, papc_tpu_torch.ops.interpolate; "
            "from papc_tpu_torch import _build; "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'flax', 'papc_tpu', 'h5py', 'triton')); "
            "print(bad, _build.library.cache_info().currsize)")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "[] 0"


_C_TYPES = {"int": ctypes.c_int, "float": ctypes.c_float}


def _exported_signatures() -> dict[str, list]:
    """``PAPC_EXPORT int name(params)`` of every csrc/*.cu → ctypes types."""
    sigs = {}
    for src in PORT.glob("csrc/*.cu"):
        for name, params in re.findall(
                r"PAPC_EXPORT\s+int\s+(\w+)\s*\(([^)]*)\)", src.read_text()):
            types = []
            for p in " ".join(params.split()).split(","):
                p = p.strip()
                types.append(ctypes.c_void_p if "*" in p
                             else _C_TYPES[p.split()[0]])
            sigs[name] = types
    return sigs


@pytest.mark.parametrize("mod", KERNEL_MODULES, ids=lambda m: m.__name__)
def test_ctypes_argtypes_match_the_c_entry_points(mod):
    """A pointer declared as anything but c_void_p would be cut to 32
    bits, and a missing argument shifts every later one: the wrapper's
    argtypes must be the C signature, parameter by parameter."""
    sigs = _exported_signatures()
    assert mod.KERNEL.symbol in sigs
    assert mod.KERNEL.argtypes == sigs[mod.KERNEL.symbol]
    assert mod.KERNEL.argtypes[-1] is ctypes.c_void_p  # the stream


@pytest.mark.parametrize("kernel", TRAINING_KERNELS, ids=lambda k: k.symbol)
def test_ctypes_argtypes_of_the_training_kernels(kernel):
    """The same check for the training path's entry points (the two
    scatter-adds and the four stream passes)."""
    sigs = _exported_signatures()
    assert kernel.argtypes == sigs[kernel.symbol]
    assert kernel.argtypes[-1] is ctypes.c_void_p


@pytest.mark.parametrize("kernel", NMS_KERNELS, ids=lambda k: k.symbol)
def test_ctypes_argtypes_of_the_nms_kernels(kernel):
    """The same check for the detection path's two NMS sweeps (a bool
    array is a pointer, the threshold a C float)."""
    sigs = _exported_signatures()
    assert kernel.argtypes == sigs[kernel.symbol]
    assert kernel.argtypes[-1] is ctypes.c_void_p
    assert ctypes.c_float in kernel.argtypes


def test_every_c_entry_point_has_a_wrapper():
    wrapped = {m.KERNEL.symbol for m in KERNEL_MODULES}
    wrapped |= {k.symbol for k in TRAINING_KERNELS + NMS_KERNELS}
    assert set(_exported_signatures()) == wrapped


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD_ROOT", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build()


def test_library_path_is_keyed_by_sources_and_flags(monkeypatch):
    a = _build.library_path()
    assert a == _build.library_path()
    assert a.parent.parent == _build.BUILD_ROOT and a.name == _build.LIB_NAME
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
    monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS + ["-G"])
    assert _build.library_path() != a
    assert {"fps.cu", "ball_query.cu", "group_gather.cu", "samlp_eval.cu",
            "group_scatter_add.cu", "samlp_linear_stats.cu",
            "samlp_finalize_seed.cu", "samlp_bwd_layer.cu",
            "samlp_train.cuh", "nms_greedy.cu", "nms_rotate.cu",
            "scatter_rows_add.cu"} <= {
                p.name for p in _build.sources()}


def test_kernel_error_raises_and_is_not_counted(monkeypatch):
    class FakeLib:
        def __init__(self, err):
            self.err = err
            self.papc_error_string = lambda e: b"invalid argument"

        def __getattr__(self, name):
            return lambda *args: self.err

    k = _build.Kernel("papc_fake", [ctypes.c_int])
    monkeypatch.setattr(_build, "library", lambda: FakeLib(1))
    with pytest.raises(RuntimeError, match="papc_fake: CUDA error 1"):
        k(3)
    assert k.launches == 0
    monkeypatch.setattr(_build, "library", lambda: FakeLib(0))
    k(3)
    assert k.launches == 1


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_fails_without_a_card(tmp_path, alone):
    """No CUDA here: the smoke script must exit non-zero and print no
    result line, in the checkout and alone in an empty directory."""
    cwd = ROOT
    if alone:
        shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
        cwd = tmp_path
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
