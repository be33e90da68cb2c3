"""The port's row scatter-add (#5), its differentiable ``index_points``,
the multi-scale set abstraction and the PointNet++ MSG classifier's
serving path and weights against the JAX package, on the CPU (its
training step: ``tests/test_torch_msg_train.py``).

Inputs are numpy arrays from one seed, weights come from flax through
``convert``. The JAX side runs as its own suite runs on the CPU: the
Pallas scatter with ``interpret=True``, ``jax.vjp`` of its row gather,
the classic flax path or ``fused_mlp.override(enable=True, impl="jnp")``.
The port runs its plain versions (no card here). Tolerances are stated
at each test.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from papc_tpu.models.classify import PointNet2MSGClas as JaxMSG
from papc_tpu.nn import SetAbstractionMsg as JaxSAMsg
from papc_tpu.ops import geometry as jgeom
from papc_tpu.ops.pallas.scatter import scatter_rows_add_pallas

from papc_tpu_torch.convert import flatten, state_dict_to_flax
from papc_tpu_torch.models import init_model
from papc_tpu_torch.models.classify import PointNet2MSGClas
from papc_tpu_torch.nn import SetAbstractionMsg
from papc_tpu_torch.ops import geometry
from papc_tpu_torch.ops.kernels import scatter_rows

from tests import torch_parity as P

T = torch.from_numpy


# ------------------------------------------------- #5, the row scatter-add

def _indices(kind, rs, B, R, n):
    if kind == "random":
        return rs.randint(0, n, (B, R))
    if kind == "duplicates":  # ball-query padding: a group's first index
        idx = rs.randint(0, n, (B, R // 8, 1)).repeat(8, axis=2)
        idx[..., 5:] = rs.randint(0, 4, idx[..., 5:].shape)
        return idx.reshape(B, -1)
    idx = rs.randint(-3, n + 3, (B, R))  # out of range: contributes nothing
    idx[:, :4] = [-1, n, n + 100, -n]
    return idx


@pytest.mark.parametrize("kind", ["random", "duplicates", "out_of_range"])
@pytest.mark.parametrize("C", [3, 131, 323])
def test_scatter_rows_add_matches_pallas_and_numpy(kind, C):
    """The plain version against ``scatter_rows_add_pallas(interpret=True)``
    and ``np.add.at`` over the in-range rows: within rtol 1e-5, atol 1e-6,
    as ``tests/test_pallas_scatter.py`` holds the Pallas kernel (sums in
    another order; the Pallas one through a three-plane bf16 split)."""
    rs = np.random.RandomState(C)
    B, R, n = 2, 200, 37
    g = rs.randn(B, R, C).astype(np.float32)
    idx = _indices(kind, rs, B, R, n).astype(np.int32)
    want = np.zeros((B, n, C), np.float64)
    for b in range(B):
        ok = (idx[b] >= 0) & (idx[b] < n)
        np.add.at(want[b], idx[b][ok], g[b][ok])
    got = scatter_rows.scatter_rows_add(T(g), T(idx), n)
    assert got.dtype == torch.float32 and got.shape == (B, n, C)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    pallas = scatter_rows_add_pallas(jnp.asarray(g), jnp.asarray(idx), n,
                                     interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(pallas), rtol=1e-5,
                               atol=1e-6)


def test_scatter_rows_add_takes_bf16_gradients():
    """A bf16 ``g`` accumulates in f32, as the Pallas kernel's bf16 path:
    equal to the f32 scatter of the same (rounded) values within 1e-6."""
    rs = np.random.RandomState(1)
    g = torch.tensor(rs.randn(2, 64, 20), dtype=torch.bfloat16)
    idx = T(rs.randint(-1, 9, (2, 64)).astype(np.int32))
    got = scatter_rows.scatter_rows_add(g, idx, 9)
    assert got.dtype == torch.float32
    want = scatter_rows.scatter_rows_add(g.float(), idx, 9)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
    pallas = scatter_rows_add_pallas(jnp.asarray(g.float().numpy(),
                                                 jnp.bfloat16),
                                     jnp.asarray(idx.numpy()), 9,
                                     interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(pallas), rtol=1e-5,
                               atol=1e-6)


def test_index_points_gradient_matches_jax_vjp(monkeypatch):
    """``index_points`` forward equals JAX's (clamped indices), and its
    gradient, the row scatter-add, equals ``jax.vjp`` of
    ``papc_tpu.ops.geometry.index_points`` within 1e-6 (sums in another
    order). The scatter runs only when ``points`` wants a gradient."""
    rs = np.random.RandomState(2)
    pts = rs.randn(2, 40, 5).astype(np.float32)
    idx = rs.randint(-2, 42, (2, 6, 8)).astype(np.int32)
    g = rs.randn(2, 6, 8, 5).astype(np.float32)
    calls = []
    real = scatter_rows.scatter_rows_add
    monkeypatch.setattr(scatter_rows, "scatter_rows_add",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    tp = T(pts).requires_grad_()
    out = geometry.index_points(tp, T(idx))
    out.backward(T(g))
    want, vjp = jax.vjp(lambda p: jgeom.index_points(p, jnp.asarray(idx)),
                        jnp.asarray(pts))
    np.testing.assert_array_equal(out.detach().numpy(), np.asarray(want))
    np.testing.assert_allclose(tp.grad.numpy(),
                               np.asarray(vjp(jnp.asarray(g))[0]),
                               rtol=1e-6, atol=1e-6)
    assert calls == [1]
    data = T(pts).requires_grad_(False)
    geometry.index_points(data, T(idx)).sum()
    assert calls == [1]


# ----------------------------------------------------- the MSG modules

def _sa_msg_pair(rs):
    xyz = (0.5 * rs.randn(2, 512, 3)).astype(np.float32)
    pts = rs.randn(2, 512, 320).astype(np.float32)
    jsa = JaxSAMsg(128, (0.2, 0.4, 0.8), (32, 64, 128),
                   ((64, 64, 128), (128, 128, 256), (128, 128, 256)))
    variables = jax.jit(lambda a, b: jsa.init(jax.random.PRNGKey(0), a, b,
                                              train=False))(
        jnp.asarray(xyz), jnp.asarray(pts))
    variables = P.perturb_stats(variables, 3)
    sa = P.port_model(lambda: SetAbstractionMsg(
        128, (0.2, 0.4, 0.8), (32, 64, 128), 320,
        ((64, 64, 128), (128, 128, 256), (128, 128, 256))), variables)
    return xyz, pts, jsa, variables, sa


def test_set_abstraction_msg_matches_flax():
    """MSG classification's second stage at full width (B=2, 512 points
    with 320 features → 128 centres, three branches) in eval mode, f32
    operands, against flax's classic CPU path: the centres exactly, the
    concatenated features within 1e-4 (BN folded in another place, f32
    sums in another order). The branches' order in the concatenation and
    the features-first gather show here: both change every column."""
    rs = np.random.RandomState(4)
    xyz, pts, jsa, variables, sa = _sa_msg_pair(rs)
    want_xyz, want = jax.jit(lambda v, a, b: jsa.apply(v, a, b, train=False))(
        variables, jnp.asarray(xyz), jnp.asarray(pts))
    with P.fused_mlp.override(impl="plain", operand_dtype=torch.float32):
        with torch.inference_mode():
            got_xyz, got = sa.eval()(T(xyz), T(pts))
    np.testing.assert_array_equal(got_xyz.numpy(), np.asarray(want_xyz))
    assert got.shape == (2, 128, 640)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)


# --------------------------------------------------- the MSG classifier

@pytest.fixture(scope="module")
def msg_clas():
    b = P.batch(2, 512, seed=5)
    jmodel = JaxMSG(num_classes=16)
    variables = P.perturbed_variables(jmodel, "clas", b, 5)
    return b, jmodel, variables


def test_msg_clas_logits_match_jax(msg_clas):
    """Full width (1.74 M parameters), B=2 x 512 points, eval mode: f32
    operands against flax's classic CPU path within rtol 1e-4, atol
    1e-4; bf16 operands (the card's contract) against
    ``override(enable=True, impl="jnp")`` within rtol 1e-2, atol 1e-3, as
    the SSG slice (both round every activation to bf16)."""
    b, jmodel, variables = msg_clas
    model = P.port_model(lambda: PointNet2MSGClas(num_classes=16), variables)
    want = P.jax_eval(jmodel, "clas", variables, b)
    got = P.port_eval(model, "clas", b)
    assert got.shape == (2, 16) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    with pytest.MonkeyPatch.context() as mp:
        P.permissive_fused_gate(mp)
        with P.jfused.override(enable=True, impl="jnp"):
            want16 = P.jax_eval(jmodel, "clas", variables, b)
    got16 = P.port_eval(model, "clas", b, torch.bfloat16)
    np.testing.assert_allclose(got16, want16, rtol=1e-2, atol=1e-3)


def test_msg_clas_tree_round_trips(msg_clas):
    """flax → port → flax, leaf for leaf and bit for bit: the branches'
    ``SetAbstractionMsg_i/PointMLP_j`` and the inline head's top-level
    ``Dense_0``, ``BatchNorm_0``, ``Dense_1``, ``BatchNorm_1``,
    ``Dense_2``; the port's parameter count equals flax's."""
    _, _, variables = msg_clas
    flat = flatten(jax.tree_util.tree_map(np.asarray, variables))
    model = P.port_model(lambda: PointNet2MSGClas(num_classes=16), variables)
    back = state_dict_to_flax(model.state_dict())
    assert set(back) == set(flat)
    for key, value in flat.items():
        np.testing.assert_array_equal(back[key], value)
    for key in ("params/Dense_0/kernel", "params/BatchNorm_1/scale",
                "params/SetAbstractionMsg_1/PointMLP_2/Dense_0/kernel",
                "batch_stats/BatchNorm_0/var"):
        assert key in flat
    n_params = sum(p.numel() for p in model.parameters())
    assert n_params == sum(v.size for k, v in flat.items()
                           if k.startswith("params/")) == 1_741_200
    spec = init_model("pointnet2_msg", "clas", device="cpu")
    assert sum(p.numel() for p in spec.model.parameters()) == n_params
