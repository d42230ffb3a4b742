"""The port's array-path kinematics and objective (ops/kinematics.py,
ops/objective.py) against the JAX package's, and against the port's own SoA
path.

Float64 on the CPU on both sides, inputs from a numpy seed, both Robots
built from one URDF (``ChainParams.from_spec`` on ``ChainSpec.from_arrays``
carries the JAX chain across unchanged).  FK and Jacobians: 1e-12 (the same
operations, summed in another order).  Gradients: 1e-9 against JAX and
against ``torch.autograd`` (the closed form and the differentiated log go
through different expressions of the same derivative).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from optik_tpu.ops import kinematics as JK
from optik_tpu.ops import objective as JO

from optik_tpu_torch.models.chain import ChainSpec
from optik_tpu_torch.ops import kinematics as K
from optik_tpu_torch.ops import objective as O
from optik_tpu_torch.ops import soa

from test_torch_port_models import EE_OFFSET, robots

MODELS = ["ur3e", "panda", "scara", "prismatic6"]
LIN_W = (0.0, 5.0, 0.25)
ANG_W = (0.005, 1.0, 0.99)
B = 16


def T(a):
    return torch.tensor(np.asarray(a), dtype=torch.float64)


def configurations(jr, seed, b=B):
    rng = np.random.default_rng(seed)
    return np.stack([jr.random_configuration(rng) for _ in range(b)])


def ee_pair():
    m = np.array(EE_OFFSET)
    return m[:3, :3], m[:3, 3]


@pytest.mark.parametrize("model", MODELS)
def test_chain_params_carry_across(model):
    jr, tr = robots(model)
    spec = ChainSpec.from_arrays(dataclasses.asdict(jr.spec))
    params = K.ChainParams.from_spec(spec, torch.float64, "cpu")
    assert params.num_positions == jr.num_positions()
    for name in params._fields:
        got = getattr(params, name)
        assert got.dtype == torch.float64
        np.testing.assert_array_equal(got.numpy(),
                                      np.asarray(getattr(jr.params, name)))
        assert torch.equal(got, getattr(tr.params, name))
    assert K.ChainParams.from_spec(spec).axis.dtype == torch.float32


@pytest.mark.parametrize("ee", [False, True], ids=["tip", "ee_offset"])
@pytest.mark.parametrize("model", MODELS)
def test_fk_and_jacobian_match_jax_and_soa(model, ee):
    jr, tr = robots(model)
    q = configurations(jr, 1)
    er, et = ee_pair() if ee else (None, None)
    jer, jet = (None, None) if not ee else (jnp.asarray(er), jnp.asarray(et))
    ter, tet = (None, None) if not ee else (T(er), T(et))

    r, t, jac = K.fk_and_jacobian(tr.params, T(q), ter, tet)
    assert r.shape == (B, 3, 3) and t.shape == (B, 3)
    assert jac.shape == (B, 6, jr.num_positions())
    ref = jax.vmap(lambda x: JK.fk_and_jacobian(jr.params, x, jer, jet))(
        jnp.asarray(q))
    for got, want in zip((r, t, jac), ref):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=1e-12)
    r2, t2 = K.fk_ee(tr.params, T(q), ter, tet)
    assert torch.equal(r2, r) and torch.equal(t2, t)
    assert torch.equal(K.joint_jacobian(tr.params, T(q), ter, tet), jac)
    rs, ts = K.fk_joints(tr.params, T(q))
    jrs, jts = jax.vmap(lambda x: JK.fk_joints(jr.params, x))(jnp.asarray(q))
    np.testing.assert_allclose(rs.numpy(), np.asarray(jrs), rtol=0, atol=1e-12)
    np.testing.assert_allclose(ts.numpy(), np.asarray(jts), rtol=0, atol=1e-12)

    # The port's SoA path (what jacobian_batch and the gauge solve run on).
    offset = EE_OFFSET if ee else None
    np.testing.assert_allclose(tr.jacobian_batch(q, offset).numpy(),
                               jac.numpy(), rtol=0, atol=1e-12)
    np.testing.assert_allclose(
        tr.jacobian_batch(q, offset).numpy(),
        np.asarray(jr.jacobian_batch(q, offset)), rtol=0, atol=1e-12)
    # A single configuration (no batch dimension) and the scalar facade.
    one = K.joint_jacobian(tr.params, T(q[0]), ter, tet)
    np.testing.assert_allclose(one.numpy(), jac[0].numpy(), rtol=0, atol=1e-14)
    got = tr.joint_jacobian(q[0], offset)
    assert got.shape == (6, jr.num_positions()) and got.dtype == np.float64
    np.testing.assert_allclose(got, jr.joint_jacobian(q[0], offset), rtol=0,
                               atol=1e-12)


def test_jacobian_batch_leading_dimensions_and_dtype():
    _, tr = robots("panda")
    _, tr32 = robots("panda", f32=True)
    q = configurations(robots("panda")[0], 2, 6)
    flat = tr.jacobian_batch(q)
    assert torch.equal(tr.jacobian_batch(q.reshape(2, 3, 7)),
                       flat.reshape(2, 3, 6, 7))
    j32 = tr32.jacobian_batch(q)
    assert j32.dtype == torch.float32
    assert tr32.joint_jacobian(q[0]).dtype == np.float32
    np.testing.assert_allclose(j32.numpy(), flat.numpy(), rtol=0, atol=5e-6)
    with pytest.raises(ValueError, match=r"len\(x\) != num_positions"):
        tr.joint_jacobian(np.zeros(3))


def random_targets(seed, b=B):
    rng = np.random.default_rng(seed)
    quat = rng.normal(size=(b, 4))
    quat /= np.linalg.norm(quat, axis=-1, keepdims=True)
    from optik_tpu.math import so3
    return (np.asarray(so3.quat_to_mat(jnp.asarray(quat))),
            rng.uniform(-1, 1, size=(b, 3)))


@pytest.mark.parametrize("weights", [(None, None), (LIN_W, ANG_W),
                                     (None, ANG_W)],
                         ids=["identity", "weighted", "angular_only"])
@pytest.mark.parametrize("model", ["ur3e", "panda", "scara"])
def test_objective_and_gradient_match_jax_and_autograd(model, weights):
    wl, wa = weights
    jr, tr = robots(model)
    q = configurations(jr, 3)
    tgt_r, tgt_t = random_targets(4)

    def jax_all(x, r, t):
        res, jac = JO.residual_and_jacobian(jr.params, x, r, t, wl=wl, wa=wa)
        return (JO.objective(jr.params, x, r, t, wl=wl, wa=wa),
                JO.objective_grad(jr.params, x, r, t, wl=wl, wa=wa), res, jac)

    j_cost, j_grad, j_res, j_jac = jax.vmap(jax_all)(
        jnp.asarray(q), jnp.asarray(tgt_r), jnp.asarray(tgt_t))

    qt = T(q).requires_grad_(True)
    cost = O.objective(tr.params, qt, T(tgt_r), T(tgt_t), wl=wl, wa=wa)
    (auto,) = torch.autograd.grad(cost.sum(), qt)
    grad = O.objective_grad(tr.params, T(q), T(tgt_r), T(tgt_t), wl=wl, wa=wa)
    res, jac = O.residual_and_jacobian(tr.params, T(q), T(tgt_r), T(tgt_t),
                                       wl=wl, wa=wa)
    assert grad.shape == q.shape and cost.shape == (B,)
    np.testing.assert_allclose(cost.detach().numpy(), np.asarray(j_cost),
                               rtol=0, atol=1e-11)
    np.testing.assert_allclose(res.numpy(), np.asarray(j_res), rtol=0,
                               atol=1e-11)
    np.testing.assert_allclose(jac.numpy(), np.asarray(j_jac), rtol=0,
                               atol=1e-10)
    np.testing.assert_allclose(grad.numpy(), np.asarray(j_grad), rtol=0,
                               atol=1e-9)
    np.testing.assert_allclose(grad.numpy(), auto.numpy(), rtol=0, atol=1e-9)
    np.testing.assert_allclose((res * res).sum(-1).numpy(),
                               cost.detach().numpy(), rtol=0, atol=1e-12)

    # The array path is the oracle of the SoA hot path.
    if wl is None and wa is None:
        comps = [T(q)[:, j] for j in range(q.shape[1])]
        rm = [[T(tgt_r)[:, i, j] for j in range(3)] for i in range(3)]
        tv = [T(tgt_t)[:, i] for i in range(3)]
        e, jt = soa.residual_and_jtask(tr._consts, comps, rm, tv)
        np.testing.assert_allclose(torch.stack(e, dim=-1).numpy(),
                                   res.numpy(), rtol=0, atol=1e-10)
        full = [[c if isinstance(c, torch.Tensor) else torch.full(
            (B,), float(c), dtype=torch.float64) for c in row] for row in jt]
        np.testing.assert_allclose(
            torch.stack([torch.stack(row, dim=-1) for row in full],
                        dim=-2).numpy(), jac.numpy(), rtol=0, atol=1e-9)


def test_weight_matrix_and_identity_check():
    tgt_r, _ = random_targets(5, 4)
    assert O.weight_matrix(T(tgt_r), None, None) is None
    assert O.weight_matrix(T(tgt_r), (1.0, 1.0, 1.0), None) is None
    assert O.weights_are_identity(None) and not O.weights_are_identity(LIN_W)
    for wl, wa in ((LIN_W, ANG_W), (LIN_W, None), (None, ANG_W)):
        got = O.weight_matrix(T(tgt_r), wl, wa)
        ref = jax.vmap(lambda r: JO.weight_matrix(r, wl, wa))(
            jnp.asarray(tgt_r))
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                                   atol=1e-14)
    e = O.pose_error(T(tgt_r), T(np.zeros((4, 3))), T(tgt_r),
                     T(np.zeros((4, 3))))
    np.testing.assert_allclose(e.numpy(), 0.0, atol=1e-12)
