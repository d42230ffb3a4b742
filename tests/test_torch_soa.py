"""The port's SoA math (optik_tpu_torch/ops/soa.py) against the JAX
package's (optik_tpu/ops/soa.py) and against the golden fixtures.

Tolerances:
  * f64, exact math: atol 1e-12.  Both run the same operations in the same
    order; only libm's sin/cos/atan2 and XLA's operation fusion may differ
    in the last bits.
  * f32, kernel math mode: atol 1e-6.  The polynomials use only IEEE
    +-*/, sqrt and floor, so the two agree to a few f32 ulps of O(1) values.
  * golden fixtures (Pinocchio-derived, stored to ~1e-9): atol 1e-6, the
    JAX package's own tolerance for them (tests/test_math.py, test_fk.py).
  * ``mat_to_quat``, ``quat_log``, ``mat_log``,
    ``so3_right_jacobian_from_w``, ``se3_log_from_w``, ``se3_log`` and
    ``se3_right_jacobian_blocks`` at f64, exact and in kernel math mode, on
    random rotations and on angles within 1e-6 of 0 and of pi: relative
    1e-10 (absolute 1e-12 on components near 0), as tests/test_torch_math.py
    holds ``math/so3``.
"""

import dataclasses
import json
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from optik_tpu.models import ChainSpec as JaxSpec
from optik_tpu.models import asset_path
from optik_tpu.ops import soa as jsoa

from optik_tpu_torch import Robot
from optik_tpu_torch.models import ChainSpec
from optik_tpu_torch.ops import soa

DATA = pathlib.Path(__file__).parent / "data"
L = 64  # lanes


@pytest.fixture(scope="module")
def specs():
    jspec = JaxSpec.from_urdf_file(asset_path("panda.urdf"), "panda_link0",
                                   "panda_hand_tcp")
    return jspec, ChainSpec.from_arrays(dataclasses.asdict(jspec))


def _problem(spec, seed=0):
    """Joint values, target poses and an EE offset from a numpy seed."""
    rng = np.random.default_rng(seed)
    lo, hi = spec.lower, spec.upper
    q = rng.uniform(lo, hi, size=(L, spec.num_positions))
    # Targets: FK of other configurations, so rotations are generic.
    qt = rng.uniform(lo, hi, size=(L, spec.num_positions))
    consts = soa.chain_constants(spec)
    _, r, t = soa.fk_with_ee(consts, [torch.tensor(qt[:, j])
                                      for j in range(qt.shape[1])])
    tr = np.stack([np.stack([r[i][j].numpy() for j in range(3)], -1)
                   for i in range(3)], -2)
    tt = np.stack([t[i].numpy() for i in range(3)], -1)
    ee = np.eye(4)
    ee[:3, :3] = [[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]]
    ee[:3, 3] = [0.03, -0.01, 0.12]
    return q, tr, tt, ee


def _comps(arr, lib, dtype):
    """(L, ...) numpy -> nested component lists of lib arrays."""
    def conv(a):
        if lib is torch:
            return torch.tensor(a, dtype=dtype)
        return jnp.asarray(a, dtype=dtype)

    if arr.ndim == 2:
        return [conv(arr[:, i]) for i in range(arr.shape[1])]
    return [[conv(arr[:, i, j]) for j in range(arr.shape[2])]
            for i in range(arr.shape[1])]


def _np(v):
    if isinstance(v, (list, tuple)):
        return np.stack([_np(u) for u in v])
    return np.broadcast_to(np.asarray(v, dtype=np.float64), (L,))


def _residual_pair(jspec, spec, q, tr, tt, ee, weights, dtype_np, approx):
    tdt = torch.float64 if dtype_np == np.float64 else torch.float32
    jdt = jnp.float64 if dtype_np == np.float64 else jnp.float32
    eer, eet = ee[None, :3, :3].repeat(L, 0), ee[None, :3, 3].repeat(L, 0)
    wl, wa = weights
    jt_tgt = _comps(tr, jnp, jdt)

    def jax_residual():
        return jsoa.residual_and_jtask(
            jsoa.chain_constants(jspec), _comps(q, jnp, jdt), jt_tgt,
            _comps(tt, jnp, jdt), _comps(eer, jnp, jdt),
            _comps(eet, jnp, jdt), jsoa.weight6_from_config(jt_tgt, wl, wa))

    if approx:
        with jsoa.approx_atan2():
            ref = jax_residual()
    else:
        ref = jax_residual()
    t_tgt = _comps(tr, torch, tdt)
    got = soa.residual_and_jtask(
        soa.chain_constants(spec), _comps(q, torch, tdt), t_tgt,
        _comps(tt, torch, tdt), _comps(eer, torch, tdt),
        _comps(eet, torch, tdt), soa.weight6_from_config(t_tgt, wl, wa),
        approx=approx)
    return ref, got


@pytest.mark.parametrize("weights", [
    ((1.0, 1.0, 1.0), (1.0, 1.0, 1.0)),
    ((0.0, 1.0, 1.0), (0.5, 1.0, 2.0)),
])
def test_residual_and_jtask_matches_jax_f64(specs, weights):
    jspec, spec = specs
    q, tr, tt, ee = _problem(spec)
    (e_r, j_r), (e_g, j_g) = _residual_pair(jspec, spec, q, tr, tt, ee,
                                            weights, np.float64, False)
    np.testing.assert_allclose(_np(e_g), _np(e_r), rtol=0, atol=1e-12)
    np.testing.assert_allclose(_np(j_g), _np(j_r), rtol=0, atol=1e-12)


def test_residual_and_jtask_kernel_math_matches_jax_f32(specs):
    jspec, spec = specs
    q, tr, tt, ee = _problem(spec, seed=1)
    ident = ((1.0, 1.0, 1.0), (1.0, 1.0, 1.0))
    (e_r, j_r), (e_g, j_g) = _residual_pair(jspec, spec, q, tr, tt, ee,
                                            ident, np.float32, True)
    np.testing.assert_allclose(_np(e_g), _np(e_r), rtol=0, atol=1e-6)
    np.testing.assert_allclose(_np(j_g), _np(j_r), rtol=0, atol=1e-6)
    # Kernel math is an approximation of the exact math, not another
    # function: the f64 exact residual agrees to f32 accuracy.
    (_, _), (e_x, _) = _residual_pair(jspec, spec, q, tr, tt, ee, ident,
                                      np.float64, False)
    np.testing.assert_allclose(_np(e_g), _np(e_x), rtol=0, atol=2e-5)


def test_kernel_math_polynomials_match_jax_f32():
    x = np.linspace(-4 * np.pi, 4 * np.pi, 4001)
    with jsoa.approx_atan2():
        s_r, c_r = jsoa.sincos(jnp.asarray(x, jnp.float32))
        y = np.abs(x[::-1])
        a_r = jsoa.atan2_nonneg(jnp.asarray(y, jnp.float32),
                                jnp.asarray(x, jnp.float32))
    s_g, c_g = soa.sincos(torch.tensor(x, dtype=torch.float32), approx=True)
    a_g = soa.atan2_nonneg(torch.tensor(y, dtype=torch.float32),
                           torch.tensor(x, dtype=torch.float32), approx=True)
    for got, ref in ((s_g, s_r), (c_g, c_r), (a_g, a_r)):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                                   atol=1e-6)
    np.testing.assert_allclose(s_g.numpy(), np.sin(x), rtol=0, atol=1e-6)
    np.testing.assert_allclose(a_g.numpy(), np.arctan2(y, x), rtol=0,
                               atol=1e-6)


def test_fk_and_jacobian_cols_match_jax_f64(specs):
    jspec, spec = specs
    q, _, _, ee = _problem(spec, seed=2)
    eer, eet = ee[None, :3, :3].repeat(L, 0), ee[None, :3, 3].repeat(L, 0)
    jc = jsoa.chain_constants(jspec)
    fr, r_r, t_r = jsoa.fk_with_ee(jc, _comps(q, jnp, jnp.float64),
                                   _comps(eer, jnp, jnp.float64),
                                   _comps(eet, jnp, jnp.float64))
    cols_r = jsoa.jacobian_cols(jc, fr, r_r, t_r)
    tc = soa.chain_constants(spec)
    fg, r_g, t_g = soa.fk_with_ee(tc, _comps(q, torch, torch.float64),
                                  _comps(eer, torch, torch.float64),
                                  _comps(eet, torch, torch.float64))
    cols_g = soa.jacobian_cols(tc, fg, r_g, t_g)
    for got, ref in ((r_g, r_r), (t_g, t_r), (cols_g, cols_r)):
        np.testing.assert_allclose(_np(got), _np(ref), rtol=0, atol=1e-12)


def test_cholesky_solve_matches_jax_f64():
    rng = np.random.default_rng(3)
    # Well-conditioned, like the solver's J J^T + lam I: the solution is
    # O(1), so atol 1e-12 measures rounding, not conditioning.
    m = rng.normal(scale=0.5, size=(L, 6, 6))
    a = m @ np.swapaxes(m, 1, 2) + np.eye(6)
    b = rng.normal(size=(L, 6))
    ref = jsoa.cholesky_solve(_comps(a, jnp, jnp.float64),
                              _comps(b, jnp, jnp.float64))
    got = soa.cholesky_solve(_comps(a, torch, torch.float64),
                             _comps(b, torch, torch.float64))
    np.testing.assert_allclose(_np(got), _np(ref), rtol=0, atol=1e-12)
    np.testing.assert_allclose(_np(got).T,
                               np.linalg.solve(a, b[..., None])[..., 0],
                               rtol=1e-8)


def _golden(name):
    return json.load(open(DATA / name))


def _quat_to_mat(q):
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return np.stack([
        np.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                  2 * (x * z + w * y)], -1),
        np.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                  2 * (y * z - w * x)], -1),
        np.stack([2 * (x * z - w * y), 2 * (y * z + w * x),
                  1 - 2 * (x * x + y * y)], -1)], -2)


def test_fk_matches_golden_fixture():
    robot = Robot.from_urdf_file(asset_path("ur3e.urdf"), "ur_base_link",
                                 "ur_ee_link", dtype=torch.float64,
                                 device="cpu")
    inputs = np.array(_golden("test_fk_inputs.json"))
    outputs = _golden("test_fk_outputs.json")
    r, t = robot.fk_batch(inputs)
    for i, expect in enumerate(outputs):
        np.testing.assert_allclose(t[i].numpy(), expect["translation"],
                                   atol=1e-6)
        np.testing.assert_allclose(
            r[i].numpy(), _quat_to_mat(np.array(expect["rotation"])),
            atol=1e-6)


def test_se3_log_and_right_jacobian_match_golden_fixture():
    raw = _golden("test_math_inputs.json")
    quats = np.array([d["rotation"] for d in raw])
    trans = np.array([d["translation"] for d in raw])
    n = len(raw)
    rot = _quat_to_mat(quats)
    r = [[torch.tensor(rot[:, i, j]) for j in range(3)] for i in range(3)]
    t = [torch.tensor(trans[:, i]) for i in range(3)]
    w, trig = soa.rot_log_terms(r)
    log6 = np.stack([v.numpy() for v in soa.se3_log_trig(w, t, trig)], -1)
    np.testing.assert_allclose(
        log6, np.array(_golden("test_math_outputs_se3_log.json")), atol=1e-6)

    jr, qq = soa.se3_right_jacobian_blocks_trig(w, t, trig)
    got = np.zeros((n, 6, 6))
    for i in range(3):
        for j in range(3):
            got[:, i, j] = got[:, 3 + i, 3 + j] = jr[i][j].numpy()
            got[:, i, 3 + j] = qq[i][j].numpy()
    flat = np.array(_golden("test_math_outputs_se3_right_jacobian.json"))
    want = np.swapaxes(flat.reshape(-1, 6, 6), -1, -2)  # column-major
    np.testing.assert_allclose(got, want, atol=1e-6)


# --- the log and right-Jacobian functions, at and near 0 and pi -------------


def _rotation_vectors(rng):
    """Rotation vectors: random angles in (0, pi), and angles 0, 1e-7,
    1e-6, pi - 1e-6, pi - 1e-7 and pi about random axes."""
    n_rand = 24
    special = np.array([0.0, 1e-7, 5e-7, 1e-6, np.pi - 1e-6, np.pi - 1e-7,
                        np.pi])
    angles = np.concatenate([rng.uniform(0.0, np.pi, n_rand), special])
    axes = rng.standard_normal((angles.size, 3))
    axes /= np.linalg.norm(axes, axis=1, keepdims=True)
    return axes * angles[:, None]


def _rotations(w):
    """Exact Rodrigues at f64: (N, 3, 3)."""
    theta = np.linalg.norm(w, axis=1)
    k = w / np.where(theta > 0, theta, 1.0)[:, None]
    kx = np.zeros((w.shape[0], 3, 3))
    kx[:, 0, 1], kx[:, 0, 2] = -k[:, 2], k[:, 1]
    kx[:, 1, 0], kx[:, 1, 2] = k[:, 2], -k[:, 0]
    kx[:, 2, 0], kx[:, 2, 1] = -k[:, 1], k[:, 0]
    s, c = np.sin(theta)[:, None, None], np.cos(theta)[:, None, None]
    return np.eye(3) + s * kx + (1 - c) * kx @ kx


def _quaternions(w, rng):
    """Unit quaternions (x, y, z, w) of the rotation vectors, on both
    covers (a random half negated)."""
    theta = np.linalg.norm(w, axis=1)
    k = w / np.where(theta > 0, theta, 1.0)[:, None]
    q = np.concatenate([k * np.sin(theta / 2)[:, None],
                        np.cos(theta / 2)[:, None]], axis=1)
    return q * np.where(rng.random(w.shape[0]) < 0.5, -1.0, 1.0)[:, None]


def _comps_of(a, lib):
    """(N, ...) array -> nested lists of (N,) components."""
    if a.ndim == 1:
        return lib(a)
    return [_comps_of(a[:, i], lib) for i in range(a.shape[1])]


def _flat(v):
    if isinstance(v, (list, tuple)):
        return np.concatenate([_flat(u) for u in v])
    return np.asarray(v, dtype=np.float64).reshape(1, -1)


SOA_FUNCTIONS = {
    "mat_to_quat": lambda m, r, w, t, q: m.mat_to_quat(r),
    "quat_log": lambda m, r, w, t, q: m.quat_log(q),
    "mat_log": lambda m, r, w, t, q: m.mat_log(r),
    "so3_right_jacobian_from_w":
        lambda m, r, w, t, q: m.so3_right_jacobian_from_w(w),
    "se3_log_from_w": lambda m, r, w, t, q: m.se3_log_from_w(w, t),
    "se3_log": lambda m, r, w, t, q: m.se3_log(r, t),
    "se3_right_jacobian_blocks":
        lambda m, r, w, t, q: m.se3_right_jacobian_blocks(w, t),
}
# mat_to_quat has no transcendental, so no kernel math mode.
SOA_CASES = [(name, approx) for name in SOA_FUNCTIONS
             for approx in (False, True)
             if not (approx and name == "mat_to_quat")]


class _PortSoa:
    """The port's functions with the kernel-math flag bound, under the JAX
    module's call signatures."""

    def __init__(self, approx):
        self.approx = approx

    def __getattr__(self, name):
        fn = getattr(soa, name)
        if name == "mat_to_quat":
            return fn
        return lambda *a: fn(*a, approx=self.approx)


@pytest.mark.parametrize("name,approx", SOA_CASES,
                         ids=[f"{n}-{'kernel' if a else 'exact'}"
                              for n, a in SOA_CASES])
def test_soa_function_matches_jax(name, approx):
    fn = SOA_FUNCTIONS[name]
    rng = np.random.default_rng(11)
    w = _rotation_vectors(rng)
    r, q = _rotations(w), _quaternions(w, rng)
    t = rng.standard_normal((w.shape[0], 3))
    args = (r, w, t, q)
    got = fn(_PortSoa(approx), *(_comps_of(a, torch.tensor) for a in args))
    if approx:
        with jsoa.approx_atan2():
            want = fn(jsoa, *(_comps_of(a, jnp.asarray) for a in args))
    else:
        want = fn(jsoa, *(_comps_of(a, jnp.asarray) for a in args))
    got, want = _flat(got), _flat(want)
    assert got.shape == want.shape
    # Kernel math's sin(pi) is exactly 0, so at an angle of exactly pi the
    # inverse right Jacobian's coefficient is 0/0 on both sides; nowhere
    # else is a component not finite.
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
    assert np.isfinite(got).all() or (approx and "jacobian" in name)
    np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-12)


def test_soa_functions_on_the_special_angles_are_right():
    """The Taylor branches (the identity) and the double cover (pi): the
    log of an exact rotation returns its rotation vector."""
    rng = np.random.default_rng(12)
    w = _rotation_vectors(rng)
    far = np.linalg.norm(w, axis=1) < np.pi - 1e-6  # log is unique there
    got = _flat(soa.mat_log(_comps_of(_rotations(w), torch.tensor))).T
    np.testing.assert_allclose(got[far], w[far], rtol=0, atol=1e-9)
    got_q = _flat(soa.quat_log(_comps_of(_quaternions(w, rng),
                                      torch.tensor))).T
    np.testing.assert_allclose(got_q[far], w[far], rtol=0, atol=1e-9)
    assert np.allclose(np.linalg.norm(got[~far], axis=1), np.pi, atol=1e-6)
