"""The port's Lie-group math (optik_tpu_torch/math) against the JAX
package's (optik_tpu/math) and the golden fixtures of tests/data.

The same float64 inputs, made from a numpy seed, go through both.  Both
sides run the same operations in float64; they differ in the order of a few
sums and in libm, so the tolerance against JAX is 1e-12.  The fixtures
(Pinocchio values) are held at 1e-6, as tests/test_math.py holds the JAX
package to them.
"""

import json
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from optik_tpu.math import linalg as jlinalg
from optik_tpu.math import se3 as jse3
from optik_tpu.math import so3 as jso3

from optik_tpu_torch.math import linalg, se3, so3

DATA = pathlib.Path(__file__).parent / "data"
TOL = 1e-12


def load(name):
    return json.loads((DATA / name).read_text())


def load_matrices(name, n):
    """nalgebra serialises column-major: reshape, then transpose."""
    return np.swapaxes(np.array(load(name)).reshape(-1, n, n), -1, -2)


def fixture_inputs():
    raw = load("test_math_inputs.json")
    return (np.array([d["rotation"] for d in raw]),
            np.array([d["translation"] for d in raw]))


def random_inputs(seed, n=64):
    """Unit quaternions, rotation vectors (some tiny, some near pi) and
    translations."""
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(n, 4))
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    q[0] = [0.0, 0.0, 0.0, 1.0]
    q[1] = [0.0, 0.0, 0.0, -1.0]
    q[2] = [1e-5, -2e-5, 1e-5, 1.0] / np.linalg.norm([1e-5, -2e-5, 1e-5, 1.0])
    q[3] = [1.0, 1e-9, 0.0, 1e-9] / np.linalg.norm([1.0, 1e-9, 0.0, 1e-9])
    w = rng.normal(size=(n, 3))
    w[0] = 0.0
    w[1] *= 1e-4
    w[2] *= (np.pi - 1e-6) / np.linalg.norm(w[2])
    t = rng.uniform(-1, 1, size=(n, 3))
    return q, w, t


def T(a):
    return torch.tensor(np.asarray(a), dtype=torch.float64)


def close(got, ref, tol=TOL):
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=tol)


# (name, port function, JAX function, arguments picked from (q, w, t, r))
CASES = [
    ("hat", so3.hat, jso3.hat, lambda q, w, t, r: (w,)),
    ("hat2", so3.hat2, jso3.hat2, lambda q, w, t, r: (w,)),
    ("quat_log", so3.quat_log, jso3.quat_log, lambda q, w, t, r: (q,)),
    ("mat_to_quat", so3.mat_to_quat, jso3.mat_to_quat,
     lambda q, w, t, r: (r,)),
    ("quat_to_mat", so3.quat_to_mat, jso3.quat_to_mat,
     lambda q, w, t, r: (q,)),
    ("mat_log", so3.mat_log, jso3.mat_log, lambda q, w, t, r: (r,)),
    ("so3_right_jacobian", so3.right_jacobian, jso3.right_jacobian,
     lambda q, w, t, r: (w,)),
    ("rodrigues", so3.rodrigues, jso3.rodrigues,
     lambda q, w, t, r: (q[:, :3] / np.linalg.norm(
         q[:, :3] + 1e-300, axis=-1, keepdims=True).clip(1e-12), w[:, 0])),
    ("se3_log", se3.log, jse3.log, lambda q, w, t, r: (r, t)),
    ("se3_right_jacobian_q", se3.right_jacobian_q, jse3.right_jacobian_q,
     lambda q, w, t, r: (t, w)),
    ("se3_right_jacobian", se3.right_jacobian, jse3.right_jacobian,
     lambda q, w, t, r: (r, t)),
]


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_math_matches_jax(case):
    _, fn, jfn, build = case
    q, w, t = random_inputs(3)
    r = np.asarray(jso3.quat_to_mat(jnp.asarray(q)))
    args = build(q, w, t, r)
    close(fn(*[T(a) for a in args]), jfn(*[jnp.asarray(a) for a in args]))


def test_sin_cos_coeffs_and_compose_match_jax():
    q, w, t = random_inputs(4)
    theta2 = np.concatenate([np.sum(w * w, axis=-1), [0.0, 1e-7, 1e-6, 2e-6]])
    for got, ref in zip(so3._sin_cos_coeffs(T(theta2)),
                        jso3._sin_cos_coeffs(jnp.asarray(theta2))):
        if got.dtype == torch.bool:
            np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
        else:
            close(got, ref)
    r = np.asarray(jso3.quat_to_mat(jnp.asarray(q)))
    ra, rb, ta, tb = r[:32], r[32:], t[:32], t[32:]
    for fn, jfn in ((se3.compose, jse3.compose),
                    (se3.inv_compose, jse3.inv_compose)):
        got = fn(T(ra), T(ta), T(rb), T(tb))
        ref = jfn(*map(jnp.asarray, (ra, ta, rb, tb)))
        close(got[0], ref[0])
        close(got[1], ref[1])


@pytest.mark.parametrize("name,n,fn", [
    ("so3_log", None, lambda q, t: so3.quat_log(q)),
    ("so3_log", None, lambda q, t: so3.mat_log(so3.quat_to_mat(q))),
    ("so3_right_jacobian", 3,
     lambda q, t: so3.right_jacobian(so3.quat_log(q))),
    ("se3_log", None, lambda q, t: se3.log(so3.quat_to_mat(q), t)),
    ("se3_right_jacobian", 6,
     lambda q, t: se3.right_jacobian(so3.quat_to_mat(q), t)),
], ids=["so3_log", "so3_log_from_matrix", "so3_right_jacobian", "se3_log",
        "se3_right_jacobian"])
def test_golden_fixtures(name, n, fn):
    quats, trans = fixture_inputs()
    file = f"test_math_outputs_{name}.json"
    expected = np.array(load(file)) if n is None else load_matrices(file, n)
    close(fn(T(quats), T(trans)), expected, tol=1e-6)


def test_singular_points_stay_finite():
    close(so3.quat_log(T([[0.0, 0.0, 0.0, 1.0], [0.0, 0.0, 0.0, -1.0]])),
          np.zeros((2, 3)))
    close(so3.right_jacobian(torch.zeros(3, dtype=torch.float64)), np.eye(3))
    close(se3.log(torch.eye(3, dtype=torch.float64), T([1.0, -2.0, 3.0])),
          [1.0, -2.0, 3.0, 0.0, 0.0, 0.0])
    jac = se3.right_jacobian(torch.eye(3, dtype=torch.float64),
                             T([1.0, -2.0, 3.0]))
    assert bool(torch.isfinite(jac).all())


def test_batched_matches_single_and_dtype_is_kept():
    quats, trans = fixture_inputs()
    r, t = so3.quat_to_mat(T(quats)), T(trans)
    batched = se3.right_jacobian(r, t)
    single = torch.stack([se3.right_jacobian(r[i], t[i])
                          for i in range(r.shape[0])])
    # Batched and single matrix products may round differently (another
    # product kernel): equal to the last bits, not bitwise.
    close(batched, single.numpy(), tol=1e-14)
    # float32 in, float32 out, whatever the default dtype is.
    torch.set_default_dtype(torch.float64)
    try:
        out = se3.right_jacobian(r.float(), t.float())
        w = so3.mat_log(r.float())
        rod = so3.rodrigues(w, w[:, 0])
    finally:
        torch.set_default_dtype(torch.float32)
    assert out.dtype == w.dtype == rod.dtype == torch.float32


@pytest.mark.parametrize("n", [3, 6, 8])
def test_cholesky_solve_matches_jax(n):
    rng = np.random.default_rng(n)
    m = rng.normal(size=(16, n, n))
    a = m @ np.swapaxes(m, -1, -2) + 0.5 * np.eye(n)
    b = rng.normal(size=(16, n))
    got = linalg.cholesky_solve(T(a), T(b))
    close(got, jlinalg.cholesky_solve(jnp.asarray(a), jnp.asarray(b)),
          tol=1e-10)
    close(got, np.linalg.solve(a, b[..., None])[..., 0], tol=1e-9)
