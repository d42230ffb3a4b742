"""The port's native host runtime (``optik_tpu_torch.native``).

Each contract of tests/test_native.py, on the port's binding, against the
port's Robot at f64 on the CPU (repeats merged as parametrised cases), and
the port's binding against the JAX package's (``optik_tpu.native``): built
from their own copies of one source with the same flags on one machine, the
two give bitwise equal FK, Jacobians, IK (Speed, Quality, weights,
``tol_dx``) and diff-IK on 64 seeded Panda inputs.  The JAX binding is
built into a temporary directory here, so this file never writes
``optik_tpu/native/liboptik_host.so``, which tests/test_native.py builds in
another process.  Tolerances: 1e-12 where the port's Robot runs the same
f64 operations, 1e-5 on FK of an IK solution (a cost of 1e-10), bitwise
between the bindings.  The C++ example (``examples/example.cpp``), built
from each package's copy against its own library, prints the same
successes.  Skipped without ``g++``; a build takes about 13 s on an 8-core
Xeon.
"""

import ctypes
import pathlib
import shutil
import subprocess
import threading
import time

import numpy as np
import pytest
import torch

from optik_tpu_torch import Robot, SolverConfig
from optik_tpu_torch.models import asset_path
from optik_tpu_torch.native import host as port_host

REPO = pathlib.Path(__file__).resolve().parent.parent
PANDA = (asset_path("panda.urdf"), "panda_link0", "panda_hand_tcp")
N_BITWISE = 64


@pytest.fixture(scope="module")
def pair():
    if shutil.which("g++") is None:
        pytest.skip("no C++ toolchain")
    robot = Robot.from_urdf_file(*PANDA, dtype=torch.float64, device="cpu")
    return robot, port_host.HostChain(robot.spec)


@pytest.fixture(scope="module")
def jax_host(pair, tmp_path_factory):
    """The JAX package's binding, its library built into a temporary
    directory (unless this process has loaded it already)."""
    from optik_tpu.native import host as jhost

    if jhost._lib is None:
        saved = jhost._LIB
        jhost._LIB = tmp_path_factory.mktemp("jax_native") / "liboptik_host.so"
        try:
            jhost._load()
        finally:
            jhost._LIB = saved
    return jhost


def _fn_address(lib, name):
    return ctypes.cast(getattr(lib, name), ctypes.c_void_p).value


# --- the build ----------------------------------------------------------------


def test_library_is_built_from_the_ports_copy_under_build(pair, jax_host):
    path = port_host.build()
    assert path == port_host.library_path()
    assert path.name == "liboptik_host_torch.so" and path.exists()
    assert path.parent.parent == REPO / "build" / "optik_tpu_torch"
    assert path.parent.name.startswith("native-")
    cmd = (path.parent / "command.txt").read_text().split()
    assert cmd[-3] == str(REPO / "optik_tpu_torch" / "native" / "optik_host.cpp")
    assert tuple(cmd[1:-3]) == port_host.FLAGS
    # Nothing was written beside either source.
    assert not list((REPO / "optik_tpu_torch" / "native").glob("*.so"))
    # Two libraries in one process, each bound through its own handle.
    port_lib, jax_lib = port_host._load(), jax_host._load()
    assert port_lib._handle != jax_lib._handle
    assert pathlib.Path(port_lib._name) != pathlib.Path(jax_lib._name)
    for name in ("optik_host_fk", "optik_host_ik_cfg", "optik_host_diff_ik"):
        assert _fn_address(port_lib, name) != _fn_address(jax_lib, name)


def test_build_key_covers_source_headers_and_flags(pair, monkeypatch):
    base = port_host.library_path()
    monkeypatch.setattr(port_host, "FLAGS", port_host.FLAGS + ("-g",))
    assert port_host.library_path() != base
    monkeypatch.undo()
    assert len(port_host.HEADERS) == 2
    assert all(h.parent == REPO / "optik_tpu_torch" / "native" / "include"
               for h in port_host.HEADERS)


def test_concurrent_builds_never_expose_half_a_library(pair, tmp_path,
                                                       monkeypatch):
    """Two builds of one key at once (two workers, two ranks): both
    finish, the library loads, and no temporary file is left behind."""
    monkeypatch.setattr(port_host, "BUILD_ROOT", tmp_path)
    errors = []

    def compile_once():
        try:
            port_host.build(force=True)
        except Exception as exc:  # reported below
            errors.append(exc)

    threads = [threading.Thread(target=compile_once) for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
        assert not t.is_alive()
    assert not errors
    path = port_host.library_path()
    assert sorted(p.name for p in path.parent.iterdir()) == [
        "command.txt", path.name]
    lib = ctypes.CDLL(str(path))
    assert lib.optik_host_num_positions is not None


@pytest.mark.parametrize("entry", ["build", "build_example"])
def test_no_toolchain_raises_runtime_error(tmp_path, monkeypatch, entry):
    monkeypatch.setattr(port_host, "BUILD_ROOT", tmp_path)
    monkeypatch.setattr(port_host.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        getattr(port_host, entry)()
    assert not list(tmp_path.iterdir())


def _run_example(exe):
    out = subprocess.run([str(exe), *map(str, PANDA)], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    return out.stdout.splitlines()[-2:]


def test_example_cpp_matches_the_jax_packages(pair, jax_host, tmp_path):
    """examples/example.cpp's 10,000-pose loop, built from the port's copy
    against the port's library and from the JAX package's against its own:
    the same successes (the host's restart stream is deterministic)."""
    exe = port_host.build_example()
    assert exe == port_host.example_path() and exe.name == "example_cpp"
    assert exe.parent.parent == REPO / "build" / "optik_tpu_torch"
    assert exe.parent.name.startswith("example-")
    cmd = (exe.parent / "command.txt").read_text().split()
    assert str(REPO / "optik_tpu_torch" / "examples" / "example.cpp") in cmd
    assert str(port_host.library_path()) in cmd
    jax_lib = pathlib.Path(jax_host._load()._name)
    jax_exe = tmp_path / "example_cpp"
    subprocess.run(
        ["g++", "-O3", "-march=native", "-std=c++17",
         f"-I{REPO / 'optik_tpu' / 'native' / 'include'}",
         str(REPO / "examples" / "example.cpp"), "-o", str(jax_exe),
         str(jax_lib), f"-Wl,-rpath,{jax_lib.parent}"],
        check=True, capture_output=True, timeout=300)
    mine, theirs = _run_example(exe), _run_example(jax_exe)
    assert mine[0].startswith("Successes: ") and mine[0] == theirs[0]
    assert mine[1].startswith("Average time per solve: ")
    assert theirs[1].startswith("Average time per solve: ")


# --- bitwise the JAX package's binding ----------------------------------------


def _inputs(robot, seed=20):
    rng = np.random.default_rng(seed)
    lo, hi = robot.joint_limits()
    q = rng.uniform(lo, hi, size=(N_BITWISE, 7))
    x0 = rng.uniform(lo, hi, size=(N_BITWISE, 7))
    v_we = rng.standard_normal((N_BITWISE, 6)) * 0.1
    v_max = rng.uniform(0.3, 1.2, size=(N_BITWISE, 7))
    return q, x0, v_we, v_max


def _same(a, b):
    if a is None or b is None:
        return a is None and b is None
    if isinstance(a, tuple):
        return all(_same(u, v) for u, v in zip(a, b))
    return np.array_equal(np.asarray(a), np.asarray(b))


IK_CASES = {
    "speed": dict(),
    "quality": dict(solution_mode="quality", max_restarts=16),
    "weights": dict(linear_weight=(0.0, 1.0, 1.0),
                    angular_weight=(0.5, 1.0, 2.0), tol_f=1e-10),
    "tol_dx": dict(tol_f=-1.0, tol_dx=1e-8, tol_df=1e-14, max_restarts=8),
}


@pytest.mark.parametrize("op", ["fk", "jacobian", "diff_ik", *IK_CASES])
def test_bitwise_equal_to_jax_binding(pair, jax_host, op):
    robot, port = pair
    jax_chain = jax_host.HostChain(robot.spec)
    q, x0, v_we, v_max = _inputs(robot)
    off = port.fk(q[-1])
    for i in range(N_BITWISE):
        if op in ("fk", "jacobian"):
            args = (q[i],)
            kw = {"ee_offset": off} if i % 2 else {}
        elif op == "diff_ik":
            args, kw = (q[i], v_we[i], v_max[i]), {}
        else:
            args, kw = (port.fk(q[i]), x0[i]), IK_CASES[op]
        got = getattr(port, op if op in ("fk", "jacobian", "diff_ik")
                      else "ik")(*args, **kw)
        ref = getattr(jax_chain, op if op in ("fk", "jacobian", "diff_ik")
                      else "ik")(*args, **kw)
        assert _same(got, ref), f"{op}: input {i} differs"


# --- the contracts of tests/test_native.py ------------------------------------


@pytest.mark.parametrize("offset", [False, True])
@pytest.mark.parametrize("what", ["fk", "jacobian"])
def test_kinematics_match_robot(pair, what, offset):
    robot, host = pair
    rng = np.random.default_rng(0 if what == "fk" else 1)
    lo, hi = robot.joint_limits()
    off = robot.fk(rng.uniform(lo, hi)) if offset else None
    mine = robot.fk if what == "fk" else robot.joint_jacobian
    for _ in range(20):
        q = rng.uniform(lo, hi)
        np.testing.assert_allclose(getattr(host, what)(q, ee_offset=off),
                                   mine(q, ee_offset=off), atol=1e-12)


@pytest.mark.parametrize("offset", [False, True])
def test_ik_roundtrip(pair, offset):
    robot, host = pair
    rng = np.random.default_rng(2)
    lo, hi = robot.joint_limits()
    off = robot.fk(rng.uniform(lo, hi)) if offset else None
    x0 = np.clip(np.zeros(robot.num_positions()), lo, hi)
    for _ in range(10 if not offset else 3):
        target = host.fk(rng.uniform(lo, hi), ee_offset=off)
        sol = host.ik(target, x0, tol_f=1e-10, ee_offset=off)
        assert sol is not None
        x, f = sol
        assert f <= 1e-10
        np.testing.assert_allclose(host.fk(x, ee_offset=off), target,
                                   atol=1e-5)
        assert np.all(x >= lo - 1e-12) and np.all(x <= hi + 1e-12)


def test_ik_unreachable_returns_none(pair):
    robot, host = pair
    lo, hi = robot.joint_limits()
    target = np.eye(4)
    target[:3, 3] = [100.0, 100.0, 100.0]
    assert host.ik(target, np.clip(np.zeros(7), lo, hi),
                   max_restarts=4, max_iters=16) is None


def test_latency_single_solve(pair):
    """The native path exists to make single solves cheap: well under a
    millisecond per solve on any modern CPU."""
    robot, host = pair
    rng = np.random.default_rng(3)
    lo, hi = robot.joint_limits()
    targets = [robot.fk(rng.uniform(lo, hi)) for _ in range(50)]
    x0 = np.clip(np.zeros(7), lo, hi)
    host.ik(targets[0], x0)  # warm
    t0 = time.perf_counter()
    n_ok = sum(host.ik(t, x0) is not None for t in targets)
    per_solve = (time.perf_counter() - t0) / len(targets)
    assert n_ok >= 45
    assert per_solve < 5e-3  # generous bound for shared machines


@pytest.mark.parametrize("urdf, base, ee", [
    ("panda.urdf", "panda_link0", "panda_hand_tcp"),
    ("ur3e.urdf", "ur_base_link", "ur_ee_link"),   # interior + trailing fixed
])
def test_native_urdf_ingest_matches_python(pair, urdf, base, ee):
    """Chains built by the C++ URDF parser equal the Python ingest's: same
    limits, and bit-identical FK and Jacobians to a chain built from the
    Python spec (fixed joints folded alike)."""
    native = port_host.HostChain.from_urdf_file(asset_path(urdf), base, ee)
    robot = Robot.from_urdf_file(asset_path(urdf), base, ee,
                                 dtype=torch.float64, device="cpu")
    from_spec = port_host.HostChain(robot.spec)
    assert native.n == robot.num_positions()
    lo_p, hi_p = robot.joint_limits()
    lo_n, hi_n = native.joint_limits()
    np.testing.assert_array_equal(lo_n, lo_p)
    np.testing.assert_array_equal(hi_n, hi_p)
    rng = np.random.default_rng(10)
    for _ in range(10):
        q = rng.uniform(lo_p, hi_p)
        np.testing.assert_array_equal(native.fk(q), from_spec.fk(q))
        np.testing.assert_array_equal(native.jacobian(q),
                                      from_spec.jacobian(q))
        np.testing.assert_allclose(native.fk(q), robot.fk(q), atol=1e-12)


@pytest.mark.parametrize("build, match", [
    (lambda H: H.from_urdf_file(asset_path("panda.urdf"), "nope",
                                "panda_hand_tcp"), "does not exist"),
    (lambda H: H.from_urdf_file("/nonexistent/x.urdf", "a", "b"),
     "cannot read"),
    (lambda H: H.from_urdf_str(
        """<robot name="r"><link name="a"/><link name="b"/>
           <joint name="j" type="floating">
             <parent link="a"/><child link="b"/>
           </joint></robot>""", "a", "b"), "joint type not supported"),
    (lambda H: H.from_urdf_str('<robot name="r"><link name="a"/></robot>',
                               "a", "a"), "empty"),
], ids=["missing link", "unreadable file", "floating joint", "empty chain"])
def test_native_urdf_error_contracts(pair, build, match):
    with pytest.raises(ValueError, match=match):
        build(port_host.HostChain)


def test_native_random_configuration(pair):
    _, host = pair
    lo, hi = host.joint_limits()
    q1 = host.random_configuration(7)
    q2 = host.random_configuration(7)
    q3 = host.random_configuration(8)
    np.testing.assert_array_equal(q1, q2)  # deterministic per seed
    assert np.any(q1 != q3)
    assert np.all((q1 >= lo) & (q1 <= hi))


def test_native_invalid_seed_raises(pair):
    """Out-of-limits seed: the reference panics (lib.rs:251-254); the
    binding raises ValueError with the same message."""
    robot, host = pair
    lo, hi = robot.joint_limits()
    bad = np.clip(np.zeros(7), lo, hi)
    bad[2] = hi[2] + 1.0
    target = robot.fk(np.clip(np.zeros(7), lo, hi))
    with pytest.raises(ValueError,
                       match="seed joint position outside of joint limits"):
        host.ik(target, bad)


def test_native_quality_mode(pair):
    """Quality mode: min ||x - x0|| over all successful restarts.  Seeded at
    the known solution it returns it; its seed distance is <= Speed's."""
    robot, host = pair
    rng = np.random.default_rng(15)
    lo, hi = robot.joint_limits()
    for _ in range(5):
        q_star = rng.uniform(lo, hi)
        target = robot.fk(q_star)
        solq = host.ik(target, q_star, solution_mode="quality",
                       max_restarts=16)
        assert solq is not None
        np.testing.assert_allclose(solq[0], q_star, atol=1e-3)

        x0 = rng.uniform(lo, hi)
        sol_s = host.ik(target, x0, solution_mode="speed", max_restarts=64)
        sol_q = host.ik(target, x0, solution_mode="quality", max_restarts=64)
        assert sol_s is not None and sol_q is not None
        d_s = np.linalg.norm(sol_s[0] - x0)
        d_q = np.linalg.norm(sol_q[0] - x0)
        assert d_q <= d_s + 1e-9


def test_native_weighted_ik_matches_python(pair):
    """Per-axis weights: the native weighted cost at the native solution
    equals the port's weighted objective there, and a zero x-weight admits
    a target the unweighted objective rejects."""
    from optik_tpu_torch.ops import objective as obj

    robot, host = pair
    rng = np.random.default_rng(16)
    lo, hi = robot.joint_limits()
    wl = (0.0, 1.0, 1.0)
    wa = (0.5, 1.0, 2.0)
    for _ in range(5):
        target = robot.fk(rng.uniform(lo, hi))
        x0 = rng.uniform(lo, hi)
        sol = host.ik(target, x0, tol_f=1e-10, linear_weight=wl,
                      angular_weight=wa)
        assert sol is not None
        x, f = sol
        f_port = float(obj.objective(
            robot.params, torch.tensor(x), torch.tensor(target[:3, :3]),
            torch.tensor(target[:3, 3]), wl=wl, wa=wa))
        assert abs(f_port - f) <= 1e-9 + 1e-4 * abs(f)
        assert f <= 1e-10

    target = robot.fk(rng.uniform(lo, hi))
    target[0, 3] += 1.5  # far beyond the Panda's ~0.85 m reach in x
    x0 = np.clip(np.zeros(7), lo, hi)
    assert host.ik(target, x0, tol_f=1e-10, max_restarts=32,
                   linear_weight=wl, angular_weight=wa) is not None
    assert host.ik(target, x0, tol_f=1e-10, max_restarts=32) is None


def test_native_tol_dx_success(pair):
    """tol_dx / tol_df >= 0 make small steps / small cost changes success
    criteria; with stopval disabled (tol_f < 0) they decide alone."""
    robot, host = pair
    rng = np.random.default_rng(17)
    lo, hi = robot.joint_limits()
    q_t = rng.uniform(lo, hi)
    target = robot.fk(q_t)
    x0 = np.clip(q_t + 0.05 * rng.standard_normal(7), lo, hi)
    sol = host.ik(target, x0, tol_f=-1.0, tol_dx=1e-8, tol_df=1e-14,
                  max_restarts=8)
    assert sol is not None
    np.testing.assert_allclose(host.fk(sol[0]), target, atol=1e-4)


@pytest.mark.parametrize("mode", ["speed", "quality"])
def test_native_speed_quality_cross_path(pair, mode):
    """The native solve and the port's Robot.ik on one problem both reach
    the target (not necessarily on the same branch)."""
    robot, host = pair
    rng = np.random.default_rng(18 if mode == "speed" else 19)
    lo, hi = robot.joint_limits()
    target = robot.fk(rng.uniform(lo, hi))
    x0 = rng.uniform(lo, hi)
    sol_n = host.ik(target, x0, tol_f=1e-10, solution_mode=mode)
    sol_p = robot.ik(SolverConfig.create(mode, tol_f=1e-10), target, x0)
    assert sol_n is not None and sol_p is not None
    np.testing.assert_allclose(host.fk(sol_n[0]), target, atol=1e-4)
    np.testing.assert_allclose(robot.fk(np.array(sol_p[0])), target,
                               atol=1e-4)


def test_native_diff_ik_contracts(pair):
    """alpha in [0, 1], |v| <= v_max, and J_W v == alpha V."""
    robot, host = pair
    rng = np.random.default_rng(13)
    lo, hi = robot.joint_limits()
    v_we = np.array([0.0, 0.0, 0.1, 0.0, 0.0, 0.0])
    v_max = np.full(7, 0.75)
    for _ in range(10):
        q = rng.uniform(lo, hi)
        res = host.diff_ik(q, v_we, v_max)
        assert res is not None
        alpha, v = res
        assert -1e-6 <= alpha <= 1.0 + 1e-6
        assert np.all(np.abs(v) <= v_max + 1e-6)
        T = host.fk(q)
        jl = host.jacobian(q)
        jw = np.vstack([T[:3, :3] @ jl[:3], T[:3, :3] @ jl[3:]])
        np.testing.assert_allclose(jw @ v, alpha * v_we, atol=1e-6)


def test_native_diff_ik_matches_python(pair):
    robot, host = pair
    rng = np.random.default_rng(14)
    lo, hi = robot.joint_limits()
    v_we = np.array([0.02, -0.05, 0.1, 0.0, 0.1, -0.04])
    v_max = np.full(7, 0.5)
    for _ in range(10):
        q = rng.uniform(lo, hi)
        res_n = host.diff_ik(q, v_we, v_max)
        res_p = robot.diff_ik(q, v_we, v_max)
        assert (res_n is None) == (res_p is None)
        if res_n is not None:
            assert abs(res_n[0] - res_p[0]) < 1e-6
