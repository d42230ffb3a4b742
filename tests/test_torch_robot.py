"""The slice as a whole: the port's Robot against the JAX package's Robot,
plus the port's import boundary.

``ik_batch`` runs the main configuration (Speed, 64 restarts, 8 lanes, 32
iterations, tol_f 1e-6) and five workloads of the JAX package's benchmark
scripts at f64 on the CPU through both packages' plain paths: found masks,
iterations and lane-iterations equal, cost within 1e-8 relative.
Tolerance for x: 1e-8 (see tests/test_torch_lm.py: operation order differs
at the last bit and ~30 LM steps amplify it); scalar ``ik`` likewise.
``fk`` runs the same float64 operations on both sides: 1e-12.
"""

import ast
import dataclasses
import pathlib
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import optik_tpu
from optik_tpu.models import asset_path

import optik_tpu_torch
from optik_tpu_torch.models import ChainSpec
from optik_tpu_torch.models.synthetic import mobile_panda_urdf

REPO = pathlib.Path(__file__).resolve().parent.parent
MAIN = dict(max_restarts=64, seed_batch=8, max_iters=32, tol_f=1e-6)
B = 32


@pytest.fixture(scope="module")
def robots():
    args = (asset_path("panda.urdf"), "panda_link0", "panda_hand_tcp")
    return (optik_tpu.Robot.from_urdf_file(*args, dtype=jnp.float64),
            optik_tpu_torch.Robot.from_urdf_file(*args, dtype=torch.float64,
                                                 device="cpu"))


# The main configuration, then the workloads of the JAX package's
# benchmark scripts (the root benchmarks/): Quality at 256 restarts on 64
# lanes, the same under a success cap, the UR5 with every limit at +-pi/2,
# motion planning and the UR3e, the last three in those scripts' call
# form.  (arm, mode, config, B, seed, ik_batch keywords, least found)
QUALITY = dict(max_restarts=256, seed_batch=64, max_iters=48)
CALL_FORM = dict(validate_seeds=False, rescue_overflow=False)
IK_CASES = {
    "panda_main": ("panda", "speed", MAIN, B, 5, {}, B - 1),
    "panda_quality": ("panda", "quality", QUALITY, 16, 11, {}, 15),
    "panda_quality_cap8": ("panda", "quality",
                           dict(QUALITY, quality_max_successes=8), 16, 11,
                           {}, 15),
    "ur5_tight": ("ur5_tight", "speed",
                  dict(max_restarts=64, seed_batch=8, max_iters=48), 16, 12,
                  CALL_FORM, 15),
    "motion_planning": ("panda", "speed",
                        dict(max_restarts=64, seed_batch=8, max_iters=32),
                        16, 13, CALL_FORM, 15),
    "ur3e": ("ur3e", "speed", dict(max_restarts=8, max_iters=48), 16, 14,
             CALL_FORM, 12),
}
ARMS = {"ur5_tight": ("ur5.urdf", "base_link", "ee_link"),
        "ur3e": ("ur3e.urdf", "ur_base_link", "ur_ee_link")}


def _arm(name, robots):
    """Both packages' Robots at f64; the UR5 with every limit at +-pi/2."""
    if name == "panda":
        return robots
    urdf, base, ee = ARMS[name]
    jr = optik_tpu.Robot.from_urdf_file(asset_path(urdf), base, ee,
                                        dtype=jnp.float64)
    if name == "ur5_tight":
        n = jr.num_positions()
        jr = optik_tpu.Robot(dataclasses.replace(
            jr.spec, lower=np.full(n, -np.pi / 2), upper=np.full(n, np.pi / 2)),
            dtype=jnp.float64)
    spec = ChainSpec.from_arrays(dataclasses.asdict(jr.spec))
    return jr, optik_tpu_torch.Robot(spec, dtype=torch.float64, device="cpu")


@pytest.mark.parametrize("case", list(IK_CASES))
def test_ik_batch_matches_jax_main_config(robots, case):
    arm, mode, kw, b, seed, call, least = IK_CASES[case]
    jr, tr_ = _arm(arm, robots)
    rng = np.random.default_rng(seed)
    lo, hi = jr.joint_limits()
    n = len(lo)
    rot, trans = jr.fk_batch(rng.uniform(lo, hi, size=(b, n)))
    rot, trans = np.asarray(rot), np.asarray(trans)
    x0 = rng.uniform(lo, hi, size=(b, n))
    ref = jr.ik_batch(optik_tpu.SolverConfig.create(mode, **kw), rot, trans,
                      x0, **call)
    cfg = optik_tpu_torch.SolverConfig.create(mode, **kw)
    got = tr_.ik_batch(cfg, rot, trans, x0, **call)

    found = np.asarray(ref.found)
    assert found.sum() >= least
    np.testing.assert_array_equal(got.found.numpy(), found)
    np.testing.assert_allclose(got.x.numpy()[found], np.asarray(ref.x)[found],
                               rtol=0, atol=1e-8)
    np.testing.assert_allclose(got.cost.numpy(), np.asarray(ref.cost),
                               rtol=1e-8, atol=1e-12)
    np.testing.assert_array_equal(got.iters.numpy(), np.asarray(ref.iters))
    assert int(got.lane_iters) == int(ref.lane_iters)
    assert np.all(got.cost.numpy()[found] <= cfg.tol_f)
    # FK of every found solution reaches its target (cost <= 1e-6 is a
    # residual of ~1e-3).
    r_got, t_got = tr_.fk_batch(got.x[got.found])
    np.testing.assert_allclose(r_got.numpy(), rot[found], atol=2e-3)
    np.testing.assert_allclose(t_got.numpy(), trans[found], atol=2e-3)


def test_ik_batch_matches_jax_mobile_panda():
    """The main configuration on the 11-joint mobile Panda (the Panda on a
    holonomic base with a lift, ``models.synthetic.mobile_panda_urdf``), a
    chain the CUDA kernel takes since it is built for 1..32 joints: at f64
    on the CPU through both facades, with the limits of the Panda case
    above."""
    args = (mobile_panda_urdf(), "mobile_base", "panda_hand_tcp")
    jr = optik_tpu.Robot.from_urdf_str(*args, dtype=jnp.float64)
    tr_ = optik_tpu_torch.Robot.from_urdf_str(*args, dtype=torch.float64,
                                              device="cpu")
    assert tr_.num_positions() == 11
    rng = np.random.default_rng(5)
    lo, hi = jr.joint_limits()
    rot, trans = jr.fk_batch(rng.uniform(lo, hi, size=(B, 11)))
    rot, trans = np.asarray(rot), np.asarray(trans)
    x0 = rng.uniform(lo, hi, size=(B, 11))
    ref = jr.ik_batch(optik_tpu.SolverConfig(**MAIN), rot, trans, x0)
    cfg = optik_tpu_torch.SolverConfig(**MAIN)
    got = tr_.ik_batch(cfg, rot, trans, x0)

    found = np.asarray(ref.found)
    assert found.sum() >= B - 1
    np.testing.assert_array_equal(got.found.numpy(), found)
    np.testing.assert_allclose(got.x.numpy()[found], np.asarray(ref.x)[found],
                               rtol=0, atol=1e-8)
    assert np.all(got.cost.numpy()[found] <= MAIN["tol_f"])
    r_got, t_got = tr_.fk_batch(got.x[got.found])
    np.testing.assert_allclose(r_got.numpy(), rot[found], atol=2e-3)
    np.testing.assert_allclose(t_got.numpy(), trans[found], atol=2e-3)
    # On the card the same float32 solve runs the kernel; float64 runs the
    # plain loop there, as here.
    from optik_tpu_torch.ops.cuda import lm_kernel

    assert lm_kernel.kernel_runs(tr_.spec, cfg, torch.float32, "cuda")
    assert not lm_kernel.kernel_runs(tr_.spec, cfg, torch.float64, "cuda")


def test_ik_batch_wide_chain_on_the_plain_version():
    """A 40-joint arm through the port's ``Robot.ik_batch`` at float32 on the
    CPU, the main configuration, B = 16: the plain loop here, the
    run-time-chain kernel on the card (``kernel_runs`` holds for it there).
    Every found x reaches its target: its cost at f64 is within tol_f (plus
    1e-8 for the float32 FK's rounding over 40 joints) and its FK within
    2e-3; a repeat and a sub-batch solve are bitwise equal.  These are the
    contracts chip_smoke.py holds the kernel to at this width."""
    from optik_tpu_torch.models.synthetic import chain_urdf
    from optik_tpu_torch.ops import soa
    from optik_tpu_torch.ops.cuda import lm_kernel

    a, b = 40, 16
    robot = optik_tpu_torch.Robot.from_urdf_str(chain_urdf(a), "l0", f"l{a}",
                                                device="cpu")
    cfg = optik_tpu_torch.SolverConfig(**MAIN)
    assert lm_kernel.kernel_runs(robot.spec, cfg, torch.float32, "cuda")
    rng = np.random.default_rng(40)
    lo, hi = robot.joint_limits()
    rot, trans = robot.fk_batch(rng.uniform(lo, hi, size=(b, a)))
    x0 = torch.tensor(rng.uniform(lo, hi, size=(b, a)), dtype=torch.float32)
    res = robot.ik_batch(cfg, rot, trans, x0)
    assert res.x.dtype == torch.float32 and res.x.shape == (b, a)
    assert int(res.found.sum()) >= b - 1
    found = res.found
    assert bool((res.cost[found] <= cfg.tol_f).all())
    x64 = res.x[found].double()
    e, _ = soa.residual_and_jtask(
        soa.chain_constants(robot.spec), [x64[:, j] for j in range(a)],
        [[rot[found][:, i, k].double() for k in range(3)] for i in range(3)],
        [trans[found][:, i].double() for i in range(3)])
    cost64 = sum(v * v for v in e)
    assert float(cost64.max()) <= cfg.tol_f + 1e-8
    r_got, t_got = robot.fk_batch(res.x[found])
    torch.testing.assert_close(r_got, rot[found], rtol=0, atol=2e-3)
    torch.testing.assert_close(t_got, trans[found], rtol=0, atol=2e-3)
    again = robot.ik_batch(cfg, rot, trans, x0)
    head = robot.ik_batch(cfg, rot[:5], trans[:5], x0[:5])
    for f in ("found", "x", "cost", "iters"):
        assert torch.equal(getattr(again, f), getattr(res, f)), f
        assert torch.equal(getattr(head, f), getattr(res, f)[:5]), f


def test_fk_matches_jax(robots):
    jr, tr_ = robots
    rng = np.random.default_rng(6)
    ee = np.eye(4)
    ee[:3, :3] = [[0.0, 0.0, 1.0], [0.0, 1.0, 0.0], [-1.0, 0.0, 0.0]]
    ee[:3, 3] = [0.01, 0.02, -0.1]
    for _ in range(4):
        q = tr_.random_configuration(rng)
        np.testing.assert_allclose(tr_.fk(q), jr.fk(q), rtol=0, atol=1e-12)
        np.testing.assert_allclose(tr_.fk(q, ee), jr.fk(q, ee), rtol=0,
                                   atol=1e-12)
    qs = rng.uniform(*jr.joint_limits(), size=(5, 7))
    for got, ref in zip(tr_.fk_batch(qs, ee), jr.fk_batch(qs, ee)):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                                   atol=1e-12)


@pytest.mark.parametrize("kw", [MAIN, dict(max_restarts=8, seed_batch=8,
                                           max_iters=32)],
                         ids=["main", "eight_restarts"])
def test_ik_single_pose(robots, kw):
    jr, tr_ = robots
    cfg = optik_tpu_torch.SolverConfig(**kw)
    q = tr_.random_configuration(np.random.default_rng(7))
    target = tr_.fk(q)
    seed = np.zeros(7).clip(*tr_.joint_limits())
    sol = tr_.ik(cfg, target, seed)
    assert sol is not None
    x, cost = sol
    assert len(x) == 7 and cost <= cfg.tol_f
    np.testing.assert_allclose(tr_.fk(np.array(x)), target, atol=2e-3)
    # The JAX package's scalar solve reaches the same solution.
    ref = jr.ik(optik_tpu.SolverConfig(**kw), target, seed)
    np.testing.assert_allclose(x, ref[0], rtol=0, atol=1e-8)
    np.testing.assert_allclose(cost, ref[1], rtol=1e-8, atol=1e-12)
    # Unreachable target: None, as in the reference.
    far = target.copy()
    far[:3, 3] += 10.0
    assert tr_.ik(cfg.replace(max_restarts=8), far, seed) is None


def _error(fn):
    with pytest.raises(ValueError) as info:
        fn()
    return str(info.value)


def test_error_strings_match_jax(robots):
    jr, tr_ = robots
    jc = optik_tpu.SolverConfig(**MAIN)
    tc = optik_tpu_torch.SolverConfig(**MAIN)
    x0 = np.zeros(7).clip(*jr.joint_limits())
    hi = jr.joint_limits()[1]
    cases = [
        (lambda r, c: r.ik(c, np.eye(4) * 2.0, x0),
         "invalid target transform specified"),
        (lambda r, c: r.ik(c, np.eye(3), x0),
         "invalid target transform specified"),
        (lambda r, c: r.ik(c, np.eye(4), x0[:3]), "len(x0) != num_positions"),
        (lambda r, c: r.ik(c, np.eye(4), hi + 1.0),
         "seed joint position outside of joint limits"),
        (lambda r, c: r.ik_batch(c, np.eye(3)[None], np.zeros((1, 3)),
                                 (hi + 1.0)[None]),
         "seed joint position outside of joint limits"),
        (lambda r, c: r.fk(np.zeros(3)), "len(x) != num_positions"),
    ]
    for fn, msg in cases:
        assert _error(lambda: fn(jr, jc)) == msg
        assert _error(lambda: fn(tr_, tc)) == msg


def test_device_defaults_and_unported_options(robots, monkeypatch):
    _, tr_ = robots
    assert tr_.num_positions() == 7
    tr_.set_parallelism(4)
    # lm_kernel.build_kernel_solver raises for more than 64 seed lanes per
    # pose (at plan build, before anything is launched; the facade routes
    # such configs to the plain loop instead) and for any dtype but float32.
    from optik_tpu_torch.ops.cuda import lm_kernel

    wide = optik_tpu_torch.SolverConfig(max_restarts=256, seed_batch=128)
    with pytest.raises(NotImplementedError, match="S=128"):
        lm_kernel.build_kernel_solver(tr_.spec, wide)
    lm_kernel.build_kernel_solver(tr_.spec, wide.replace(seed_batch=64))
    f64 = torch.zeros(1, 7, dtype=torch.float64)
    monkeypatch.setattr(torch.Tensor, "device",
                        property(lambda self: torch.device("cuda", 0)))
    with pytest.raises(TypeError, match="float32"):
        lm_kernel._check_cuda_f32(x0=f64)
    monkeypatch.undo()
    # The default device is the card; without one it raises instead of
    # moving to the CPU.
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        optik_tpu_torch.Robot(tr_.spec)


@pytest.mark.parametrize("mode", ["speed", "quality"])
def test_more_than_64_lanes_match_jax(robots, mode):
    """S = 128 seed lanes per pose, more than the CUDA kernel holds: the
    facade routes the config to the plain loop (on the card as here), and
    the JAX facade to its XLA path.  At f64 on the CPU: found masks equal,
    x within 1e-8 (as for the main config above)."""
    jr, tr_ = robots
    rng = np.random.default_rng(8)
    lo, hi = jr.joint_limits()
    n = 8
    rot, trans = jr.fk_batch(rng.uniform(lo, hi, size=(n, 7)))
    rot, trans = np.asarray(rot), np.asarray(trans)
    x0 = rng.uniform(lo, hi, size=(n, 7))
    kw = dict(max_restarts=256, seed_batch=128, max_iters=12, tol_f=1e-6)
    ref = jr.ik_batch(optik_tpu.SolverConfig.create(mode, **kw), rot, trans,
                      x0)
    got = tr_.ik_batch(optik_tpu_torch.SolverConfig.create(mode, **kw), rot,
                       trans, x0)
    found = np.asarray(ref.found)
    assert found.sum() >= n // 2
    np.testing.assert_array_equal(got.found.numpy(), found)
    np.testing.assert_allclose(got.x.numpy()[found], np.asarray(ref.x)[found],
                               rtol=0, atol=1e-8)
    assert np.all(got.cost.numpy()[found] <= kw["tol_f"])


def test_unlimited_restarts_match_jax(robots):
    """``max_restarts=0`` at f64 on the CPU against the JAX package: rounds
    of 64 restarts re-solve only the unfound poses with the next slice of
    the restart stream.  A per-attempt budget of 3 iterations makes
    one-round failures common.  Found masks equal; x within 1e-8 (as for the main
    config above); poses found in round 1 keep that round's result bit for
    bit; ``sel_key`` stays internal."""
    jr, tr_ = robots
    rng = np.random.default_rng(7)
    lo, hi = jr.joint_limits()
    n = 12
    rot, trans = jr.fk_batch(rng.uniform(lo, hi, size=(n, 7)))
    rot, trans = np.asarray(rot), np.asarray(trans)
    x0 = rng.uniform(lo, hi, size=(n, 7))
    kw = dict(max_restarts=64, max_iters=3, seed_batch=8)
    unl = dict(kw, max_restarts=0, unlimited_rounds_cap=6)

    ref = jr.ik_batch(optik_tpu.SolverConfig(**unl), rot, trans, x0)
    one = tr_.ik_batch(optik_tpu_torch.SolverConfig(**kw), rot, trans, x0)
    got = tr_.ik_batch(optik_tpu_torch.SolverConfig(**unl), rot, trans, x0)

    f1, fu = one.found.numpy(), got.found.numpy()
    assert 0 < f1.sum() < n            # round 1 leaves work for round 2
    assert fu.sum() > f1.sum()         # and later rounds find some of it
    assert (fu | ~f1).all()
    np.testing.assert_array_equal(fu, np.asarray(ref.found))
    np.testing.assert_allclose(got.x.numpy()[fu], np.asarray(ref.x)[fu],
                               rtol=0, atol=1e-8)
    assert torch.equal(got.x[one.found], one.x[one.found])
    assert torch.equal(got.cost[one.found], one.cost[one.found])
    assert np.all(got.cost.numpy()[fu] <= 1e-6)
    # Rounds run at their true size (only the unfound poses), so the work
    # counter grows by less than a full round per round.
    assert int(one.lane_iters) < int(got.lane_iters) < 6 * int(one.lane_iters)
    assert got.sel_key is None and one.sel_key is None
    assert int(got.found_count) == fu.sum()


def test_bench_call_form_runs_on_the_port(robots):
    """bench.py's headline call (``validate_seeds=False,
    rescue_overflow=False``) runs on the port, the flag changes nothing
    (every path is the single-shot schedule) and ``overflow_count`` is 0,
    unlimited rounds included."""
    jr, tr_ = robots
    rng = np.random.default_rng(8)
    lo, hi = jr.joint_limits()
    rot, trans = tr_.fk_batch(rng.uniform(lo, hi, size=(8, 7)))
    x0 = rng.uniform(lo, hi, size=(8, 7))
    for cfg in (optik_tpu_torch.SolverConfig(**MAIN),
                optik_tpu_torch.SolverConfig(**dict(MAIN, max_restarts=0))):
        got = tr_.ik_batch(cfg, rot, trans, x0, validate_seeds=False,
                           rescue_overflow=False)
        ref = tr_.ik_batch(cfg, rot, trans, x0)
        for f in ("found", "x", "cost", "iters", "lane_iters",
                  "overflow_count"):
            assert torch.equal(getattr(got, f), getattr(ref, f)), f
        assert got.overflow_count.dtype == torch.int32
        assert int(got.overflow_count) == 0
        assert bool(got.found.all())


def test_all_hard_batch_matches_single_shot():
    """tests/test_overflow.py's contract on the port: a batch made only of
    poses that fail a one-round screen (8 restarts) but are solvable with
    the full budget (24) gets the single-shot found mask, every pose found,
    and ``overflow_count`` 0 (the port has no capacity to overflow)."""
    from optik_tpu_torch.solver import ik

    cfg = optik_tpu_torch.SolverConfig(max_restarts=24, seed_batch=8,
                                       max_iters=16)
    robot = optik_tpu_torch.Robot.from_urdf_file(
        asset_path("panda.urdf"), "panda_link0", "panda_hand_tcp",
        device="cpu")
    rng = np.random.default_rng(7)
    lo, hi = robot.joint_limits()
    rot, trans = robot.fk_batch(rng.uniform(lo, hi, size=(128, 7)))
    x0 = torch.tensor(rng.uniform(lo, hi, size=(128, 7)),
                      dtype=torch.float32)

    def single_shot(c, r, t, x):
        return ik.build_batch_solver(robot.spec, c, torch.float32,
                                     device="cpu")(r, t, x)

    screen = single_shot(cfg.replace(max_restarts=8), rot, trans, x0).found
    full = single_shot(cfg, rot, trans, x0).found
    hard = torch.nonzero(~screen & full)[:, 0]
    assert hard.numel() >= 1, "no screen-hard poses; loosen the budget"
    idx = hard[torch.arange(32) % hard.numel()]
    res = robot.ik_batch(cfg, rot[idx], trans[idx], x0[idx],
                         validate_seeds=False)
    assert torch.equal(res.found, single_shot(cfg, rot[idx], trans[idx],
                                              x0[idx]).found)
    assert bool(res.found.all())
    assert int(res.overflow_count) == 0
    assert bool((res.cost <= cfg.tol_f).all())
    assert int(res.found_count) == 32


def test_import_adds_no_jax_module():
    code = ("import sys\n"
            "before = {m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'optik_tpu')}\n"
            "import optik_tpu_torch, optik_tpu_torch.robot\n"
            "import optik_tpu_torch.ops.cuda.build\n"
            "import optik_tpu_torch.solver.diffik, optik_tpu_torch.solver.qp\n"
            "import optik_tpu_torch.solver.gauge, optik_tpu_torch.math\n"
            "import optik_tpu_torch.ops.kinematics\n"
            "import optik_tpu_torch.ops.objective\n"
            "import optik_tpu_torch.parallel.launch\n"
            "import optik_tpu_torch.parallel.distributed\n"
            "import optik_tpu_torch.parallel.mesh\n"
            "from optik_tpu_torch.benchmarks import bench_fp32_peak, "
            "exp_warp_probe, exp_bisect\n"
            "import optik_tpu_torch.native\n"
            "from optik_tpu_torch.benchmarks import parity_native, "
            "parity_hard, parity_scipy\n"
            "from optik_tpu_torch.benchmarks import exp_lm_schedule, timing\n"
            "after = {m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'optik_tpu')}\n"
            "print(sorted(after - before))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def _imported_roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_port_sources_import_no_jax():
    files = sorted((REPO / "optik_tpu_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    assert len(files) > 10
    names = {f.name for f in files}
    assert {"build.py", "bench_fp32_peak.py", "exp_warp_probe.py",
            "exp_bisect.py", "diffik.py", "gauge.py", "qp.py", "kinematics.py",
            "objective.py", "so3.py", "se3.py", "linalg.py", "launch.py",
            "distributed.py", "mesh.py", "host.py", "parity_native.py",
            "parity_hard.py", "parity_scipy.py"} <= names
    for path in files:
        bad = {m for m in _imported_roots(path)
               if m in ("jax", "jaxlib", "optik_tpu")}
        assert not bad, f"{path.relative_to(REPO)} imports {sorted(bad)}"
