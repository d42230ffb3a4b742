"""The port's multi-device IK (``optik_tpu_torch/parallel``) on gloo ranks.

One world of 4 CPU ranks per module (``parallel/launch.py``), from a module
fixture; every case runs on a mesh over its first ``data * seed`` ranks
(meshes of 1, 2 and 4 ranks).  The ranks import torch only; the JAX side
runs here, on the conftest's fake-device mesh, on the same numpy inputs.

  * ``ik_sharded`` (the plain lockstep loop, lanes partitioned) against the
    JAX package's ``ik_sharded`` at f64: equal found masks, equal winners
    (each winner's iterations-to-converge), x within 1e-8 (the limit of
    ``tests/test_torch_lm.py``: torch and XLA round a few operations
    differently and ~30 accepted LM steps amplify that), equal
    ``lane_iters``; and against the port's own unsharded solve: equal found
    masks, winners and ``lane_iters``, x within 1e-12 (torch's CPU
    transcendentals take a vector or a scalar path by an element's
    position in its tensor, which moves the last bit between shapes);
  * ``build_seed_sharded_solver`` (plain versions on the CPU, kernel math
    mode, f32) against the JAX one in Pallas interpret mode, with the
    limits of ``tests/test_torch_lm.py``: masks differ on at most 1 of 16
    poses, x within 1e-3 on shared winners (equal iterations-to-converge;
    Quality: seed distances within 1e-3), every found cost <= tol_f; on
    the Panda and on a 12-joint arm (``models.synthetic.chain_urdf(12)``,
    in a world of its own), wider than the Panda as the Pallas kernel and
    the CUDA kernel both take;
  * port against port, bitwise (kernel math has no transcendental call):
    the seed-sharded found mask against the single-device solve in both
    modes, Quality x and cost, the (1, 1) mesh, data-axis invariance and
    repeats (the contracts of ``tests/test_seed_sharded.py``);
    ``build_sharded_cascade`` shard by shard against ``Robot.ik_batch``;
  * the validation errors, with the JAX package's strings.
"""

import dataclasses
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from optik_tpu import Robot as JaxRobot
from optik_tpu import SolverConfig as JaxConfig
from optik_tpu.models import asset_path
from optik_tpu.parallel import mesh as jax_mesh

from optik_tpu_torch import Robot, SolverConfig
from optik_tpu_torch.models import ChainSpec
from optik_tpu_torch.models.synthetic import chain_urdf
from optik_tpu_torch.ops.cuda import lm_kernel
from optik_tpu_torch.parallel import launch
from optik_tpu_torch.solver import ik, lm_soa

WORLD = 4
LOCKSTEP_SHAPES = [(2, 2), (4, 1), (1, 4)]
SEED_KW = dict(max_restarts=16, seed_batch=4, max_iters=8)
B_SEED = 16


def _jax_robot(dtype):
    return JaxRobot.from_urdf_file(asset_path("panda.urdf"), "panda_link0",
                                   "panda_hand_tcp", dtype=dtype)


def _jax_chain12():
    return JaxRobot.from_urdf_str(chain_urdf(12), "l0", "l12",
                                  dtype=jnp.float32)


def _lockstep_problem(jr):
    """tests/test_sharding.py's problem: 8 targets, x0 at the origin."""
    rng = np.random.default_rng(0)
    lo, hi = jr.joint_limits()
    r, t = jr.fk_batch(rng.uniform(lo, hi, size=(8, 7)))
    x0 = np.tile(np.clip(np.zeros(7), lo, hi), (8, 1))
    return np.asarray(r), np.asarray(t), x0


def _seed_problem(jr, b, seed):
    """tests/test_seed_sharded.py's problem at f32."""
    rng = np.random.default_rng(seed)
    lo, hi = jr.joint_limits()
    tr, tt = jr.fk_batch(rng.uniform(lo, hi, size=(b, lo.shape[0])))
    x0 = rng.uniform(lo, hi, size=(b, lo.shape[0])).astype(np.float32)
    return np.asarray(tr, np.float32), np.asarray(tt, np.float32), x0


LOCK_CFG = dict(speed=SolverConfig(max_restarts=16),
                quality=SolverConfig.create("quality", max_restarts=16))


def _cases(spec, jr64, jr32):
    """Every case of the module, in one list: {name: Case}."""
    lock = _lockstep_problem(jr64)
    cases = {}
    for shape in LOCKSTEP_SHAPES:
        cases[("lockstep", "speed", shape)] = launch.Case(
            "ik_sharded", LOCK_CFG["speed"], *shape, lock,
            dtype=torch.float64)
    cases[("lockstep", "quality", (2, 2))] = launch.Case(
        "ik_sharded", LOCK_CFG["quality"], 2, 2, lock, dtype=torch.float64)
    for mode, seed in (("speed", 0), ("quality", 1)):
        prob = _seed_problem(jr32, B_SEED, seed)
        cfg = SolverConfig.create(mode, **SEED_KW)
        for shape in ((2, 2), (1, 4), (1, 1)):
            cases[("seed", mode, shape)] = launch.Case(
                "seed_sharded", cfg, *shape, prob, repeat=2)
    inv = _seed_problem(jr32, 32, 4)
    for shape in ((1, 2), (2, 2), (4, 1)):
        cases[("invariance", shape)] = launch.Case(
            "seed_sharded", SolverConfig.create("speed", **SEED_KW), *shape,
            inv)
    casc = _seed_problem(jr32, 16, 5)
    cases[("cascade", (2, 1))] = launch.Case(
        "cascade", SolverConfig(max_restarts=24, seed_batch=8, max_iters=16),
        2, 1, casc)
    # Rejected inputs (each raises on every rank before any collective).
    p16, p6, p3 = _seed_problem(jr32, 16, 6), _seed_problem(jr32, 6, 6), \
        _seed_problem(jr32, 3, 6)
    errors = {
        "divisible": ("seed_sharded", SolverConfig(max_restarts=10), 1, 4,
                      p16),
        "quality_max_successes": (
            "seed_sharded", SolverConfig.create(
                "quality", max_restarts=16, quality_max_successes=2),
            1, 4, p16),
        "multiple": ("seed_sharded", SolverConfig(max_restarts=16,
                                                  seed_batch=4), 4, 1, p6),
        "cascade multiple": ("cascade", SolverConfig(max_restarts=16), 4, 1,
                             p6),
        "not divisible": ("ik_sharded", SolverConfig(max_restarts=16), 2, 2,
                          p3),
        "lanes": ("ik_sharded", SolverConfig(max_restarts=16, seed_batch=2),
                  1, 4, p16),
        "mesh shape": ("ik_sharded", SolverConfig(max_restarts=16), 3, 2,
                       p16),
    }
    for name, args in errors.items():
        cases[("error", name)] = launch.Case(*args)
    return cases


@pytest.fixture(scope="module")
def world():
    """(port spec, JAX robots, cases, each rank's results by case name)."""
    jr64, jr32 = _jax_robot(jnp.float64), _jax_robot(jnp.float32)
    spec = ChainSpec.from_arrays(dataclasses.asdict(jr64.spec))
    cases = _cases(spec, jr64, jr32)
    names = list(cases)
    ranks = launch.spawn(launch.solve, WORLD, [cases[n] for n in names],
                         spec, "cpu", timeout=300)
    results = [dict(zip(names, r)) for r in ranks]
    return spec, jr64, jr32, cases, results


@pytest.fixture(scope="module")
def world12():
    """As ``world``, for the 12-joint arm's seed-sharded cases: a world of
    its own, since a rank runs every case on one chain."""
    jr32 = _jax_chain12()
    spec = ChainSpec.from_arrays(dataclasses.asdict(jr32.spec))
    cases = {("seed12", mode, (2, 2)): launch.Case(
        "seed_sharded", SolverConfig.create(mode, **SEED_KW), 2, 2,
        _seed_problem(jr32, B_SEED, seed))
        for mode, seed in (("speed", 0), ("quality", 1))}
    names = list(cases)
    ranks = launch.spawn(launch.solve, WORLD, [cases[n] for n in names],
                         spec, "cpu", timeout=300)
    results = [dict(zip(names, r)) for r in ranks]
    return spec, None, jr32, cases, results


def _result(world, name):
    """Rank 0's results of one case, after checking that every rank of the
    case's mesh returned the same full batch."""
    *_, results = world
    got = results[0][name]
    assert isinstance(got, list), got
    for other in results[1:]:
        if other[name] is not None:
            for a, b in zip(got, other[name]):
                for f in ("found", "x", "cost", "iters"):
                    assert torch.equal(getattr(a, f), getattr(b, f)), f
    return got


@pytest.mark.parametrize("shape", LOCKSTEP_SHAPES)
def test_ik_sharded_matches_jax(world, shape):
    spec, jr64, _, cases, _ = world
    got = _result(world, ("lockstep", "speed", shape))[0]
    tr, tt, x0 = cases[("lockstep", "speed", shape)].inputs
    m = jax_mesh.make_mesh(jax.devices()[:shape[0] * shape[1]],
                           data=shape[0], seed=shape[1])
    ref = jax_mesh.ik_sharded(jr64, JaxConfig(max_restarts=16), tr, tt, x0,
                              m)
    found = np.asarray(ref.found)
    assert found.sum() >= 6  # the comparison exercises real solves
    np.testing.assert_array_equal(got.found.numpy(), found)
    np.testing.assert_array_equal(got.iters.numpy(), np.asarray(ref.iters))
    np.testing.assert_allclose(got.x.numpy(), np.asarray(ref.x), rtol=0,
                               atol=1e-8)
    np.testing.assert_allclose(got.cost.numpy()[found],
                               np.asarray(ref.cost)[found], rtol=0,
                               atol=1e-12)
    assert int(got.lane_iters) == int(ref.lane_iters)
    assert int(got.found_count) == int(found.sum())


@pytest.mark.parametrize("mode,shape", [("speed", s) for s in LOCKSTEP_SHAPES]
                         + [("quality", (2, 2))])
def test_ik_sharded_matches_the_unsharded_port(world, mode, shape):
    spec, *_ = world
    case = world[3][("lockstep", mode, shape)]
    got = _result(world, ("lockstep", mode, shape))[0]
    ref = ik.build_batch_solver(spec, LOCK_CFG[mode], torch.float64,
                                device="cpu")(*case.inputs)
    assert torch.equal(got.found, ref.found)
    assert torch.equal(got.iters, ref.iters)
    torch.testing.assert_close(got.x, ref.x, rtol=0, atol=1e-12)
    assert int(got.lane_iters) == int(ref.lane_iters)
    if mode == "quality":
        # The winner is the first least seed distance in lane order.
        d_got = torch.linalg.vector_norm(got.x - torch.tensor(
            case.inputs[2]), dim=-1)[got.found]
        torch.testing.assert_close(d_got, ref.sel_key[ref.found], rtol=0,
                                   atol=1e-12)


def _assert_seed_sharded_matches_jax(world, jr32, name, mode):
    cases = world[3]
    case = cases[name]
    got = _result(world, name)[0]
    m = jax_mesh.make_mesh(jax.devices()[:4], data=2, seed=2)
    ref = jax_mesh.build_seed_sharded_solver(
        jr32, JaxConfig.create(mode, **SEED_KW), m, interpret=True,
        p_blk=4)(*case.inputs)
    x0 = case.inputs[2]
    f_ref, f_got = np.asarray(ref.found), got.found.numpy()
    assert f_ref.sum() >= B_SEED - 4
    assert (f_ref != f_got).sum() <= 1
    assert np.all(np.asarray(ref.cost)[f_ref] <= case.cfg.tol_f)
    assert np.all(got.cost.numpy()[f_got] <= case.cfg.tol_f)
    x_ref, x_got = np.asarray(ref.x), got.x.numpy()
    if mode == "speed":
        same = f_ref & f_got & (np.asarray(ref.iters) == got.iters.numpy())
    else:
        d_ref = np.linalg.norm(x_ref - x0, axis=1)
        d_got = np.linalg.norm(x_got - x0, axis=1)
        same = f_ref & f_got & (np.abs(d_ref - d_got) <= 1e-3)
    assert same.sum() >= f_ref.sum() - 2
    dx = np.abs(x_got - x_ref)[same].max(axis=1)
    assert (dx > 1e-3).sum() <= 1 and dx.max() <= 5e-3, dx
    # Not-found poses: the (x0, +inf) sentinel, as in the JAX package.
    np.testing.assert_array_equal(x_got[~f_got], x0[~f_got])
    assert np.all(np.isinf(got.cost.numpy()[~f_got]))


@pytest.mark.parametrize("mode", ["speed", "quality"])
def test_seed_sharded_matches_jax_interpret(world, mode):
    _assert_seed_sharded_matches_jax(world, world[2], ("seed", mode, (2, 2)),
                                     mode)


@pytest.mark.parametrize("mode", ["speed", "quality"])
def test_seed_sharded_matches_jax_interpret_chain12(world12, mode):
    """The same on a 12-joint arm: the port's KernelPlan takes the chain
    (its plain version here, the kernel on the card) as the Pallas kernel
    does in interpret mode."""
    assert world12[0].num_positions == 12
    _assert_seed_sharded_matches_jax(world12, world12[2],
                                     ("seed12", mode, (2, 2)), mode)


def _single_device(spec, case):
    plan = lm_kernel.KernelPlan(spec, case.cfg)
    tr, tt, x0 = (torch.tensor(v) for v in case.inputs)
    return lm_kernel.select(plan, lm_kernel.solve_lanes(plan, tr, tt, x0), x0)


@pytest.mark.parametrize("mode", ["speed", "quality"])
@pytest.mark.parametrize("shape", [(2, 2), (1, 4), (1, 1)])
def test_seed_sharded_found_mask_is_the_single_device_one(world, mode,
                                                          shape):
    spec, *_ = world
    case = world[3][("seed", mode, shape)]
    first, again = _result(world, ("seed", mode, shape))
    ref = _single_device(spec, case)
    found = ref.found
    assert bool(found.any())
    assert torch.equal(first.found, found)
    if mode == "quality" or shape == (1, 1):
        # Quality explores the full budget on every rank: the merged
        # winner is the single-device one, bitwise.  So is every winner of
        # the (1, 1) mesh.
        assert torch.equal(first.x[found], ref.x[found])
        assert torch.equal(first.cost[found], ref.cost[found])
    else:
        assert bool((first.cost[found] <= case.cfg.tol_f).all())
    for f in ("found", "x", "cost", "iters", "lane_iters"):
        assert torch.equal(getattr(first, f), getattr(again, f)), f
    assert int(first.found_count) == int(found.sum())


def test_seed_sharded_is_data_axis_invariant(world):
    base = _result(world, ("invariance", (1, 2)))[0]
    other = _result(world, ("invariance", (2, 2)))[0]
    for f in ("found", "x", "cost", "iters"):
        assert torch.equal(getattr(base, f), getattr(other, f)), f
    # No seed split: the single-device solve, bitwise.
    spec, *_ = world
    whole = _result(world, ("invariance", (4, 1)))[0]
    ref = _single_device(spec, world[3][("invariance", (4, 1))])
    assert torch.equal(whole.found, ref.found)
    assert torch.equal(whole.x[ref.found], ref.x[ref.found])


def test_sharded_cascade_matches_the_facade_shard_by_shard(world):
    spec, *_ = world
    case = world[3][("cascade", (2, 1))]
    got = _result(world, ("cascade", (2, 1)))[0]
    robot = Robot(spec, device="cpu")
    tr, tt, x0 = case.inputs
    lane_iters = 0
    for sl in (slice(0, 8), slice(8, 16)):
        ref = robot.ik_batch(case.cfg, tr[sl], tt[sl], x0[sl])
        for f in ("found", "x", "cost", "iters"):
            assert torch.equal(getattr(got, f)[sl], getattr(ref, f)), f
        lane_iters += int(ref.lane_iters)
    assert int(got.lane_iters) == lane_iters
    assert int(got.overflow_count) == 0
    assert int(got.found_count) == int(got.found.sum()) >= 12


@pytest.mark.parametrize("name", ["divisible", "quality_max_successes",
                                  "multiple", "cascade multiple",
                                  "not divisible", "lanes", "mesh shape"])
def test_validation_errors(world, name):
    *_, results = world
    err = results[0][("error", name)]
    assert isinstance(err, ValueError), err
    want = {"cascade multiple": "multiple", "lanes": "seed lanes"}
    assert want.get(name, name) in str(err)
    for other in results[1:]:
        if other[("error", name)] is not None:
            assert str(other[("error", name)]) == str(err)


class _Counting(lm_soa.LaneReduce):
    def __init__(self):
        self.calls = {"group_any": 0, "group_sum": 0, "all_stopped": 0}

    def group_any(self, t, dim):
        self.calls["group_any"] += 1
        return super().group_any(t, dim)

    def group_sum(self, t, dim):
        self.calls["group_sum"] += 1
        return super().group_sum(t, dim)

    def all_stopped(self, stopped):
        self.calls["all_stopped"] += 1
        return super().all_stopped(stopped)


@pytest.mark.parametrize("mode", ["speed", "quality"])
def test_reduction_hook_default_leaves_lm_loop_unchanged(world, mode):
    """The default hook is the local reduction: an explicit LaneReduce and
    a subclass that only counts its calls give bitwise the default loop's
    results, and the hook is called at the three meeting places only."""
    spec, *_ = world
    jr64 = world[1]
    tr, tt, x0 = _lockstep_problem(jr64)
    cfg = SolverConfig.create(mode, max_restarts=16, seed_batch=4,
                              max_iters=16,
                              quality_max_successes=2 if mode == "quality"
                              else 0)
    plan = lm_kernel.KernelPlan(spec, cfg)
    tr, tt = torch.tensor(tr), torch.tensor(tt)
    x0 = torch.tensor(x0)
    seeds = plan.seeds(x0.float()).double()
    table = plan.table(x0.device).double()
    outs = []
    for reduce in (None, lm_soa.LaneReduce(), _Counting()):
        outs.append(lm_soa.solve_soa(
            plan.consts, plan.lower, plan.upper, plan.opts, seeds,
            tr[:, None], tt[:, None], seed_table=table,
            lane_index=torch.arange(plan.s, dtype=torch.int32),
            total_restarts=plan.r_total, success_stops_group=plan.freeze,
            explore_full_budget=plan.quality, quality_x0=x0[:, None],
            group_success_cap=plan.cap or None, reduce=reduce))
    for other in outs[1:]:
        for f in ("x", "f", "success", "restart_index", "succ_iters"):
            assert torch.equal(getattr(outs[0], f), getattr(other, f)), f
        assert other.iters == outs[0].iters
    calls = reduce.calls
    it = outs[0].iters
    assert it < (cfg.max_iters + 1) * 4  # stopped before the budget ran out
    assert calls["all_stopped"] == it + 1
    assert calls["group_any"] == (it if mode == "speed" else 0)
    assert calls["group_sum"] == (it if mode == "quality" else 0)


def test_initialize_is_idempotent_and_pod_mesh_keeps_the_jax_rules():
    """``distributed.initialize`` twice, ``pod_mesh`` and its error string,
    in a fresh interpreter holding a gloo group of one rank."""
    code = (
        "import torch.distributed as dist\n"
        "from optik_tpu_torch.parallel import distributed, launch\n"
        "addr = f'localhost:{launch.free_port()}'\n"
        "distributed.initialize(addr, 1, 0, backend='gloo')\n"
        "distributed.initialize(addr, 1, 0, backend='gloo')\n"
        "m = distributed.pod_mesh()\n"
        "assert m.shape == {'data': 1, 'seed': 1} and m.coord == (0, 0)\n"
        "try:\n"
        "    distributed.pod_mesh(seed_per_host=2)\n"
        "except ValueError as e:\n"
        "    assert 'seed_per_host must divide local device count' in str(e)\n"
        "else:\n"
        "    raise AssertionError('pod_mesh(2) on one rank did not raise')\n"
        "dist.destroy_process_group()\n"
        "print('ok')\n")
    repo = pathlib.Path(__file__).resolve().parent.parent
    out = subprocess.run([sys.executable, "-c", code], cwd=repo,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
