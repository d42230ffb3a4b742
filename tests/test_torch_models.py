"""The port's copies of the URDF ingest, ChainSpec and SolverConfig agree
with the JAX package's (exact equality: both are the same float64 numpy code
on the same files)."""

import dataclasses

import numpy as np
import pytest

import optik_tpu
from optik_tpu.models import ChainSpec as JaxSpec
from optik_tpu.models import asset_path as jax_asset_path

import optik_tpu_torch
from optik_tpu_torch.models import ChainSpec, asset_path

MODELS = [("panda.urdf", "panda_link0", "panda_hand_tcp"),
          ("ur3e.urdf", "ur_base_link", "ur_ee_link"),
          ("ur5.urdf", "base_link", "ee_link")]


def _assert_specs_equal(a, b):
    for f in dataclasses.fields(JaxSpec):
        va, vb = getattr(a, f.name), getattr(b, f.name)
        if f.name == "joint_names":
            assert tuple(va) == tuple(vb)
        else:
            np.testing.assert_array_equal(np.asarray(va), np.asarray(vb),
                                          err_msg=f.name)


@pytest.mark.parametrize("urdf,base,ee", MODELS)
def test_chain_spec_matches_jax(urdf, base, ee):
    assert asset_path(urdf).resolve() == jax_asset_path(urdf).resolve()
    ref = JaxSpec.from_urdf_file(jax_asset_path(urdf), base, ee)
    got = ChainSpec.from_urdf_file(asset_path(urdf), base, ee)
    _assert_specs_equal(ref, got)
    assert got.num_positions == ref.num_positions
    for r, g in zip(ref.joint_limits(), got.joint_limits()):
        np.testing.assert_array_equal(r, g)


@pytest.mark.parametrize("urdf,base,ee", MODELS)
def test_chain_spec_from_arrays_round_trips(urdf, base, ee):
    ref = JaxSpec.from_urdf_file(jax_asset_path(urdf), base, ee)
    got = ChainSpec.from_arrays(dataclasses.asdict(ref))
    _assert_specs_equal(ref, got)
    again = ChainSpec.from_arrays(dataclasses.asdict(got))
    assert again.content_key() == got.content_key()
    with pytest.raises(ValueError):
        ChainSpec.from_arrays({"axis": ref.axis})


def test_solver_config_matches_jax():
    jf = [(f.name, f.default) for f in
          dataclasses.fields(optik_tpu.SolverConfig)]
    tf = [(f.name, f.default) for f in
          dataclasses.fields(optik_tpu_torch.SolverConfig)]
    assert [n for n, _ in jf] == [n for n, _ in tf]
    assert [d for _, d in jf] == [
        optik_tpu.SolutionMode[d.name] if isinstance(
            d, optik_tpu_torch.SolutionMode) else d for _, d in tf]
    for kw in ({}, {"max_restarts": 64, "seed_batch": 8, "max_iters": 32},
               {"tol_f": 1e-4, "tol_df": 1e-9},
               {"max_restarts": 0, "tol_dx": 1e-6}):
        j = optik_tpu.SolverConfig.create("quality", **kw)
        t = optik_tpu_torch.SolverConfig.create("quality", **kw)
        assert j.total_restarts == t.total_restarts
        assert j.effective_tol_df == t.effective_tol_df
        assert t.solution_mode == optik_tpu_torch.SolutionMode.QUALITY
        assert t.replace(seed_batch=4).seed_batch == 4
    with pytest.raises(ValueError):
        optik_tpu_torch.SolverConfig.create("fastest")
