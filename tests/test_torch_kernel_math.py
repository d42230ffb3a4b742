"""The CUDA kernel's arithmetic, compiled for the host, against the plain
version.

There is no CUDA compiler on a CPU-only machine, but the math of
``optik_tpu_torch/csrc/lm_kernel.cu`` (everything between ``namespace {``
and the solve itself) is plain C++ once ``__device__`` and
``__forceinline__`` are defined away.  This test cuts that part out, puts a
robot's generated ``optik_chain.h`` beside it, builds it with ``g++``
without multiply-add contraction, and holds ``residual_and_jtask`` (FK with
the chain's static terms folded at compile time, the SE(3) log, the task
Jacobian, the weights) against ``soa.residual_and_jtask`` in kernel math
mode on the same float32 inputs: every value bit for bit, a chain with
prismatic joints and skew axes included, and chains wider than the Panda
(the 11-joint mobile Panda, a 16-joint arm).  The run-time-chain form
(``-DOPTIK_RUNTIME_CHAIN=1``: the chain read from
``lm_kernel.pack_runtime_chain``'s array, the per-lane vectors in strided
memory) is built once per weighting and held to the same standard on the
same chains and on 40 and 64 joints: one host program for every chain, as
one library serves every chain on the card.  It skips where there is no
``g++``.

One allowance: torch's CPU ``sqrt`` is not correctly rounded for every
float32 (about 0.6% of values differ from IEEE in the last bit), while C's
``sqrtf`` and the card's are; the comparison gives the plain version numpy's
``sqrt``.
"""

import pathlib
import shutil
import subprocess
from typing import NamedTuple

import numpy as np
import pytest
import torch

from optik_tpu_torch import SolverConfig
from optik_tpu_torch.models import ChainSpec, asset_path
from optik_tpu_torch.models.synthetic import chain_urdf, mobile_panda_urdf
from optik_tpu_torch.ops import soa
from optik_tpu_torch.ops.cuda import lm_kernel

N = 1024
WEIGHTS = dict(linear_weight=(0.0, 1.0, 1.0), angular_weight=(0.5, 1.0, 2.0))

# Skew axes, general joint frames, two prismatic joints, no tip.
ODD_URDF = """<robot name="odd">
<link name="b"/><link name="l1"/><link name="l2"/><link name="l3"/>
<link name="l4"/><link name="ee"/>
<joint name="j1" type="revolute"><parent link="b"/><child link="l1"/>
<origin xyz="0.1 0.2 0.3" rpy="0.3 -0.7 1.1"/><axis xyz="0.6 0 0.8"/>
<limit lower="-2" upper="2"/></joint>
<joint name="j2" type="prismatic"><parent link="l1"/><child link="l2"/>
<origin xyz="0 0 0.2" rpy="0 1.5707963267948966 0"/><axis xyz="0 0 1"/>
<limit lower="-0.3" upper="0.4"/></joint>
<joint name="j3" type="revolute"><parent link="l2"/><child link="l3"/>
<origin xyz="0.05 -0.1 0" rpy="1.2 0.4 -0.9"/><axis xyz="0 1 0"/>
<limit lower="-3" upper="3"/></joint>
<joint name="j4" type="prismatic"><parent link="l3"/><child link="l4"/>
<origin xyz="0 0.3 0" rpy="0.2 0.1 0.5"/><axis xyz="0.36 0.48 0.8"/>
<limit lower="-0.2" upper="0.2"/></joint>
<joint name="j5" type="revolute"><parent link="l4"/><child link="ee"/>
<origin xyz="0 0 0.1" rpy="0 0 0"/><axis xyz="1 0 0"/>
<limit lower="-3" upper="3"/></joint>
</robot>"""

SHIM = """
#include <math.h>
#include <stdint.h>
#include <stdio.h>
#define __host__
#define __device__
#define __forceinline__ inline __attribute__((always_inline))
#define __ldg(p) (*(p))
static inline float rsqrtf(float x) { return 1.0f / sqrtf(x); }
#include "optik_chain.h"
#define OPTIK_QUALITY 0
#define OPTIK_WEIGHTED %d
#define OPTIK_WIDE 0
"""

# The run-time chain: no header; the chain is data.
RUNTIME_SHIM = SHIM.replace('#include "optik_chain.h"\n',
                            "#define OPTIK_RUNTIME_CHAIN 1\n")

# Reads n, the weights and n x (q, target rotation, target translation);
# writes n x (e[6], jt[6][A], f).
MAIN = """
int main(int argc, char** argv) {
  FILE* fi = fopen(argv[1], "rb");
  FILE* fo = fopen(argv[2], "wb");
  int n;
  float chain[kRuntimeFloats], wl[3], wa[3];
  if (fread(&n, 4, 1, fi) != 1) return 1;
  if (fread(chain, 4, kRuntimeFloats, fi) != kRuntimeFloats) return 1;
  if (fread(wl, 4, 3, fi) != 3 || fread(wa, 4, 3, fi) != 3) return 1;
  Runtime rt;
  for (int i = 0; i < 9; ++i) rt.tip_r[i] = chain[i];
  for (int i = 0; i < 3; ++i) rt.tip_t[i] = chain[9 + i];
  for (int k = 0; k < n; ++k) {
    float q[kDof], tr[9], tt[3], e[6], jt[6][kDof], f, ml[9], ma[9];
    if (fread(q, 4, kDof, fi) != kDof || fread(tr, 4, 9, fi) != 9
        || fread(tt, 4, 3, fi) != 3) return 1;
    for (int i = 0; i < 3; ++i)
      for (int j = 0; j < 3; ++j) {
        ml[3 * i + j] = ((tr[i] * wl[0]) * tr[j] + (tr[3 + i] * wl[1]) * tr[3 + j])
                        + (tr[6 + i] * wl[2]) * tr[6 + j];
        ma[3 * i + j] = ((tr[i] * wa[0]) * tr[j] + (tr[3 + i] * wa[1]) * tr[3 + j])
                        + (tr[6 + i] * wa[2]) * tr[6 + j];
      }
    residual_and_jtask<kDof, kWeighted>(rt, q, tr, tt, ml, ma, kWeighted, kWeighted,
                                        e, jt, f);
    fwrite(e, 4, 6, fo);
    fwrite(jt, 4, 6 * kDof, fo);
    fwrite(&f, 4, 1, fo);
  }
  fclose(fo);
  return 0;
}
"""


# Reads the packed chain's length and the chain, n, the weights and n x (q,
# target rotation, target translation); writes what MAIN writes.
RUNTIME_MAIN = """
#include <vector>
int main(int argc, char** argv) {
  FILE* fi = fopen(argv[1], "rb");
  FILE* fo = fopen(argv[2], "wb");
  int len, n;
  float wl[3], wa[3];
  if (fread(&len, 4, 1, fi) != 1) return 1;
  std::vector<float> chain(len);
  if (fread(chain.data(), 4, len, fi) != (size_t)len) return 1;
  if (fread(&n, 4, 1, fi) != 1) return 1;
  if (fread(wl, 4, 3, fi) != 3 || fread(wa, 4, 3, fi) != 3) return 1;
  Runtime rt;
  for (int i = 0; i < 9; ++i) rt.tip_r[i] = chain[i];
  for (int i = 0; i < 3; ++i) rt.tip_t[i] = chain[9 + i];
  rt.has_tip = chain[12] > 0.5f;
  const int a = rt.dof = (int)chain[13];
  rt.joints = chain.data() + kRuntimeFloats;
  rt.lower = rt.joints + kJointFloats * a;
  rt.upper = rt.lower + a;
  std::vector<float> q(a), jt(6 * a), out(6 * a);
  for (int k = 0; k < n; ++k) {
    float tr[9], tt[3], e[6], f, ml[9], ma[9];
    if (fread(q.data(), 4, a, fi) != (size_t)a || fread(tr, 4, 9, fi) != 9
        || fread(tt, 4, 3, fi) != 3) return 1;
    for (int i = 0; i < 3; ++i)
      for (int j = 0; j < 3; ++j) {
        ml[3 * i + j] = ((tr[i] * wl[0]) * tr[j] + (tr[3 + i] * wl[1]) * tr[3 + j])
                        + (tr[6 + i] * wl[2]) * tr[6 + j];
        ma[3 * i + j] = ((tr[i] * wa[0]) * tr[j] + (tr[3 + i] * wa[1]) * tr[3 + j])
                        + (tr[6 + i] * wa[2]) * tr[6 + j];
      }
    residual_and_jtask_rt<kWeighted>(rt, Strided{q.data(), 1}, tr, tt, ml, ma, kWeighted,
                                     kWeighted, e, Strided{jt.data(), 1}, f);
    // Column j sits at 6 j .. 6 j + 5; write rows as MAIN does.
    for (int i = 0; i < 6; ++i)
      for (int j = 0; j < a; ++j) out[i * a + j] = jt[6 * j + i];
    fwrite(e, 4, 6, fo);
    fwrite(out.data(), 4, 6 * a, fo);
    fwrite(&f, 4, 1, fo);
  }
  fclose(fo);
  return 0;
}
"""


def _spec(name):
    if name.startswith("chain") and int(name[5:]) > 16:
        a = int(name[5:])
        return ChainSpec.from_urdf_str(chain_urdf(a), "l0", f"l{a}")
    if name == "odd":
        return ChainSpec.from_urdf_str(ODD_URDF, "b", "ee")
    if name == "mobile_panda":
        return ChainSpec.from_urdf_str(mobile_panda_urdf(),
                                       "mobile_base", "panda_hand_tcp")
    if name == "chain16":
        return ChainSpec.from_urdf_str(chain_urdf(16), "l0", "l16")
    urdf, base, ee = {"panda": ("panda.urdf", "panda_link0",
                                "panda_hand_tcp"),
                      "ur5": ("ur5.urdf", "base_link", "ee_link")}[name]
    return ChainSpec.from_urdf_file(asset_path(urdf), base, ee)


def _compile(shim, main, weighted, tmp_path) -> pathlib.Path:
    """The kernel's math (from ``namespace {`` to the solve) between
    ``shim`` and ``main`` as a host program."""
    src = lm_kernel.SOURCE.read_text()
    body = src[src.index("namespace {"):src.index("// --- the solve")]
    # g++ spells the unroll request differently; the result is the same.
    body = body.replace("#pragma unroll", "#pragma GCC unroll 16")
    (tmp_path / "math.cpp").write_text(
        shim % int(weighted) + body + "}  // namespace\n" + main)
    exe = tmp_path / "math"
    subprocess.run(["g++", "-O1", "-std=c++17", "-ffp-contract=off", "-o",
                    str(exe), str(tmp_path / "math.cpp")], check=True,
                   capture_output=True)
    return exe


def _host_binary(plan, weighted, tmp_path) -> pathlib.Path:
    """The folded kernel's math for ``plan``'s chain as a host program."""
    (tmp_path / lm_kernel.CHAIN_HEADER).write_text(plan.header)
    return _compile(SHIM, MAIN, weighted, tmp_path)


@pytest.fixture(scope="module")
def runtime_binaries(tmp_path_factory):
    """The run-time chain's math as host programs, one per weighting,
    built once for every chain."""
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to compile the kernel's math for the host")
    return {w: _compile(RUNTIME_SHIM, RUNTIME_MAIN, w,
                        tmp_path_factory.mktemp(f"runtime{int(w)}"))
            for w in (False, True)}


def _check_bitwise(plan, cfg, run, tmp_path):
    """Run the host program ``run.exe`` on N random points of ``plan``'s
    chain and hold its output bitwise against soa.residual_and_jtask."""
    spec, a = plan.spec, plan.a

    rng = np.random.default_rng(0)
    lo, hi = np.asarray(spec.lower), np.asarray(spec.upper)
    q = rng.uniform(lo, hi, size=(N, a)).astype(np.float32)
    qt = rng.uniform(lo, hi, size=(N, a)).astype(np.float32)
    # Near and at the target: the small-angle series of the log and of the
    # SE(3) coefficients.
    q[:64] = qt[:64] + rng.uniform(-1e-4, 1e-4, size=(64, a)).astype(
        np.float32)
    q[64:72] = qt[64:72]

    def full(v):
        return torch.broadcast_to(torch.as_tensor(v, dtype=torch.float32),
                                  (N,))

    _, r_t, t_t = soa.fk_joints(
        plan.consts, [torch.tensor(qt[:, j]) for j in range(a)], approx=True)
    tr = torch.stack([full(r_t[i][j]) for i in range(3) for j in range(3)],
                     dim=1).numpy()
    tt = torch.stack([full(t_t[i]) for i in range(3)], dim=1).numpy()
    with open(tmp_path / "in.bin", "wb") as f:
        f.write(run.head)
        f.write(np.asarray(cfg.linear_weight, np.float32).tobytes())
        f.write(np.asarray(cfg.angular_weight, np.float32).tobytes())
        f.write(np.concatenate([q, tr, tt], axis=1).astype(
            np.float32).tobytes())
    subprocess.run([str(run.exe), str(tmp_path / "in.bin"),
                    str(tmp_path / "out.bin")], check=True)
    got = np.fromfile(tmp_path / "out.bin", np.float32).reshape(
        N, 6 + 6 * a + 1)

    tgtm = [[torch.tensor(tr[:, 3 * i + j]) for j in range(3)]
            for i in range(3)]
    tgtt = [torch.tensor(tt[:, i]) for i in range(3)]
    e, jt = soa.residual_and_jtask(
        plan.consts, [torch.tensor(q[:, j]) for j in range(a)], tgtm, tgtt,
        weight6=soa.weight6_from_config(tgtm, cfg.linear_weight,
                                        cfg.angular_weight), approx=True)
    want = torch.stack([full(v) for v in e]
                       + [full(v) for row in jt for v in row]
                       + [full(soa.vec_dot(e, e))], dim=1).numpy()
    assert np.isfinite(want).all()
    same = got.view(np.int32) == want.view(np.int32)
    assert same.all(), (f"{(~same).any(axis=1).sum()} of {N} points differ, "
                        f"largest |d| {np.abs(got - want).max()}")


class _Run(NamedTuple):
    exe: pathlib.Path
    head: bytes     # what the program reads before the weights


@pytest.mark.parametrize("robot,weighted", [
    ("panda", False), ("panda", True), ("ur5", False), ("odd", False),
    ("mobile_panda", False), ("chain16", False)])
def test_kernel_math_on_the_host_is_bitwise_plain(robot, weighted, tmp_path,
                                                  monkeypatch):
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to compile the kernel's math for the host")
    monkeypatch.setattr(
        torch, "sqrt", lambda t: torch.from_numpy(np.sqrt(t.numpy())))
    cfg = SolverConfig(**WEIGHTS) if weighted else SolverConfig()
    plan = lm_kernel.KernelPlan(_spec(robot), cfg)
    exe = _host_binary(plan, weighted, tmp_path)
    _check_bitwise(plan, cfg, _Run(exe, np.int32(N).tobytes()
                                   + plan.chain.tobytes()), tmp_path)


@pytest.mark.parametrize("robot,weighted", [
    ("panda", False), ("panda", True), ("odd", False),
    ("mobile_panda", False), ("chain16", False), ("chain40", False),
    ("chain64", True)])
def test_runtime_chain_math_on_the_host_is_bitwise_plain(
        robot, weighted, runtime_binaries, tmp_path, monkeypatch):
    """The run-time chain's walk of the packed array, FK through the
    weighted task Jacobian, bit for bit the plain version's."""
    monkeypatch.setattr(
        torch, "sqrt", lambda t: torch.from_numpy(np.sqrt(t.numpy())))
    cfg = SolverConfig(**WEIGHTS) if weighted else SolverConfig()
    plan = lm_kernel.KernelPlan(_spec(robot), cfg, runtime_chain=True)
    assert plan.header is None
    _check_bitwise(plan, cfg, _Run(
        runtime_binaries[weighted], np.int32(plan.chain.size).tobytes()
        + plan.chain.tobytes() + np.int32(N).tobytes()), tmp_path)
