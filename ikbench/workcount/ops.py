"""Count the FP32 operations one lane-iteration of the LM loop needs on a
configuration's chain: the numerator of the roofline bound.

    python3 -m ikbench.workcount.ops --config panda7

A copy of ``optik_tpu_torch.ops.cuda.lm_kernel.fp32_ops_per_lane_iter`` at
commit d444d89, on the chain as ``reference/chain.py`` reads it from the
frozen URDF (fixed joints folded alike).  It counts what the function
needs, not what a kernel executes: the fused residual and task Jacobian
traced by ``opcount.py`` on the chain's constants (static 0 / +-1 terms
folded, the selected side of each select, a repeated subexpression once),
the least count over 64 random configurations and targets (numpy seed 0);
the dense algebra around it by hand (an add, subtract, multiply, divide,
sqrt, rsqrt or floor is 1, a fused multiply-add 2): ``J J^T + lam I``
``21 (2a - 1) + 6``, the 6x6 Cholesky solve 163, the projected step
``13 a``, the cost 11, the Nielsen gain ratio ``6 (2a - 1) + 31``, the
damping update 1 and the cost-change test 1.
"""

from __future__ import annotations

import argparse
import json

import numpy as np

from .. import harness
from ..reference.chain import Chain
from . import opcount, soa


def chain_constants(chain: Chain):
    """``soa``'s static constants of a reference chain."""
    def rows(m):
        return [[float(v) for v in row] for row in m]

    has_tip = not (np.allclose(chain.tip_r, np.eye(3))
                   and np.allclose(chain.tip_t, 0.0))
    return ([rows(j.origin_r) for j in chain.joints],
            [[float(v) for v in j.origin_t] for j in chain.joints],
            [[float(v) for v in j.axis] for j in chain.joints],
            [bool(j.prismatic) for j in chain.joints],
            rows(chain.tip_r), [float(v) for v in chain.tip_t], has_tip)


def fp32_ops_per_lane_iter(chain: Chain, samples: int = 64) -> int:
    consts = chain_constants(chain)
    a = chain.dof
    rng = np.random.default_rng(0)
    lo, hi = chain.lower, chain.upper
    traced = None
    for _ in range(samples):
        trace = opcount.Trace()

        def leaves(name, values):
            return [trace.leaf(f"{name}{i}", float(v))
                    for i, v in enumerate(values)]

        _, r_t, t_t = soa.fk_joints(consts, leaves("qt", rng.uniform(lo, hi)),
                                    approx=True)
        tgt_r = [leaves(f"r{i}", [opcount._val(v) for v in row])
                 for i, row in enumerate(r_t)]
        tgt_t = leaves("t", [opcount._val(v) for v in t_t])
        e, jt = soa.residual_and_jtask(
            consts, leaves("q", rng.uniform(lo, hi)), tgt_r, tgt_t,
            approx=True)
        n = trace.cost(e + [v for row in jt for v in row])
        traced = n if traced is None else min(traced, n)
    dense = (21 * (2 * a - 1) + 6) + 163 + 13 * a + 11 \
        + (6 * (2 * a - 1) + 31) + 1 + 1
    return traced + dense


def count(config: str) -> int:
    cfg = harness.load(harness.HERE / "configs" / f"{config}.json")
    chain = Chain((harness.HERE / "configs" / cfg["urdf"]).read_text(),
                  cfg["base_link"], cfg["ee_link"])
    return fp32_ops_per_lane_iter(chain)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", required=True)
    args = ap.parse_args(argv)
    print(json.dumps({"config": args.config,
                      "fp32_ops_per_lane_iter": count(args.config)}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
