"""The restart queue's pick (``lm_kernel.pick_plain``, the plain version of
``csrc/lm_kernel.cu``'s ``lm_solve_pick_kernel``) against the rule a pose
group's lane applies as it runs its restarts s, s + S, ... in turn: keep a
success whose distance to the caller's seed is strictly below the best so
far, note the first success's iteration.  Random rows with ties, NaN and
infinite distances, slots that never succeed, and budgets that are no
multiple of S; on the CPU."""

import math

import pytest
import torch

from optik_tpu_torch.ops.cuda import lm_kernel


def _rows(b, s, r, a, seed):
    """(A + 4, B * R) rows as the queue writes them, made to tie."""
    g = torch.Generator().manual_seed(seed)
    n = b * r
    x = torch.randn(a, n, generator=g)
    f = torch.rand(n, generator=g) * 1e-6
    ok = torch.rand(n, generator=g) < 0.4
    # Few distinct distances, so equal ones meet in a slot often.
    d = torch.randint(0, 6, (n,), generator=g).float() / 4
    d[torch.rand(n, generator=g) < 0.05] = float("nan")
    d = torch.where(ok, d, torch.full_like(d, float("inf")))
    sit = torch.where(ok, torch.randint(1, 49, (n,), generator=g), 0)
    # A success may still read inf (an infinite seed): it never wins.
    d[ok & (torch.rand(n, generator=g) < 0.02)] = float("inf")
    f = torch.where(ok, f, torch.rand(n, generator=g))
    iters = torch.randint(1, 50, (n,), generator=g).int()
    # The first pose never succeeds.
    ok_first = slice(0, r)
    d[ok_first] = float("inf")
    sit[ok_first] = 0
    return torch.cat([x, f[None], d[None],
                      sit.int().view(torch.float32)[None],
                      iters.view(torch.float32)[None]])


def _lane_rule(rows, a, b, s, r, reseed):
    """What lane s of pose p writes after its restarts, one at a time."""
    x = rows[:a].reshape(a, b, r)
    f = rows[a].reshape(b, r)
    d = rows[a + 1].reshape(b, r)
    sit = rows[a + 2].view(torch.int32).reshape(b, r)
    out = {"x": torch.zeros(b, s, a), "f": torch.full((b, s), math.inf),
           "success": torch.zeros(b, s, dtype=torch.bool),
           "restart_index": torch.zeros(b, s, dtype=torch.int32),
           "succ_iters": torch.zeros(b, s, dtype=torch.int32)}
    for p in range(b):
        for lane in range(s):
            bd, first = math.inf, 0
            for k in range(lane, r, s):
                if first == 0 and int(sit[p, k]) > 0:
                    first = int(sit[p, k])
                if reseed and float(d[p, k]) < bd:
                    bd = float(d[p, k])
                    out["x"][p, lane] = x[:, p, k]
                    out["f"][p, lane] = f[p, k]
                    out["restart_index"][p, lane] = k
            if not reseed:
                out["x"][p, lane] = x[:, p, lane]
                out["f"][p, lane] = f[p, lane]
                out["restart_index"][p, lane] = lane
                out["success"][p, lane] = first > 0
            else:
                out["success"][p, lane] = bd < math.inf
            out["succ_iters"][p, lane] = first
    return out


# (poses, lanes, restarts, joints, reseed)
CASES = [(6, 4, 16, 7, True), (5, 3, 20, 7, True), (4, 8, 60, 11, True),
         (3, 64, 256, 7, True), (7, 8, 8, 7, False)]


@pytest.mark.parametrize("b,s,r,a,reseed", CASES)
def test_pick_is_the_lanes_rule(b, s, r, a, reseed):
    rows = _rows(b, s, r, a, seed=b * 1000 + r)
    got = lm_kernel.pick_plain(rows, a, b, s, r, reseed)
    want = _lane_rule(rows, a, b, s, r, reseed)
    for name, v in want.items():
        assert torch.equal(getattr(got, name), v), name
    iters = rows[a + 3].view(torch.int32).reshape(b, r)
    assert torch.equal(got.pose_iters[:, 0], iters.sum(1).int())
    assert int(got.lane_iters) == int(iters.sum())
    if reseed:
        # Ties met: some slot held two successes at its least distance.
        d = rows[a + 1].reshape(b, r)
        assert int(got.success.sum()) > 0 and bool((d[:, s:] == d[:, :-s]
                                                    ).any())
