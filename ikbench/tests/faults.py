"""Faults planted under the timed path, for the tests that see ``correct``
come out false.  Each is a ``harness.Ctx.patch`` ("module:function"), run
in every process of a run after the program is imported."""

import torch

from optik_tpu_torch import Robot
from optik_tpu_torch.parallel import mesh as mesh_mod

_ik_batch = Robot.ik_batch
_diff_ik_batch = Robot.diff_ik_batch


def ik_state_unchanged():
    """Every pose returns its seed, found, at no cost."""
    def ik_batch(self, cfg, tgt_r, tgt_t, x0, **kw):
        res = _ik_batch(self, cfg, tgt_r, tgt_t, x0, **kw)
        found = torch.ones_like(res.found)
        return res._replace(found=found, x=x0.clone(),
                            cost=torch.zeros_like(res.cost),
                            found_count=found.sum())
    Robot.ik_batch = ik_batch


def ik_half_batch():
    """The second half of every batch is left out: not found."""
    def ik_batch(self, cfg, tgt_r, tgt_t, x0, **kw):
        res = _ik_batch(self, cfg, tgt_r, tgt_t, x0, **kw)
        half = res.found.shape[0] // 2
        found = res.found.clone()
        found[half:] = False
        return res._replace(found=found, found_count=found.sum())
    Robot.ik_batch = ik_batch


def ik_answer_altered():
    """Every answer's joints are moved by 0.05 rad where it is made."""
    def ik_batch(self, cfg, tgt_r, tgt_t, x0, **kw):
        res = _ik_batch(self, cfg, tgt_r, tgt_t, x0, **kw)
        return res._replace(x=res.x + 0.05)
    Robot.ik_batch = ik_batch


def mesh_exchange_left_out():
    """``Mesh.merge`` without its collectives: each rank keeps its own
    pick and places it in its own rows of the batch."""
    def merge(self, out, key):
        n, i = self.shape["data"], self.index("data")
        b = out.found.shape[0]

        def place(t):
            full = torch.zeros((n * b,) + tuple(t.shape[1:]), dtype=t.dtype,
                               device=t.device)
            full[i * b:(i + 1) * b] = t
            return full
        return (place(out.found), place(out.x), place(out.cost),
                place(out.iters.to(torch.int32)))
    mesh_mod.Mesh.merge = merge


def diffik_state_unchanged():
    """Every lane returns no motion, ok."""
    def diff_ik_batch(self, x0, v_we, v_max, **kw):
        alpha, v, ok = _diff_ik_batch(self, x0, v_we, v_max, **kw)
        return torch.zeros_like(alpha), torch.zeros_like(v), \
            torch.ones_like(ok)
    Robot.diff_ik_batch = diff_ik_batch


def diffik_half_batch():
    """The second half of every call is left out: not ok."""
    def diff_ik_batch(self, x0, v_we, v_max, **kw):
        alpha, v, ok = _diff_ik_batch(self, x0, v_we, v_max, **kw)
        ok = ok.clone()
        ok[ok.shape[0] // 2:] = False
        return alpha, v, ok
    Robot.diff_ik_batch = diff_ik_batch


def diffik_answer_altered():
    """Every step's joint velocities are scaled by 1.01 where they are
    made."""
    def diff_ik_batch(self, x0, v_we, v_max, **kw):
        alpha, v, ok = _diff_ik_batch(self, x0, v_we, v_max, **kw)
        return alpha, v * 1.01, ok
    Robot.diff_ik_batch = diff_ik_batch
