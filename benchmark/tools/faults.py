"""Faults planted in the timed path, underneath the harness: the program's
entry point that a cell's window calls, wrapped so that its answers go
wrong in one of the ways a later change could make them. A run with a
fault planted has to come out not correct.

    plant(cell_name, kind)   # before the cell's driver runs

Kinds: ``unchanged`` (the step returns its state, or the match its
starts, unchanged), ``half`` (the second half of the batch left out: its
answers are its starts), ``altered`` (an answer moved by ``SHIFT`` where
it is made: one scan's pose, or the last 1/32 of the hypotheses of every
fourth call).
"""

from __future__ import annotations

import torch

SHIFT = 0.05   # one cell of the cells' 0.05 m maps


def _shifted(pose: torch.Tensor, rows=slice(None)) -> torch.Tensor:
    out = pose.clone()
    out[..., rows, 0] += SHIFT
    return out


def session_fault(kind):
    import hector_slam_tpu_torch.session as hs_session
    real = hs_session.slam_step_jit
    calls = [0]

    def step(state, scan, cfg, hint=None, known=False):
        new, metrics = real(state, scan, cfg, hint, known)
        calls[0] += 1
        if kind == "unchanged":
            return state, metrics
        if calls[0] == 150:     # "altered": one pose, where it is made
            new = new._replace(pose=_shifted(new.pose[None])[0])
        return new, metrics
    return hs_session, "slam_step_jit", step


def reloc_fault(kind):
    import hector_slam_tpu_torch as hs
    real = hs.match_hypotheses_kernel_jit
    calls = [0]

    def match(levels, begin, scan, cfg, quads=None):
        res, diag = real(levels, begin, scan, cfg, quads=quads)
        calls[0] += 1
        b = begin.shape[0]
        if kind == "unchanged":
            return res._replace(pose=begin.clone()), diag
        if kind == "half":      # the second half of the batch left out
            keep = (torch.arange(b, device=begin.device) < b // 2)[:, None]
            return res._replace(pose=torch.where(keep, res.pose, begin)), diag
        # "altered": the batch's last 1/32 (one thread block of 128 at
        # 4096), in one call of every four
        if calls[0] % 4 == 0:
            return res._replace(pose=_shifted(
                res.pose, slice(b - max(1, b // 32), b))), diag
        return res, diag
    return hs, "match_hypotheses_kernel_jit", match


FAULTS = {"live40": (session_fault, ("unchanged", "altered")),
          "reloc4096": (reloc_fault, ("unchanged", "half", "altered"))}


def wrapper(cell_name: str, kind: str):
    """(module, attribute, broken entry point) of a cell's fault."""
    make, kinds = FAULTS[cell_name.split(".")[0]]
    if kind not in kinds:
        raise KeyError(f"{cell_name} has no fault {kind!r}")
    return make(kind)


def plant(cell_name: str, kind: str) -> None:
    target, name, broken = wrapper(cell_name, kind)
    setattr(target, name, broken)
