"""Runtime invariant checks (counterpart of utils/invariants.py).

The reference drops into pdb on invariant violations; the JAX package makes
the same invariants checkable in three modes, chosen by the environment
variable GAPARTNET_CHECKS or by `set_mode` / `check_mode`:

  * "off":  no checks (the default): a check costs nothing, not even a
    host sync;
  * "host": assertions on values copied to the host;
  * "jit":  in the JAX package, checkify checks inside jitted code.  The
    port runs eagerly, so "jit" asserts on the host exactly as "host" does.

Call sites use `check(pred, msg)`.  `check_traced` is the JAX package's
check for code that always runs under jit (active in "jit" mode only,
where a host-mode read would fail on a tracer); the port has no tracer,
so it is active in both "host" and "jit".  The JAX `checked_jit` (jit under
checkify, so that "jit"-mode checks raise) has no counterpart: without jit
every check raises where it is made, and a wrapper would be the identity.
"""

import contextlib
import os

import torch

MODES = ("off", "host", "jit")
_MODE = os.environ.get("GAPARTNET_CHECKS", "off")


def set_mode(mode: str) -> None:
    global _MODE
    if mode not in MODES:
        raise ValueError(f"GAPARTNET_CHECKS mode {mode!r} is not one of {MODES}")
    _MODE = mode


def mode() -> str:
    return _MODE


@contextlib.contextmanager
def check_mode(mode: str):
    global _MODE
    old = _MODE
    set_mode(mode)
    try:
        yield
    finally:
        _MODE = old


def check(pred, msg: str, **fmt) -> None:
    """pred: a scalar bool (a tensor on any device, or a Python bool); in
    "host" and "jit" mode it is copied to the host and asserted."""
    if _MODE == "off":
        return
    value = bool(pred.item()) if isinstance(pred, torch.Tensor) else bool(pred)
    assert value, msg.format(**fmt) if fmt else msg


def check_traced(pred, msg: str, **fmt) -> None:
    """The JAX package's checks inside always-jitted code: in the port, as
    `check` in "host" and "jit" mode."""
    check(pred, msg, **fmt)


def check_point_voxel_ids(pc_voxel_id: torch.Tensor, point_mask: torch.Tensor) -> None:
    """Every valid point maps to a voxel (the reference's dataset assert)."""
    if _MODE == "off":
        return
    check(torch.all(torch.where(point_mask, pc_voxel_id >= 0, True)),
          "valid point without voxel id")


def check_proposal_consistency(entry_proposal: torch.Tensor, entry_mask: torch.Tensor,
                               num_proposals: int) -> None:
    if _MODE == "off":
        return
    ok1 = torch.all(torch.where(entry_mask, entry_proposal >= 0, True))
    ok2 = torch.all(torch.where(entry_mask, entry_proposal < num_proposals, True))
    check(ok1 & ok2, "proposal ids out of range")
