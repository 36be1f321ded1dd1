"""Checkpoints of the fit state: the parameters, the optimizer's state and
the step (counterpart of `tpu_ray/utils/checkpoint.py`, with torch.save
in place of orbax).

A checkpoint of step s is <directory>/<s>/state.pt, written to a
temporary file in the step's directory and renamed into place
(os.replace), so a step directory without state.pt is an interrupted
write and is never read. The newest `max_to_keep` steps are kept.
"""

from __future__ import annotations

import dataclasses
import os
import shutil
from typing import Dict, Optional

import torch

STATE = "state.pt"


@dataclasses.dataclass(frozen=True)
class CheckpointManager:
    directory: str
    max_to_keep: int = 3

    def steps(self) -> list:
        """The steps with a complete checkpoint, ascending."""
        if not os.path.isdir(self.directory):
            return []
        return sorted(int(n) for n in os.listdir(self.directory)
                      if n.isdigit() and os.path.isfile(os.path.join(self.directory, n, STATE)))

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None


def make_manager(directory: str, max_to_keep: int = 3) -> CheckpointManager:
    directory = os.path.abspath(directory)
    os.makedirs(directory, exist_ok=True)
    return CheckpointManager(directory, max_to_keep)


def save(mngr: CheckpointManager, step: int, params: Dict[str, torch.Tensor],
         optimizer: torch.optim.Optimizer) -> None:
    """Write step's checkpoint, then drop all but the newest max_to_keep."""
    step_dir = os.path.join(mngr.directory, str(step))
    os.makedirs(step_dir, exist_ok=True)
    tmp = os.path.join(step_dir, STATE + ".tmp")
    torch.save({"params": {k: v.detach() for k, v in params.items()},
                "opt_state": optimizer.state_dict(), "step": step}, tmp)
    os.replace(tmp, os.path.join(step_dir, STATE))
    for old in mngr.steps()[:-mngr.max_to_keep]:
        shutil.rmtree(os.path.join(mngr.directory, str(old)))


def restore_latest(mngr: CheckpointManager, params: Dict[str, torch.Tensor],
                   optimizer: torch.optim.Optimizer) -> Optional[int]:
    """Load the newest checkpoint into params (in place) and the optimizer
    -> its step, or None if the directory holds none. params: the same
    paths, shapes and dtypes as were saved."""
    step = mngr.latest_step()
    if step is None:
        return None
    device = next(iter(params.values())).device
    state = torch.load(os.path.join(mngr.directory, str(step), STATE),
                       map_location=device, weights_only=True)
    if set(state["params"]) != set(params):
        raise ValueError(f"checkpoint of step {step} holds {sorted(state['params'])}, "
                         f"the fit trains {sorted(params)}")
    with torch.no_grad():
        for k, v in params.items():
            v.copy_(state["params"][k])
    optimizer.load_state_dict(state["opt_state"])
    return state["step"]
