"""Train-state checkpoints and stand-alone adapter weights (port of
motioneditor_tpu/training/checkpoint.py), with ``torch.save`` and
``torch.load(weights_only=True)``. The same layout as the JAX package:

  <output_dir>/checkpoint-<step>/state.pt           trainables, optimizer, step
  <output_dir>/controlnet_adapter_checkpoint-<step>/adapter.pt
                                                    the adapter's state_dict

``latest_checkpoint`` reproduces the reference's resume by directory name
(train_bg.py:279-293).
"""

from __future__ import annotations

import os
import os.path as osp
import re
from typing import Optional, Tuple

import torch
from torch import nn

from motioneditor_tpu_torch.training.common import TrainState

STATE_FILE = "state.pt"
ADAPTER_FILE = "adapter.pt"


def save_train_state(output_dir: str, step: int, state: TrainState) -> str:
    path = osp.abspath(osp.join(output_dir, f"checkpoint-{step}"))
    os.makedirs(path, exist_ok=True)
    payload = {"trainable": {n: p.detach() for n, p in state.trainable.items()},
               "opt_state": state.optimizer.state_dict(), "step": step}
    torch.save(payload, osp.join(path, STATE_FILE))
    return path


def _load(path: str) -> dict:
    return torch.load(osp.join(path, STATE_FILE), map_location="cpu", weights_only=True)


@torch.no_grad()
def _copy_into(values: dict, params: dict, path: str) -> None:
    missing = sorted(set(values) - set(params))
    if missing:
        raise KeyError(f"{path}: parameters not in the model: {missing[:5]}")
    for name, value in values.items():
        params[name].copy_(value)


def load_trainables(path: str, model: nn.Module) -> int:
    """Copy the trainables saved under ``path`` into ``model``'s parameters
    of the same names (each cast to its parameter's dtype and device);
    returns the checkpoint's step."""
    payload = _load(path)
    _copy_into(payload["trainable"], dict(model.named_parameters()), path)
    return int(payload["step"])


def restore_train_state(path: str, state: TrainState) -> TrainState:
    """Restore the trainables, the optimizer state and the step into an
    existing state over the same trainables."""
    payload = _load(path)
    if set(payload["trainable"]) != set(state.trainable):
        raise KeyError(f"{path}: its trainables differ from the state's")
    _copy_into(payload["trainable"], state.trainable, path)
    state.optimizer.load_state_dict(payload["opt_state"])
    state.step = int(payload["step"])
    return state


def save_adapter(output_dir: str, step: int, adapter: nn.Module) -> str:
    path = osp.abspath(osp.join(output_dir, f"controlnet_adapter_checkpoint-{step}"))
    os.makedirs(path, exist_ok=True)
    torch.save(adapter.state_dict(), osp.join(path, ADAPTER_FILE))
    return path


def load_adapter(path: str, adapter: nn.Module) -> nn.Module:
    state = torch.load(osp.join(path, ADAPTER_FILE), map_location="cpu", weights_only=True)
    adapter.load_state_dict(state)
    return adapter


def latest_checkpoint(output_dir: str) -> Optional[Tuple[str, int]]:
    """Find checkpoint-<N> with the largest N (train_bg.py:279-293)."""
    if not osp.isdir(output_dir):
        return None
    best = None
    for name in os.listdir(output_dir):
        m = re.fullmatch(r"checkpoint-(\d+)", name)
        if m:
            step = int(m.group(1))
            if best is None or step > best[1]:
                best = (osp.join(output_dir, name), step)
    return best
