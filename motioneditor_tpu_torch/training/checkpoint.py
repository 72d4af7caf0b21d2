"""Train-state checkpoints and stand-alone adapter weights (port of
motioneditor_tpu/training/checkpoint.py), with ``torch.save`` and
``torch.load(weights_only=True)``. The same layout as the JAX package:

  <output_dir>/checkpoint-<step>/state.pt           trainables, optimizer, step
  <output_dir>/controlnet_adapter_checkpoint-<step>/adapter.pt
                                                    the adapter's state_dict

``latest_checkpoint`` reproduces the reference's resume by directory name
(train_bg.py:279-293).

Under a model group (parallel/tp.py) the files hold the full tensors, as
orbax writes JAX's logical arrays: saving gathers every split trainable,
its Adam moments (8-bit codes in the unsplit [blocks, 256] layout; their
scales are the full tensor's already) and the adapter's split weights over
the model group, and global rank 0 writes; restoring and loading narrow
them to this rank's blocks again. A file saved under any model group is
the file an unsplit run of the same state writes.
"""

from __future__ import annotations

import os
import os.path as osp
import re
from typing import Optional, Tuple

import torch
from torch import nn

from motioneditor_tpu_torch.parallel import tp
from motioneditor_tpu_torch.training.adam8bit import codes_from_full, codes_to_full
from motioneditor_tpu_torch.training.common import TrainState

STATE_FILE = "state.pt"
ADAPTER_FILE = "adapter.pt"


_MOMENTS = ("exp_avg", "exp_avg_sq", "max_exp_avg_sq")  # AdamW's
_CODES = ("m", "v")  # AdamW8bit's


def _writes(shard_ctx) -> bool:
    import torch.distributed as dist

    return shard_ctx is None or dist.get_rank() == 0


def _split_names(state: TrainState, shard_ctx) -> dict:
    """{trainable name: split dim}; raises when a split state comes without
    the layout of its model group."""
    split = {id(p): dim for p, dim in state.optimizer.split.items()}
    if split and (shard_ctx is None or shard_ctx.tp == 1):
        raise ValueError("the state holds split parameters: pass the layout of their model "
                         "group")
    return {n: split[id(p)] for n, p in state.trainable.items() if id(p) in split}


def _opt_state_map(state: TrainState, sd: dict, names: dict, fn) -> dict:
    """``sd`` (an optimizer state dict) with ``fn(key, tensor, dim, param)``
    applied to every per-parameter state tensor of a split trainable
    ``param``; the rest, and the optimizer's own state, untouched."""
    index = {id(p): i for i, p in enumerate(state.optimizer.params())}
    split = {index[id(state.trainable[n])]: (dim, state.trainable[n]) for n, dim in names.items()}
    packed = {i: ({k: fn(k, v, *split[i]) for k, v in st.items()} if i in split else st)
              for i, st in sd["state"].items()}
    return {**sd, "state": packed}


def save_train_state(output_dir: str, step: int, state: TrainState, shard_ctx=None) -> str:
    """Write the trainables, the optimizer state and the step; under a
    model group ``shard_ctx`` is its layout, every rank gathers and global
    rank 0 writes the full tensors."""
    path = osp.abspath(osp.join(output_dir, f"checkpoint-{step}"))
    names = _split_names(state, shard_ctx)
    trainable = {n: (tp.gather_tensor(p.detach(), names[n], shard_ctx) if n in names
                     else p.detach()) for n, p in state.trainable.items()}

    def full(key, value, dim, param):
        if key in _MOMENTS:
            return tp.gather_tensor(value, dim, shard_ctx)
        if key in _CODES:
            return codes_to_full(tp.gather_tensor(value, dim, shard_ctx))
        return value

    opt_state = _opt_state_map(state, state.optimizer.state_dict(), names, full)
    if _writes(shard_ctx):
        os.makedirs(path, exist_ok=True)
        torch.save({"trainable": trainable, "opt_state": opt_state, "step": step},
                   osp.join(path, STATE_FILE))
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


def _narrowed(values: dict, module: nn.Module, shard_ctx) -> dict:
    """``values`` (full tensors by parameter name) with each parameter that
    ``module`` holds split cut to this rank's block."""
    split = tp.split_parameters(module)
    if split and (shard_ctx is None or shard_ctx.tp == 1):
        raise ValueError("the module is split: pass the layout of its model group")
    return {n: (tp.narrow_tensor(v, split[n], shard_ctx.tp, shard_ctx.model_rank)
                if n in split else v) for n, v in values.items()}


def load_trainables(path: str, model: nn.Module, shard_ctx=None) -> int:
    """Copy the trainables saved under ``path`` into ``model``'s parameters
    of the same names (each cast to its parameter's dtype and device; a
    split parameter takes its block of the saved tensor); returns the
    checkpoint's step."""
    payload = _load(path)
    _copy_into(_narrowed(payload["trainable"], model, shard_ctx),
               dict(model.named_parameters()), path)
    return int(payload["step"])


def restore_train_state(path: str, state: TrainState, shard_ctx=None) -> TrainState:
    """Restore the trainables, the optimizer state and the step into an
    existing state over the same trainables; a split trainable and its
    moments take this rank's blocks of the saved full tensors."""
    payload = _load(path)
    if set(payload["trainable"]) != set(state.trainable):
        raise KeyError(f"{path}: its trainables differ from the state's")
    names = _split_names(state, shard_ctx)
    values = {n: (tp.narrow_tensor(v, names[n], shard_ctx.tp, shard_ctx.model_rank)
                  if n in names else v) for n, v in payload["trainable"].items()}
    _copy_into(values, state.trainable, path)

    def local(key, value, dim, param):
        if key in _CODES:
            full = list(param.shape)
            full[dim] *= shard_ctx.tp
            value = codes_from_full(value, full)
        elif key not in _MOMENTS:
            return value
        return tp.narrow_tensor(value, dim, shard_ctx.tp, shard_ctx.model_rank)

    state.optimizer.load_state_dict(_opt_state_map(state, payload["opt_state"], names, local))
    state.step = int(payload["step"])
    return state


def save_adapter(output_dir: str, step: int, adapter: nn.Module, shard_ctx=None) -> str:
    """Write the adapter's state dict; a split adapter's weights gathered
    over ``shard_ctx``'s model group, written by global rank 0."""
    path = osp.abspath(osp.join(output_dir, f"controlnet_adapter_checkpoint-{step}"))
    split = tp.split_parameters(adapter)
    sd = {n: (tp.gather_tensor(v, split[n], shard_ctx) if n in split else v)
          for n, v in adapter.state_dict().items()}
    if _writes(shard_ctx):
        os.makedirs(path, exist_ok=True)
        torch.save(sd, osp.join(path, ADAPTER_FILE))
    return path


def load_adapter(path: str, adapter: nn.Module, shard_ctx=None) -> nn.Module:
    """Load a full adapter file; a split adapter takes its blocks."""
    state = torch.load(osp.join(path, ADAPTER_FILE), map_location="cpu", weights_only=True)
    adapter.load_state_dict(_narrowed(state, adapter, shard_ctx))
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
