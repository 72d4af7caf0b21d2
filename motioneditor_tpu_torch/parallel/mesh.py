"""Process groups over (data, frames) for frame-sharded execution
(port of motioneditor_tpu/parallel/mesh.py).

The JAX package lays its devices out as a ``(data, frames)`` mesh and lets
GSPMD partition the global arrays. PyTorch has no GSPMD: here each rank is
one process that holds its LOCAL block of every video tensor, the frame
axis split over the ``frames`` group and the batch axis over the ``data``
group, and every op that mixes frames communicates explicitly
(parallel/flash_sharding.py, parallel/frame_ops.py). Ranks are laid out
data-major, as JAX's mesh reshapes its device list: rank = d * fp + f.

The backend follows the device: NCCL for CUDA tensors, gloo only when the
caller asks for the CPU. A one-rank world needs no network (a HashStore).
Parameters are replicated on every rank; training sums the gradients over
the world (training/stage1.py).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True, eq=False)
class FrameShardingCtx:
    """This rank's view of the (data, frames) layout: the frame group (its
    global ranks in frame order, this rank's index ``frame_rank`` and its
    size ``fp``), the data group likewise, and the device the tensors live
    on."""

    frame_group: object
    frame_ranks: Tuple[int, ...]
    data_group: object
    data_ranks: Tuple[int, ...]
    device: torch.device

    @property
    def fp(self) -> int:
        return len(self.frame_ranks)

    @property
    def dp(self) -> int:
        return len(self.data_ranks)

    @property
    def rank(self) -> int:
        return dist.get_rank()

    @property
    def frame_rank(self) -> int:
        return self.frame_ranks.index(self.rank)

    @property
    def data_rank(self) -> int:
        return self.data_ranks.index(self.rank)

    @property
    def world_size(self) -> int:
        return self.fp * self.dp

    def supports(self, f: int) -> bool:
        """The global frame axis divides into at least one frame per shard
        (JAX flash_sharding.py:96-98)."""
        return f % self.fp == 0 and f >= self.fp

    def check(self, x: torch.Tensor) -> None:
        """Raise unless ``x`` lives on this layout's device type: the
        backend was chosen for it, and nothing switches silently."""
        if x.device.type != self.device.type:
            raise ValueError(f"a {self.device.type} frame-sharding context got a tensor on "
                             f"{x.device}")


def backend_for(device: torch.device) -> str:
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available() or not dist.is_nccl_available():
            raise RuntimeError("frame sharding on CUDA needs a CUDA device and NCCL")
        return "nccl"
    if device.type == "cpu":
        return "gloo"
    raise ValueError(f"no backend for device type {device.type}")


def init_frame_sharding(data: int, frames: int, device, rank: int = 0,
                        init_method: Optional[str] = None) -> FrameShardingCtx:
    """Initialize the default process group (world size ``data * frames``)
    if it is not yet, and build the frame and data groups for ``rank``.
    ``init_method`` (e.g. ``tcp://localhost:<port>``) is needed unless the
    world has one rank, which rides a HashStore and needs no network."""
    device = torch.device(device)
    backend = backend_for(device)
    world = data * frames
    if device.type == "cuda" and device.index is not None:
        torch.cuda.set_device(device)
    if not dist.is_initialized():
        if world == 1 and init_method is None:
            dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1)
        else:
            dist.init_process_group(backend, init_method=init_method, rank=rank,
                                    world_size=world)
    if dist.get_backend() != backend:
        raise RuntimeError(f"the process group runs {dist.get_backend()}, the tensors on "
                           f"{device} need {backend}")
    if dist.get_world_size() != world:
        raise ValueError(f"a ({data}, {frames}) layout needs {world} ranks, the world has "
                         f"{dist.get_world_size()}")
    me = dist.get_rank()
    frame_group = data_group = None
    frame_ranks = data_ranks = ()
    # every rank creates every group, in the same order
    for d in range(data):
        ranks = tuple(d * frames + f for f in range(frames))
        g = dist.group.WORLD if data == 1 else dist.new_group(list(ranks))
        if me in ranks:
            frame_group, frame_ranks = g, ranks
    for f in range(frames):
        ranks = tuple(d * frames + f for d in range(data))
        g = dist.group.WORLD if frames == 1 else dist.new_group(list(ranks))
        if me in ranks:
            data_group, data_ranks = g, ranks
    return FrameShardingCtx(frame_group, frame_ranks, data_group, data_ranks, device)


def local_block(x: torch.Tensor, dim: int, parts: int, index: int) -> torch.Tensor:
    """Block ``index`` of ``parts`` equal blocks of ``x`` along ``dim``."""
    size = x.shape[dim]
    if size % parts:
        raise ValueError(f"axis {dim} of size {size} does not split {parts} ways")
    step = size // parts
    return x.narrow(dim, index * step, step).contiguous()


def shard_video(x: torch.Tensor, ctx: FrameShardingCtx, branch_axis: bool = False,
                frame_dim: int = 1) -> torch.Tensor:
    """This rank's block of a global video tensor [B, F, ...]: frames over
    the frame group and, unless ``branch_axis`` (the 2- or 4-row branch axis
    of the edit stays whole), the batch over the data group. ``frame_dim``
    0 cuts a frame-leading tensor such as the injection masks [F, N, 1]."""
    if not ctx.supports(x.shape[frame_dim]):
        raise ValueError(f"{x.shape[frame_dim]} frames do not split {ctx.fp} ways")
    x = local_block(x, frame_dim, ctx.fp, ctx.frame_rank)
    if not branch_axis and frame_dim == 1:
        x = local_block(x, 0, ctx.dp, ctx.data_rank)
    return x


def _all_gather_cat(x: torch.Tensor, group, size: int, dim: int) -> torch.Tensor:
    parts = [torch.empty_like(x) for _ in range(size)]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim=dim)


@torch.no_grad()
def gather_video(x: torch.Tensor, ctx: FrameShardingCtx, branch_axis: bool = False,
                 frame_dim: int = 1) -> torch.Tensor:
    """The global tensor from every rank's block (``shard_video``'s
    inverse), on every rank; not differentiable."""
    ctx.check(x)
    x = _all_gather_cat(x, ctx.frame_group, ctx.fp, frame_dim)
    if not branch_axis and frame_dim == 1:
        x = _all_gather_cat(x, ctx.data_group, ctx.dp, 0)
    return x
