"""Process groups over (data, frames, model) for frame-sharded and
tensor-parallel execution (port of motioneditor_tpu/parallel/mesh.py).

The JAX package lays its devices out as a ``(data, frames)`` mesh and lets
GSPMD partition the global arrays. PyTorch has no GSPMD: here each rank is
one process that holds its LOCAL block of every video tensor, the frame
axis split over the ``frames`` group and the batch axis over the ``data``
group, and every op that mixes frames communicates explicitly
(parallel/flash_sharding.py, parallel/frame_ops.py). The optional third
size is the ``model`` group of tensor parallelism (parallel/tp.py): its
ranks hold the same tokens and split the attention heads. Ranks are laid
out data-major and model-minor, as JAX's mesh reshapes its device list:
rank = (d * fp + f) * tp + m.

The backend follows the device: NCCL for CUDA tensors, gloo only when the
caller asks for the CPU, or when it names gloo explicitly (two ranks that
share one card, which NCCL refuses). A one-rank world needs no network (a
HashStore). Parameters are replicated on every rank but for the attention
projections that parallel/tp.py splits over the model group. A sum over
tokens (a loss share, a replicated parameter's gradient) runs over the
``shard`` group, the frame x data ranks of one model rank, and never over
the model group, whose ranks hold the same tokens; a split quantity (a
reduction over heads, a split gradient's squares) is summed over the model
group.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True, eq=False)
class FrameShardingCtx:
    """This rank's view of the (data, frames, model) layout: the frame
    group (its global ranks in frame order, this rank's index
    ``frame_rank`` and its size ``fp``), the data group and the model group
    likewise, and the device the tensors live on. A one-rank model group
    (``tp`` 1) has no group of its own."""

    frame_group: object
    frame_ranks: Tuple[int, ...]
    data_group: object
    data_ranks: Tuple[int, ...]
    device: torch.device
    model_group: object = None
    model_ranks: Tuple[int, ...] = ()
    shard_group: object = None
    shard_ranks: Tuple[int, ...] = ()

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
    def tp(self) -> int:
        return max(1, len(self.model_ranks))

    @property
    def model_rank(self) -> int:
        return self.model_ranks.index(self.rank) if self.model_ranks else 0

    @property
    def world_size(self) -> int:
        return self.fp * self.dp * self.tp

    @property
    def shards(self) -> int:
        """The ranks that hold different tokens of the same parameters:
        frames x data."""
        return self.fp * self.dp

    @property
    def shards_frames(self) -> bool:
        """Whether the frame-mixing ops take this layout's frame route. A
        (d, 1, T > 1) layout holds every frame on every rank and runs the
        unsharded kernels, as JAX's ``for_mesh`` returns no frame context
        for a mesh whose frame axis is 1 (flash_sharding.py:102-104); a
        one-rank (1, 1) layout keeps the frame route."""
        return self.fp > 1 or self.tp == 1

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
                        init_method: Optional[str] = None, model: int = 1,
                        backend: Optional[str] = None) -> FrameShardingCtx:
    """Initialize the default process group (world size ``data * frames *
    model``) if it is not yet, and build the frame, data, (``model`` > 1)
    model and shard groups for ``rank``. ``init_method`` (e.g.
    ``tcp://localhost:<port>``) is needed unless the world has one rank,
    which rides a HashStore and needs no network. ``backend`` None follows
    the device (``backend_for``); "gloo" with CUDA tensors lets ranks share
    one card (gloo all-reduces and broadcasts CUDA tensors through the
    host, but gathers none). Every rank must call it with the same sizes:
    every rank creates every group."""
    device = torch.device(device)
    backend = backend or backend_for(device)
    world = data * frames * model
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
        raise ValueError(f"a ({data}, {frames}, {model}) layout needs {world} ranks, the "
                         f"world has {dist.get_world_size()}")
    me = dist.get_rank()
    grid = torch.arange(world).reshape(data, frames, model)  # rank = (d fp + f) tp + m
    found = {}
    # every rank creates every group, in the same order; a one-rank model
    # group is none
    for kind, lines in (("frame", grid.permute(0, 2, 1).reshape(-1, frames)),
                        ("data", grid.permute(1, 2, 0).reshape(-1, data)),
                        ("model", grid.reshape(-1, model) if model > 1 else []),
                        ("shard", grid.permute(2, 0, 1).reshape(model, -1))):
        for line in [tuple(x.tolist()) for x in lines]:
            g = dist.group.WORLD if len(line) == world else dist.new_group(list(line))
            if me in line:
                found[kind] = (g, line)
    model_group, model_ranks = found.get("model", (None, ()))
    return FrameShardingCtx(*found["frame"], *found["data"], device, model_group, model_ranks,
                            *found["shard"])


@torch.no_grad()
def sum_over_shards(tensors, ctx: FrameShardingCtx) -> None:
    """All-reduce (sum) each tensor in place over ``ctx``'s shard group,
    the frame x data ranks of this model rank: a sum over the tokens of a
    quantity every model rank holds whole (a loss share, a gradient)."""
    if ctx.shards == 1:
        return
    for t in tensors:
        dist.all_reduce(t, group=ctx.shard_group)


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
    if size == 1:
        return x
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
