"""Tensor parallelism: Megatron's column / row split of the attention
projections over the ``model`` process group (port of
motioneditor_tpu/parallel/tp.py).

  column-parallel (output features split): attention to_q / to_k / to_v
  row-parallel (input features split):     attention to_out.0

Rank m of a model group of T holds heads [m H/T, (m+1) H/T), which are
channels [m C/T, (m+1) C/T) since ``split_heads`` reshapes C as (H, D); an
``nn.Linear`` weight is [out, in], so the column split narrows the rows of
to_q / to_k / to_v and the row split the columns of to_out.0. to_out.0's
bias stays whole and is added once, after the reduction. Between the two
projections the activations stay head-local, and every attention kernel
runs on its local heads at width C/T; the row-parallel output is summed
over the model group, one all-reduce per split attention module and no
all-gather. Everything else stays replicated: the GEGLU feed-forward (its
[h | gate] projection does not split into contiguous halves, as JAX
``tp.py`` keeps it whole), convolutions, norms, embeddings, and the VAE and
text encoder, which JAX never passes to ``tp_param_shardings``.

JAX decides per leaf and lets GSPMD reshard what does not divide
(``tp.py:76-91``); here the decision is per Attention module: it is split
only when T divides its heads, else it stays whole and its output is not
reduced. The arithmetic is the same either way.

The two autograd Functions are Megatron's f and g: ``copy_to_model`` sits
at the column-parallel input (identity forward, the gradient all-reduced
backward), ``reduce_from_model`` at the row-parallel output (all-reduce
forward, identity backward). A model group of one rank communicates
nothing.

Every other reduction says which group it runs over. A split quantity is
summed over the model group: the cross-attention maps' sum over heads
(``sum_over_model``, then divided by the global head count), the split
parameters' squares in the gradient clip, and the 8-bit moments' block
maxima (``max_over_model``, training/adam8bit.py). A replicated quantity
(a loss, a replicated parameter's gradient) is summed over the frame x
data ranks of one model rank (parallel/mesh.py ``sum_over_shards``) and
never over the model group.
"""

from __future__ import annotations

import collections
from typing import Dict, List, Tuple

import torch
import torch.distributed as dist
from torch import nn

COLUMN = ("to_q", "to_k", "to_v")
ROW = ("to_out.0",)

# the model group's collectives since the last reset: "all_reduce" (calls),
# "all_reduce_bytes" (bytes reduced) and "broadcast" (calls); "all_gather"
# stays absent, since nothing on a path gathers over the model group
collective_counts: collections.Counter = collections.Counter()


def reset_collective_counts() -> None:
    collective_counts.clear()


def _all_reduce(x: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    y = x.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(y, op=op, group=group)
    collective_counts["all_reduce"] += 1
    collective_counts["all_reduce_bytes"] += y.numel() * y.element_size()
    return y


class _CopyToModel(torch.autograd.Function):
    """Identity forward; the gradient is summed over the model group."""

    @staticmethod
    def forward(fctx, x, group):
        fctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(fctx, g):
        return _all_reduce(g, fctx.group), None


class _ReduceFromModel(torch.autograd.Function):
    """The sum over the model group forward; identity backward."""

    @staticmethod
    def forward(fctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(fctx, g):
        return g, None


def copy_to_model(x: torch.Tensor, group) -> torch.Tensor:
    """Megatron's f, at the input of the column-parallel projections;
    ``group`` None (a one-rank model group) is the identity."""
    return x if group is None else _CopyToModel.apply(x, group)


def reduce_from_model(x: torch.Tensor, group) -> torch.Tensor:
    """Megatron's g, at the row-parallel output: the sum of every model
    rank's partial product; ``group`` None is the identity."""
    return x if group is None else _ReduceFromModel.apply(x, group)


@torch.no_grad()
def sum_over_model(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of a split quantity over the model group (not
    differentiable); ``group`` None is the identity."""
    return x if group is None else _all_reduce(x, group)


@torch.no_grad()
def max_over_model(x: torch.Tensor, group) -> torch.Tensor:
    """The elementwise max over the model group (not differentiable)."""
    return x if group is None else _all_reduce(x, group, dist.ReduceOp.MAX)


@torch.no_grad()
def broadcast_from_model(x: torch.Tensor, ctx) -> torch.Tensor:
    """``x`` from model rank 0 on every rank of ``ctx``'s model group, in
    place: a replicated value whose bits must agree (an early-stop test);
    a one-rank model group is the identity."""
    if ctx.tp > 1:
        dist.broadcast(x, ctx.model_ranks[0], group=ctx.model_group)
        collective_counts["broadcast"] += 1
    return x


def split_sites(module: nn.Module, tp: int) -> List[Tuple[str, nn.Module]]:
    """The Attention modules of ``module`` a model group of ``tp`` splits:
    those whose heads ``tp`` divides."""
    from motioneditor_tpu_torch.ops.attention import Attention

    return [(name, m) for name, m in module.named_modules()
            if isinstance(m, Attention) and m.heads % tp == 0]


def tp_split_plan(module: nn.Module, tp: int) -> Dict[str, int]:
    """{parameter name: the dim a model group of ``tp`` splits}: dim 0 of
    every split site's to_q / to_k / to_v weight, dim 1 of its to_out.0
    weight (the counterpart of JAX ``tp_param_shardings``). Pure: reads
    names, heads and nothing else."""
    plan = {}
    for name, _ in split_sites(module, tp):
        pre = f"{name}." if name else ""
        plan.update({f"{pre}{proj}.weight": 0 for proj in COLUMN})
        plan.update({f"{pre}{proj}.weight": 1 for proj in ROW})
    return plan


def _set_param(module: nn.Module, name: str, value: torch.Tensor) -> None:
    owner, _, leaf = name.rpartition(".")
    old = module.get_parameter(name)
    setattr(module.get_submodule(owner), leaf, nn.Parameter(value, old.requires_grad))


@torch.no_grad()
def narrow_params(module: nn.Module, plan: Dict[str, int], tp: int, index: int) -> None:
    """Replace each parameter of ``plan`` by block ``index`` of ``tp`` equal
    blocks along its dim, in place (a copy: the full tensor is freed)."""
    for name, dim in plan.items():
        w = module.get_parameter(name)
        if w.shape[dim] % tp:
            raise ValueError(f"{name}: dim {dim} of size {w.shape[dim]} does not split "
                             f"{tp} ways")
        _set_param(module, name, narrow_tensor(w, dim, tp, index).clone())


def shard_params_tp(module: nn.Module, ctx) -> Dict[str, int]:
    """Narrow ``module`` (a UNet with its adapter, or a ControlNet, loaded at
    full width) to this rank's blocks of ``ctx``'s model group, in place,
    and mark each split Attention with the group, which its call sites read.
    Returns the plan; a one-rank model group changes nothing."""
    if ctx.tp == 1:
        return {}
    if hasattr(module, "add_embedding"):
        raise NotImplementedError("tensor parallelism is not ported to a text_time (SDXL) "
                                  "configuration")
    sites = split_sites(module, ctx.tp)
    if any(m.tp_size != 1 for _, m in sites):
        raise ValueError("the module is already split over a model group")
    plan = tp_split_plan(module, ctx.tp)
    narrow_params(module, plan, ctx.tp, ctx.model_rank)
    for _, m in sites:
        m.tp_group, m.tp_size = ctx.model_group, ctx.tp
    return plan


@torch.no_grad()
def gather_params_tp(module: nn.Module, ctx) -> nn.Module:
    """``shard_params_tp``'s inverse: every split parameter concatenated
    back from the model group's blocks, the marks removed."""
    if ctx.tp == 1:
        return module
    plan = tp_split_plan(module, ctx.tp)
    for name, dim in plan.items():
        _set_param(module, name, gather_tensor(module.get_parameter(name), dim, ctx))
    for _, m in split_sites(module, ctx.tp):
        m.tp_group, m.tp_size = None, 1
    return module


def split_parameters(module: nn.Module) -> Dict[str, int]:
    """{parameter name: its split dim} of the parameters of ``module`` split
    now, read from the marks ``shard_params_tp`` left."""
    from motioneditor_tpu_torch.ops.attention import Attention

    out = {}
    for name, m in module.named_modules():
        if isinstance(m, Attention) and m.tp_size > 1:
            pre = f"{name}." if name else ""
            out.update({f"{pre}{proj}.weight": 0 for proj in COLUMN})
            out.update({f"{pre}{proj}.weight": 1 for proj in ROW})
    return out


def gather_tensor(x: torch.Tensor, dim: int, ctx) -> torch.Tensor:
    """The full tensor from every model rank's block of ``x`` along
    ``dim`` (not differentiable)."""
    parts = [torch.empty_like(x) for _ in range(ctx.tp)]
    dist.all_gather(parts, x.contiguous(), group=ctx.model_group)
    return torch.cat(parts, dim=dim)


def narrow_tensor(x: torch.Tensor, dim: int, tp: int, index: int) -> torch.Tensor:
    """Block ``index`` of ``tp`` equal blocks of ``x`` along ``dim``."""
    step = x.shape[dim] // tp
    return x.narrow(dim, index * step, step).contiguous()
