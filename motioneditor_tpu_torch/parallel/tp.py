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
"""

from __future__ import annotations

import collections
from typing import Dict, List, Tuple

import torch
import torch.distributed as dist
from torch import nn

COLUMN = ("to_q", "to_k", "to_v")
ROW = ("to_out.0",)

# the model group's collectives since the last reset: "all_reduce" (calls)
# and "all_reduce_bytes" (bytes reduced); "all_gather" stays absent, since
# nothing here gathers over the model group
collective_counts: collections.Counter = collections.Counter()


def reset_collective_counts() -> None:
    collective_counts.clear()


def _all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    y = x.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(y, group=group)
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
        step = w.shape[dim] // tp
        _set_param(module, name, w.narrow(dim, index * step, step).clone())


def shard_params_tp(module: nn.Module, ctx) -> Dict[str, int]:
    """Narrow ``module`` (a UNet with its adapter, or a ControlNet, loaded at
    full width) to this rank's blocks of ``ctx``'s model group, in place,
    and mark each split Attention with the group, which its call sites read.
    Returns the plan; a one-rank model group changes nothing."""
    if ctx.tp == 1:
        return {}
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
        w = module.get_parameter(name).contiguous()
        parts = [torch.empty_like(w) for _ in range(ctx.tp)]
        dist.all_gather(parts, w, group=ctx.model_group)
        _set_param(module, name, torch.cat(parts, dim=dim))
    for _, m in split_sites(module, ctx.tp):
        m.tp_group, m.tp_size = None, 1
    return module


def is_split(*modules: nn.Module) -> bool:
    """Whether any Attention of ``modules`` is split over a model group."""
    return any(getattr(m, "tp_size", 1) > 1 for module in modules if module is not None
               for m in module.modules())


def refuse(what: str, shard_ctx=None, *modules: nn.Module) -> None:
    """Raise for a path tensor parallelism does not cover yet, when the
    layout has a model group of more than one rank or a module is split."""
    if (shard_ctx is not None and shard_ctx.tp > 1) or is_split(*modules):
        raise NotImplementedError(
            f"{what} does not run under tensor parallelism yet (a model group of more than "
            "one rank); it comes with the next slice of ROADMAP A15")
