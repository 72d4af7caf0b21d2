"""Weights and inputs from the seed, made on the device in a few large
calls. The program and the reference get the same values: both sides call
these functions with the same seed, shapes and device.
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import numpy as np
import torch

CHUNK = 1 << 26  # elements drawn per call


def sub_seed(seed: int, *salt: int) -> int:
    """A 63-bit seed of a generator for one purpose, from any whole ``seed``."""
    words = [int(seed) % (1 << 64), int(seed) >> 64, *salt]
    return int(np.random.SeedSequence(words).generate_state(1, np.uint64)[0] >> 1)


def generator(device, seed: int, *salt: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(sub_seed(seed, *salt))


def _init_rule(name: str, shapes: Dict[str, Tuple[int, ...]], init: dict) -> Tuple[float, float]:
    """(offset, half-width) of the uniform draw of one parameter: norms
    around (1, 0), every other weight and bias within 1 / sqrt(fan_in) of 0
    (times ``qk_gain`` for the query and key projections)."""
    prefix, leaf = name.rsplit(".", 1)
    weight = shapes[f"{prefix}.weight"]
    if len(weight) == 1:  # a GroupNorm or LayerNorm
        return (1.0 if leaf == "weight" else 0.0), init["norm_spread"]
    bound = 1.0 / np.sqrt(np.prod(weight[1:]))
    if prefix.endswith((".to_q", ".to_k")):
        bound *= init["qk_gain"]
    return 0.0, float(bound)


@torch.no_grad()
def fill_weights(shapes: Dict[str, Tuple[int, ...]], seed: int, salt: int, device,
                 dtype: torch.dtype, init: dict, sink: Callable[[str, torch.Tensor], None]):
    """Draw every parameter of ``shapes`` from the seed, uniform by
    ``_init_rule``, in ``dtype``, and hand each to ``sink(name, tensor)``.
    Parameters are drawn in order, a chunk of about ``CHUNK`` elements per
    call; the tensors handed over are views of a chunk."""
    gen = generator(device, seed, salt)
    names = list(shapes)
    i = 0
    while i < len(names):
        group, total = [], 0
        while i < len(names) and (not group or total + np.prod(shapes[names[i]]) <= CHUNK):
            group.append(names[i])
            total += int(np.prod(shapes[names[i]]))
            i += 1
        sizes = torch.tensor([int(np.prod(shapes[n])) for n in group], device=device)
        rules = torch.tensor([_init_rule(n, shapes, init) for n in group], device=device)
        per = torch.repeat_interleave(rules, sizes, dim=0)
        u = torch.rand(total, generator=gen, device=device)
        flat = (per[:, 0] + per[:, 1] * (2 * u - 1)).to(dtype)
        for name, part in zip(group, flat.split(sizes.tolist())):
            sink(name, part.view(shapes[name]))


def load_into(module: torch.nn.Module, shapes, seed: int, salt: int, init: dict) -> None:
    """Fill ``module``'s parameters (whose names must be exactly those of
    ``shapes``) in their own dtype and device."""
    params = dict(module.named_parameters())
    if set(params) != set(shapes):
        raise ValueError(f"parameters differ from the reference's layout: "
                         f"{sorted(set(params) ^ set(shapes))[:6]}")
    first = next(iter(params.values()))
    fill_weights(shapes, seed, salt, first.device, first.dtype, init,
                 lambda n, t: params[n].data.copy_(t))


def reference_params(shapes, seed: int, salt: int, device, dtype: torch.dtype,
                     init: dict) -> Dict[str, torch.Tensor]:
    """The same values as ``load_into`` in ``dtype``, each as a float32 tensor."""
    out: Dict[str, torch.Tensor] = {}
    fill_weights(shapes, seed, salt, device, dtype, init,
                 lambda n, t: out.__setitem__(n, t.float()))
    return out


def blob_masks(gen: torch.Generator, frames: int, size: int, share: float, device):
    """Binary masks [F, size, size] of one person-sized ellipse that walks
    across the frames: its area is ``share`` of a frame, its centre moves on
    a straight line drawn from ``gen``."""
    a = torch.rand(4, generator=gen, device=device)
    ry = size * float(np.sqrt(share / np.pi)) * 1.4  # taller than wide
    rx = share * size * size / (np.pi * ry)
    start = torch.stack([0.3 + 0.4 * a[0], 0.25 + 0.15 * a[1]]) * size
    end = torch.stack([0.3 + 0.4 * a[2], 0.6 + 0.15 * a[3]]) * size
    t = torch.linspace(0, 1, frames, device=device)[:, None]
    centre = start[None] * (1 - t) + end[None] * t  # [F, 2] (y, x)
    yy = torch.arange(size, device=device, dtype=torch.float32)[None, :, None]
    xx = torch.arange(size, device=device, dtype=torch.float32)[None, None, :]
    d = ((yy - centre[:, 0, None, None]) / ry) ** 2 + ((xx - centre[:, 1, None, None]) / rx) ** 2
    return (d <= 1).float()
