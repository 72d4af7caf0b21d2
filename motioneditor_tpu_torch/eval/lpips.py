"""LPIPS perceptual distance with the AlexNet backbone (port of
motioneditor_tpu/eval/lpips.py).

AlexNet's five conv taps (``ALEX_CONVS``, ReLU each, 3x3 stride-2 max pools
after the first two), unit-normalized over channels, squared differences
weighted by the non-negative 1x1 "lin" layers, averaged over the pixels and
summed over the taps (Zhang et al. 2018). ``LPIPS`` holds the parameters
under the key names of torchvision's ``alexnet.features`` (``features.{0,
3, 6, 8, 10}``) and of the lpips package's linear layers
(``lin{i}.model.1.weight``), so ``port_lpips_alexnet`` reads both
checkpoints by name. The convs are written out here: the port does not
depend on torchvision.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from motioneditor_tpu_torch.models.layers import init_params

# (out_ch, kernel, stride, pad) of torchvision alexnet.features' convs
ALEX_CONVS = (
    (64, 11, 4, 2),
    (192, 5, 1, 2),
    (384, 3, 1, 1),
    (256, 3, 1, 1),
    (256, 3, 1, 1),
)
CONV_IDS = (0, 3, 6, 8, 10)  # their indices in alexnet.features
POOL_AFTER = (0, 1)  # 3x3 stride-2 max pools after these taps

SHIFT = np.asarray([-0.030, -0.088, -0.188], np.float32)
SCALE = np.asarray([0.458, 0.448, 0.450], np.float32)


class LPIPS(nn.Module):
    def __init__(self):
        super().__init__()
        self.features = nn.ModuleDict()
        in_ch = 3
        for i, (out_ch, k, s, p) in zip(CONV_IDS, ALEX_CONVS):
            self.features[str(i)] = nn.Conv2d(in_ch, out_ch, k, stride=s, padding=p)
            in_ch = out_ch
        for i, (out_ch, *_) in enumerate(ALEX_CONVS):
            lin = nn.Module()
            lin.model = nn.Sequential(nn.Dropout(0.0), nn.Conv2d(out_ch, 1, 1, bias=False))
            setattr(self, f"lin{i}", lin)


@torch.no_grad()
def init_lpips(model: LPIPS, generator: torch.Generator) -> LPIPS:
    """Random init (``layers.init_params``), the lin weights made
    non-negative as the calibrated ones are."""
    init_params(model, generator)
    for i in range(len(ALEX_CONVS)):
        getattr(model, f"lin{i}").model[1].weight.abs_()
    return model


def _features(model: LPIPS, x: torch.Tensor):
    feats = []
    for tap, i in enumerate(CONV_IDS):
        x = F.relu(model.features[str(i)](x))
        feats.append(x)
        if tap in POOL_AFTER:
            x = F.max_pool2d(x, 3, stride=2)
    return feats


def lpips(model: LPIPS, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a/b: [N, H, W, 3] in [0, 1] -> the mean LPIPS distance (fp32)."""
    shift = torch.as_tensor(SHIFT, device=a.device)[:, None, None]
    scale = torch.as_tensor(SCALE, device=a.device)[:, None, None]

    def norm_input(x):
        return ((x.float() * 2.0 - 1.0).permute(0, 3, 1, 2) - shift) / scale

    total = 0.0
    for tap, (xa, xb) in enumerate(zip(_features(model, norm_input(a)),
                                       _features(model, norm_input(b)))):
        na = xa / torch.clamp(torch.linalg.vector_norm(xa, dim=1, keepdim=True), min=1e-10)
        nb = xb / torch.clamp(torch.linalg.vector_norm(xb, dim=1, keepdim=True), min=1e-10)
        w = torch.clamp(getattr(model, f"lin{tap}").model[1].weight[0, :, 0, 0], min=0.0)
        total = total + torch.einsum("nchw,c->nhw", (na - nb) ** 2, w).mean(dim=(1, 2))
    return total.mean()


def port_lpips_alexnet(alexnet_sd, lpips_sd) -> LPIPS:
    """An ``LPIPS`` from torchvision alexnet's state dict (its
    ``features.{0,3,6,8,10}.{weight,bias}``; other keys ignored) and the
    lpips package's ``alex`` linear weights (``lin{0..4}.model.1.weight``)."""
    keys = {}
    for i in CONV_IDS:
        for name in ("weight", "bias"):
            keys[f"features.{i}.{name}"] = alexnet_sd[f"features.{i}.{name}"]
    for i in range(len(ALEX_CONVS)):
        keys[f"lin{i}.model.1.weight"] = lpips_sd[f"lin{i}.model.1.weight"]
    model = LPIPS()
    model.load_state_dict({k: torch.as_tensor(v) for k, v in keys.items()})
    return model.eval()
