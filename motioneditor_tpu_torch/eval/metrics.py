"""Edit-quality metrics (port of motioneditor_tpu/eval/metrics.py).

  - psnr / ssim: reconstruction fidelity, no weights
  - temporal_consistency: 1 - mean adjacent-frame L1, a flicker proxy
  - clip_score: frame-prompt similarity through the CLIP towers
    (models/clip_image.py, models/clip_text.py ``clip_text_embed``)
  - frame_clip_consistency: mean adjacent-frame CLIP-embedding cosine
  - LPIPS is in eval/lpips.py

Videos are channel-last in [0, 1]; every metric computes in fp32 and
returns a 0-dim tensor on the videos' device.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def psnr(a: torch.Tensor, b: torch.Tensor, max_val: float = 1.0) -> torch.Tensor:
    """Mean PSNR over all leading dims."""
    mse = torch.mean((a.float() - b.float()) ** 2)
    return 10.0 * torch.log10(max_val ** 2 / torch.clamp(mse, min=1e-12))


def _gaussian_kernel(size: int = 11, sigma: float = 1.5, device=None) -> torch.Tensor:
    x = torch.arange(size, dtype=torch.float32, device=device) - (size - 1) / 2.0
    g = torch.exp(-(x ** 2) / (2 * sigma ** 2))
    g = g / g.sum()
    return g[:, None] * g[None, :]


def ssim(a: torch.Tensor, b: torch.Tensor, max_val: float = 1.0) -> torch.Tensor:
    """Mean SSIM over frames; a/b: [..., H, W, C]. The Gaussian-window SSIM
    of Wang et al. (11 taps, sigma 1.5, no padding)."""
    h, w, c = a.shape[-3:]
    a4 = a.float().reshape(-1, h, w, c).permute(0, 3, 1, 2)
    b4 = b.float().reshape(-1, h, w, c).permute(0, 3, 1, 2)
    kern = _gaussian_kernel(device=a4.device)[None, None].expand(c, 1, 11, 11)

    def blur(x):
        return F.conv2d(x, kern, groups=c)

    mu_a, mu_b = blur(a4), blur(b4)
    mu_a2, mu_b2, mu_ab = mu_a * mu_a, mu_b * mu_b, mu_a * mu_b
    sa = blur(a4 * a4) - mu_a2
    sb = blur(b4 * b4) - mu_b2
    sab = blur(a4 * b4) - mu_ab
    c1 = (0.01 * max_val) ** 2
    c2 = (0.03 * max_val) ** 2
    score = ((2 * mu_ab + c1) * (2 * sab + c2)) / ((mu_a2 + mu_b2 + c1) * (sa + sb + c2))
    return score.mean()


def temporal_consistency(video: torch.Tensor) -> torch.Tensor:
    """1 - mean adjacent-frame |difference|; video: [F, H, W, C]."""
    v = video.float()
    return 1.0 - (v[1:] - v[:-1]).abs().mean()


def _unit(x: torch.Tensor) -> torch.Tensor:
    x = x.float()
    return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True)


def clip_score(video: torch.Tensor, prompt: str, image_model, text_model,
               tokenizer) -> torch.Tensor:
    """Mean frame-prompt cosine similarity of the CLIP embeddings (the
    paper's textual-faithfulness metric). video: [F, H, W, 3]; the models
    (each with its config) on the video's device."""
    from motioneditor_tpu_torch.models.clip_image import clip_image_embed, preprocess_clip
    from motioneditor_tpu_torch.models.clip_text import clip_text_embed, tokenize

    config = text_model.config
    img = _unit(clip_image_embed(image_model, preprocess_clip(video)))  # [F, D]
    ids = tokenize(tokenizer, [prompt], config.max_position_embeddings).to(video.device)
    txt = _unit(clip_text_embed(text_model, ids, config))  # [1, D]
    return (img @ txt.T).mean()


def frame_clip_consistency(video: torch.Tensor, image_model) -> torch.Tensor:
    """Mean adjacent-frame cosine similarity of the CLIP image embeddings."""
    from motioneditor_tpu_torch.models.clip_image import clip_image_embed, preprocess_clip

    emb = _unit(clip_image_embed(image_model, preprocess_clip(video)))
    return (emb[1:] * emb[:-1]).sum(-1).mean()
