"""CLIP text encoder, the SD-1.5 prompt encoder
(port of motioneditor_tpu/models/clip_text.py).

``CLIPTextModel`` holds the parameters under the key names of a real SD-1.5
``text_encoder`` checkpoint (tests/fixtures/manifests/sd15_clip_text.txt);
``clip_text_apply`` returns the final hidden states [B, 77, 768] as JAX's
does: causal -inf mask, quick-GELU MLP, LayerNorm eps 1e-5.

Tokenizers: ``load_clip_tokenizer`` loads the Hugging Face tokenizer of a
local SD-1.5 checkpoint (it needs ``transformers``); ``StubTokenizer`` is
the deterministic word-hash stand-in for runs without checkpoint files.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence

import numpy as np
import torch
from torch import nn

from motioneditor_tpu_torch.models.layers import layer_norm, linear, quick_gelu
from motioneditor_tpu_torch.ops.attention import attention_probs, merge_heads, split_heads


@dataclasses.dataclass(frozen=True)
class CLIPTextConfig:
    vocab_size: int = 49408
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 77
    layer_norm_eps: float = 1e-5
    bos_token_id: int = 49406
    eos_token_id: int = 49407


class CLIPAttention(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.q_proj = nn.Linear(dim, dim)
        self.k_proj = nn.Linear(dim, dim)
        self.v_proj = nn.Linear(dim, dim)
        self.out_proj = nn.Linear(dim, dim)


class CLIPLayer(nn.Module):
    def __init__(self, c: CLIPTextConfig):
        super().__init__()
        self.layer_norm1 = nn.LayerNorm(c.hidden_size, eps=c.layer_norm_eps)
        self.self_attn = CLIPAttention(c.hidden_size)
        self.layer_norm2 = nn.LayerNorm(c.hidden_size, eps=c.layer_norm_eps)
        self.mlp = nn.Module()
        self.mlp.fc1 = nn.Linear(c.hidden_size, c.intermediate_size)
        self.mlp.fc2 = nn.Linear(c.intermediate_size, c.hidden_size)


class CLIPTextModel(nn.Module):
    def __init__(self, config: CLIPTextConfig = CLIPTextConfig()):
        super().__init__()
        c = config
        tm = self.text_model = nn.Module()
        tm.embeddings = nn.Module()
        tm.embeddings.token_embedding = nn.Embedding(c.vocab_size, c.hidden_size)
        tm.embeddings.position_embedding = nn.Embedding(c.max_position_embeddings,
                                                        c.hidden_size)
        tm.embeddings.position_embedding.init_std = 0.01  # as JAX's init_clip_text
        tm.embeddings.register_buffer(
            "position_ids", torch.arange(c.max_position_embeddings)[None])
        tm.encoder = nn.Module()
        tm.encoder.layers = nn.ModuleList([CLIPLayer(c) for _ in range(c.num_layers)])
        tm.final_layer_norm = nn.LayerNorm(c.hidden_size, eps=c.layer_norm_eps)


def clip_text_apply(model: CLIPTextModel, input_ids: torch.Tensor,
                    config: CLIPTextConfig = CLIPTextConfig()) -> torch.Tensor:
    """input_ids: [B, T] integer ids -> last hidden state [B, T, hidden]."""
    c, tm = config, model.text_model
    t = input_ids.shape[1]
    emb = tm.embeddings
    x = emb.token_embedding.weight[input_ids] + emb.position_embedding.weight[None, :t]
    causal = torch.triu(torch.full((t, t), float("-inf"), device=x.device), diagonal=1)
    heads = c.num_heads
    scale = (c.hidden_size // heads) ** -0.5
    for lp in tm.encoder.layers:
        h = layer_norm(lp.layer_norm1, x, eps=c.layer_norm_eps)
        a = lp.self_attn
        q, k, v = (split_heads(linear(m, h), heads) for m in (a.q_proj, a.k_proj, a.v_proj))
        probs = attention_probs(q, k, scale, bias=causal).to(v.dtype)
        x = x + linear(a.out_proj, merge_heads(torch.matmul(probs, v)))
        h = layer_norm(lp.layer_norm2, x, eps=c.layer_norm_eps)
        x = x + linear(lp.mlp.fc2, quick_gelu(linear(lp.mlp.fc1, h)))
    return layer_norm(tm.final_layer_norm, x, eps=c.layer_norm_eps)


# ---------------------------------------------------------------------------
# tokenizers
# ---------------------------------------------------------------------------


def load_clip_tokenizer(pretrained_model_path: str):
    """The Hugging Face CLIPTokenizer of a local SD checkpoint directory
    (subfolder ``tokenizer``)."""
    try:
        from transformers import CLIPTokenizer
    except ImportError as e:
        raise ImportError("load_clip_tokenizer needs the transformers package; "
                          "without checkpoint files use StubTokenizer") from e
    return CLIPTokenizer.from_pretrained(pretrained_model_path, subfolder="tokenizer")


class StubTokenizer:
    """Deterministic word-hash tokenizer for runs without vocab files, with
    the CLIPTokenizer call surface the pipeline uses: BOS, one id per word,
    EOS, padded with EOS to ``max_length``. Ids come from Python's salted
    ``hash``, so they are stable within one process only."""

    model_max_length = 77
    bos_token_id = 49406
    eos_token_id = 49407

    def __init__(self):
        self._inv = {self.bos_token_id: "", self.eos_token_id: ""}

    def encode(self, text: str) -> List[int]:
        words = [w for w in text.lower().strip().split(" ") if w]
        ids = [self.bos_token_id]
        for w in words:
            wid = (hash(w) % 49000) + 320
            self._inv[wid] = w
            ids.append(wid)
        ids.append(self.eos_token_id)
        return ids

    def decode(self, ids) -> str:
        """Inverse of ``encode`` for ids this instance has produced."""
        if isinstance(ids, int):
            ids = [ids]
        return "".join(self._inv.get(int(i), "?") for i in ids)

    def __call__(self, texts, max_length=77, padding="max_length", truncation=True,
                 return_tensors=None, **kw):
        if isinstance(texts, str):
            texts = [texts]
        out = []
        for t in texts:
            ids = self.encode(t)[:max_length]
            out.append(ids + [self.eos_token_id] * (max_length - len(ids)))
        arr = np.asarray(out, np.int32)

        class _Res:
            input_ids = arr

        return _Res()


def tokenize(tokenizer, texts: Sequence[str], max_length: int = 77) -> torch.Tensor:
    """[len(texts), max_length] int64 token ids on the CPU."""
    res = tokenizer(list(texts), max_length=max_length, padding="max_length", truncation=True)
    return torch.as_tensor(np.asarray(res.input_ids), dtype=torch.int64)
