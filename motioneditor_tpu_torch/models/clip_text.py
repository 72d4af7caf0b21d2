"""CLIP text encoder, the SD-1.5 prompt encoder
(port of motioneditor_tpu/models/clip_text.py).

``CLIPTextModel`` holds the parameters under the key names of a real SD-1.5
``text_encoder`` checkpoint (tests/fixtures/manifests/sd15_clip_text.txt);
``clip_text_apply`` returns the final hidden states [B, 77, 768] as JAX's
does: causal -inf mask, quick-GELU MLP, LayerNorm eps 1e-5.
``clip_text_embed`` is the pooled state at the EOT token, projected through
``text_projection`` where the model has one (an openai CLIP checkpoint,
read by ``load_clip_text``), the text side of the CLIP score.

Tokenizers: ``load_clip_tokenizer`` loads the Hugging Face tokenizer of a
local SD-1.5 checkpoint (it needs ``transformers``); ``StubTokenizer`` is
the deterministic word-hash stand-in for runs without checkpoint files.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

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
    """``projection_dim``: also hold ``text_projection`` (no bias), the
    projection of an openai CLIP checkpoint."""

    def __init__(self, config: CLIPTextConfig = CLIPTextConfig(),
                 projection_dim: Optional[int] = None):
        super().__init__()
        c = self.config = config
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
        if projection_dim is not None:
            self.text_projection = nn.Linear(c.hidden_size, projection_dim, bias=False)


def clip_encoder(layers, x: torch.Tensor, heads: int, eps: float,
                 bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The pre-LN transformer layers of the CLIP towers (``CLIPLayer``):
    fp32 softmax with an additive ``bias``, quick-GELU MLP."""
    scale = (x.shape[-1] // heads) ** -0.5
    for lp in layers:
        h = layer_norm(lp.layer_norm1, x, eps=eps)
        a = lp.self_attn
        q, k, v = (split_heads(linear(m, h), heads) for m in (a.q_proj, a.k_proj, a.v_proj))
        probs = attention_probs(q, k, scale, bias=bias).to(v.dtype)
        x = x + linear(a.out_proj, merge_heads(torch.matmul(probs, v)))
        h = layer_norm(lp.layer_norm2, x, eps=eps)
        x = x + linear(lp.mlp.fc2, quick_gelu(linear(lp.mlp.fc1, h)))
    return x


def clip_text_apply(model: CLIPTextModel, input_ids: torch.Tensor,
                    config: CLIPTextConfig = CLIPTextConfig()) -> torch.Tensor:
    """input_ids: [B, T] integer ids -> last hidden state [B, T, hidden]."""
    c, tm = config, model.text_model
    t = input_ids.shape[1]
    emb = tm.embeddings
    x = emb.token_embedding.weight[input_ids] + emb.position_embedding.weight[None, :t]
    causal = torch.triu(torch.full((t, t), float("-inf"), device=x.device), diagonal=1)
    x = clip_encoder(tm.encoder.layers, x, c.num_heads, c.layer_norm_eps, bias=causal)
    return layer_norm(tm.final_layer_norm, x, eps=c.layer_norm_eps)


def clip_text_embed(model: CLIPTextModel, input_ids: torch.Tensor,
                    config: CLIPTextConfig = CLIPTextConfig()) -> torch.Tensor:
    """The pooled text embedding [B, D] of the CLIP score: the hidden state
    at the EOT token (the highest id, the first of them), through
    ``text_projection`` when the model has one (JAX clip_text.py:103-121)."""
    hidden = clip_text_apply(model, input_ids, config)
    eot = input_ids.to(hidden.device).argmax(dim=-1)
    pooled = hidden[torch.arange(hidden.shape[0], device=hidden.device), eot]
    if hasattr(model, "text_projection"):
        pooled = linear(model.text_projection, pooled)
    return pooled


def load_clip_text(sd, config: CLIPTextConfig = CLIPTextConfig()) -> CLIPTextModel:
    """A ``CLIPTextModel`` from a Hugging Face CLIP state dict (an SD-1.5
    ``text_encoder`` or a whole openai CLIP checkpoint, whose vision keys it
    ignores), with ``text_projection`` when the dict has one (the reader
    JAX calls ``port_clip_text``, models/weights.py:337). The widths, depth
    and vocabulary come from the shapes; ``config`` gives what they cannot:
    the head count and the LayerNorm eps."""
    keys = {k: v for k, v in sd.items()
            if k.startswith("text_model.") or k == "text_projection.weight"}
    proj = keys.get("text_projection.weight")
    vocab, hidden = keys["text_model.embeddings.token_embedding.weight"].shape
    config = dataclasses.replace(
        config, vocab_size=vocab, hidden_size=hidden,
        max_position_embeddings=keys["text_model.embeddings.position_embedding.weight"].shape[0],
        num_layers=sum(1 for k in keys if k.endswith(".self_attn.q_proj.weight")),
        intermediate_size=keys["text_model.encoder.layers.0.mlp.fc1.weight"].shape[0])
    model = CLIPTextModel(config, None if proj is None else proj.shape[0])
    keys.setdefault("text_model.embeddings.position_ids",
                    model.text_model.embeddings.position_ids)
    model.load_state_dict({k: torch.as_tensor(v) for k, v in keys.items()})
    return model.eval()


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
