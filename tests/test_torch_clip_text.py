"""The port's CLIP text encoder and tokenizers (models/clip_text.py)
against the JAX package, fp32 on the CPU, and its parameter names against
the SD-1.5 text-encoder checkpoint manifest.

Tolerance: hidden states atol 1e-5, rtol 1e-5 (two fp32 layers at width 32).
"""

import os.path as osp
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from motioneditor_tpu.models import clip_text as JC

from motioneditor_tpu_torch.models import clip_text as TC
from motioneditor_tpu_torch.models.from_jax import clip_text_state_dict
from motioneditor_tpu_torch.models.layers import init_params

from torch_port_helpers import assert_close, random_params, setup_torch

TINY = dict(vocab_size=500, hidden_size=32, num_layers=2, num_heads=4, intermediate_size=64)
MANIFEST = osp.join(osp.dirname(__file__), "fixtures", "manifests", "sd15_clip_text.txt")


@pytest.fixture(autouse=True)
def _torch_threads():
    setup_torch()


def test_config_defaults_match_jax():
    assert TC.CLIPTextConfig() == TC.CLIPTextConfig(**vars(JC.CLIPTextConfig()))


def test_clip_text_matches_jax():
    jcfg, tcfg = JC.CLIPTextConfig(**TINY), TC.CLIPTextConfig(**TINY)
    tree = random_params(lambda: JC.init_clip_text(jax.random.PRNGKey(0), jcfg), seed=1)
    model = TC.CLIPTextModel(tcfg).eval()
    model.load_state_dict(clip_text_state_dict(tree))
    rng = np.random.default_rng(2)
    ids = np.full((2, 77), tcfg.vocab_size - 1, np.int64)
    ids[:, :9] = rng.integers(0, tcfg.vocab_size, (2, 9))
    ref = JC.clip_text_apply(jax.tree_util.tree_map(jnp.asarray, tree),
                             jnp.asarray(ids, jnp.int32), jcfg)
    with torch.no_grad():
        out = TC.clip_text_apply(model, torch.from_numpy(ids), tcfg)
    assert out.shape == (2, 77, 32)
    assert_close(out, ref, atol=1e-5, rtol=1e-5)


def test_causal_mask_hides_later_tokens():
    cfg = TC.CLIPTextConfig(**TINY)
    model = init_params(TC.CLIPTextModel(cfg), torch.Generator().manual_seed(0)).eval()
    ids = torch.randint(0, cfg.vocab_size, (2, 77), generator=torch.Generator().manual_seed(1))
    changed = ids.clone()
    changed[:, 40:] = (changed[:, 40:] + 1) % cfg.vocab_size
    with torch.no_grad():
        a, b = (TC.clip_text_apply(model, x, cfg) for x in (ids, changed))
    torch.testing.assert_close(a[:, :40], b[:, :40], atol=1e-6, rtol=0)
    assert not torch.allclose(a[:, 40:], b[:, 40:])


def test_state_dict_matches_the_sd15_manifest():
    with open(MANIFEST) as f:
        want = {k: tuple(int(d) for d in s.split(",")) for k, s in
                (line.split() for line in f)}
    with torch.device("meta"):
        model = TC.CLIPTextModel()
    got = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    assert got == want


def test_stub_tokenizer_matches_jax():
    """Ids come from Python's salted hash, so they agree only within one
    process, which is where this compares them."""
    prompts = ["a man is dancing", "", "A Man  jumping high"]
    got = TC.tokenize(TC.StubTokenizer(), prompts)
    ref = JC.tokenize(JC.StubTokenizer(), prompts)
    assert got.dtype == torch.int64 and got.shape == (3, 77)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    tok = TC.StubTokenizer()
    ids = tok.encode("a man")
    assert ids[0] == tok.bos_token_id and ids[-1] == tok.eos_token_id
    assert tok.decode(ids[1:-1]) == "aman"


def test_load_clip_tokenizer_fails_loudly_without_transformers(monkeypatch, tmp_path):
    monkeypatch.setitem(sys.modules, "transformers", None)  # the import now fails
    with pytest.raises(ImportError, match="transformers"):
        TC.load_clip_tokenizer(str(tmp_path))
