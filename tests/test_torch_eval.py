"""The port's edit-quality metrics (eval/metrics.py, eval/lpips.py), CLIP
towers (models/clip_image.py, ``clip_text_embed``), checkpoint readers and
evaluate.py against the JAX package, fp32 on the CPU.

Tolerances: the metrics and preprocess_clip 1e-5 relative; the towers'
embeddings (and LPIPS, an AlexNet tower) 1e-4 of max |ref|. The readers
take state dicts with real key names: a random tiny Hugging Face
``CLIPModel``'s (transformers, here only) and numpy dicts with
torchvision's alexnet and the lpips package's key names; the JAX package's
readers take the same dicts. evaluate.py runs end to end on PNG frames and
GIFs written here, against scripts/evaluate.py.
"""

import json
import os.path as osp
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from motioneditor_tpu.eval import lpips as JL
from motioneditor_tpu.eval import metrics as JM
from motioneditor_tpu.models import clip_image as JCI
from motioneditor_tpu.models import clip_text as JCT
from motioneditor_tpu.models.weights import port_clip_text as jax_port_clip_text

from motioneditor_tpu_torch import evaluate
from motioneditor_tpu_torch.eval import lpips as TL
from motioneditor_tpu_torch.eval import metrics as TM
from motioneditor_tpu_torch.models import clip_image as TCI
from motioneditor_tpu_torch.models import clip_text as TCT
from motioneditor_tpu_torch.models.from_jax import (
    clip_image_state_dict,
    clip_text_state_dict,
    lpips_state_dict,
)

from torch_port_helpers import random_params, setup_torch

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))
sys.path.insert(0, osp.join(REPO, "scripts"))
import evaluate as jax_evaluate  # noqa: E402

IMAGE_KW = dict(hidden_size=32, num_layers=2, num_heads=4, intermediate_size=64,
                projection_dim=16)  # at 224 px, 14 px patches: 257 tokens
TEXT_KW = dict(hidden_size=24, num_layers=2, num_heads=4, intermediate_size=48)
# the Hugging Face checkpoint's towers: the head counts of ViT-L/14 (16 and
# 12), which the readers and evaluate.py take from the default configs
HF_IMAGE_KW = dict(IMAGE_KW, num_heads=16)
HF_TEXT_KW = dict(TEXT_KW, num_heads=12)


@pytest.fixture(autouse=True)
def _torch_threads():
    setup_torch()


def _rel(got, ref, tol):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    scale = max(1e-12, float(np.abs(ref).max()))
    assert float(np.abs(got - ref).max()) <= tol * scale, (got, ref)


def _video(seed, shape=(3, 32, 40, 3)):
    return np.random.default_rng(seed).random(shape, dtype=np.float32)


def _towers():
    """Tiny CLIP image and text towers (with a text projection) of both
    packages on the same random weights."""
    jimg = random_params(lambda: JCI.init_clip_image(jax.random.PRNGKey(0),
                                                     JCI.CLIPImageConfig(**IMAGE_KW)), seed=31)
    text_cfg = JCT.CLIPTextConfig(**TEXT_KW)
    jtxt = random_params(lambda: JCT.init_clip_text(jax.random.PRNGKey(1), text_cfg), seed=32)
    jtxt["text_projection"] = {"kernel": np.random.default_rng(33).uniform(
        -0.2, 0.2, (TEXT_KW["hidden_size"], IMAGE_KW["projection_dim"])).astype(np.float32)}
    img = TCI.CLIPVisionModel(TCI.CLIPImageConfig(**IMAGE_KW)).eval()
    img.load_state_dict(clip_image_state_dict(jimg))
    txt = TCT.CLIPTextModel(TCT.CLIPTextConfig(**TEXT_KW), IMAGE_KW["projection_dim"]).eval()
    txt.load_state_dict(clip_text_state_dict(jtxt))
    return jimg, jtxt, img, txt


def test_psnr_ssim_temporal_consistency_match_jax():
    a, b = _video(0), _video(1)
    b = np.clip(a + 0.1 * (b - 0.5), 0, 1)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    _rel(TM.psnr(ta, tb), JM.psnr(jnp.asarray(a), jnp.asarray(b)), 1e-5)
    _rel(TM.ssim(ta, tb), JM.ssim(jnp.asarray(a), jnp.asarray(b)), 1e-5)
    _rel(TM.ssim(ta[None], tb[None]), JM.ssim(jnp.asarray(a)[None], jnp.asarray(b)[None]), 1e-5)
    _rel(TM.temporal_consistency(ta), JM.temporal_consistency(jnp.asarray(a)), 1e-5)
    assert float(TM.psnr(ta, ta)) > 100 and abs(float(TM.ssim(ta, ta)) - 1.0) < 1e-5


@pytest.mark.parametrize("shape", [(2, 512, 512, 3), (2, 128, 128, 3), (1, 100, 300, 3),
                                   (2, 2, 64, 64, 3)])
def test_preprocess_clip_matches_jax(shape):
    """Downsampling (512 -> 224, the edit's frames: jax.image.resize
    antialiases, so must the port), upsampling, a non-square frame and two
    lead dims, against JAX's preprocess_clip evaluated op by op. Compiled,
    jax.image.resize rounds its sample positions otherwise (a weight moves
    by up to 7.7e-6 at a 300 -> 224 scale, where positions near 256 have an
    fp32 spacing of 3e-5), so the compiled function is held only where the
    scale is the edit's."""
    v = _video(2, shape)
    got = TCI.preprocess_clip(torch.from_numpy(v))
    with jax.disable_jit():
        ref = np.asarray(JCI.preprocess_clip(jnp.asarray(v)))
    assert got.shape == ref.shape
    _rel(got.numpy(), ref, 1e-5)
    if shape[-3:-1] == (512, 512):
        _rel(got.numpy(), np.asarray(JCI.preprocess_clip(jnp.asarray(v))), 1e-5)


def test_clip_towers_match_jax():
    jimg, jtxt, img, txt = _towers()
    pixels = TCI.preprocess_clip(torch.from_numpy(_video(3, (2, 64, 64, 3))))
    with torch.no_grad():
        got = TCI.clip_image_embed(img, pixels)
    ref = JCI.clip_image_embed(jax.tree_util.tree_map(jnp.asarray, jimg),
                               jnp.asarray(pixels.numpy()), JCI.CLIPImageConfig(**IMAGE_KW))
    assert got.shape == (2, IMAGE_KW["projection_dim"])
    _rel(got.numpy(), ref, 1e-4)
    ids = TCT.tokenize(TCT.StubTokenizer(), ["a man is dancing", "a girl"])
    with torch.no_grad():
        got = TCT.clip_text_embed(txt, ids, TCT.CLIPTextConfig(**TEXT_KW))
    ref = JCT.clip_text_embed(jax.tree_util.tree_map(jnp.asarray, jtxt),
                              jnp.asarray(ids.numpy()), JCT.CLIPTextConfig(**TEXT_KW))
    assert got.shape == (2, IMAGE_KW["projection_dim"])
    _rel(got.numpy(), ref, 1e-4)


def test_clip_text_embed_without_projection_pools_at_eot():
    _, jtxt, _, _ = _towers()
    del jtxt["text_projection"]
    txt = TCT.CLIPTextModel(TCT.CLIPTextConfig(**TEXT_KW)).eval()
    txt.load_state_dict(clip_text_state_dict(jtxt))
    ids = TCT.tokenize(TCT.StubTokenizer(), ["a man", "a girl is dancing"])
    with torch.no_grad():
        got = TCT.clip_text_embed(txt, ids, TCT.CLIPTextConfig(**TEXT_KW))
        hidden = TCT.clip_text_apply(txt, ids, TCT.CLIPTextConfig(**TEXT_KW))
    assert torch.equal(got[0], hidden[0, 3]) and torch.equal(got[1], hidden[1, 5])
    ref = JCT.clip_text_embed(jax.tree_util.tree_map(jnp.asarray, jtxt),
                              jnp.asarray(ids.numpy()), JCT.CLIPTextConfig(**TEXT_KW))
    _rel(got.numpy(), ref, 1e-4)


def test_clip_score_and_frame_consistency_match_jax():
    jimg, jtxt, img, txt = _towers()
    video = _video(4, (3, 96, 80, 3))
    jp = lambda t: jax.tree_util.tree_map(jnp.asarray, t)  # noqa: E731
    with torch.no_grad():
        got = TM.clip_score(torch.from_numpy(video), "a man is dancing", img, txt,
                            TCT.StubTokenizer())
        got_fc = TM.frame_clip_consistency(torch.from_numpy(video), img)
    ref = JM.clip_score(jnp.asarray(video), "a man is dancing", jp(jimg), jp(jtxt),
                        JCT.StubTokenizer(), JCI.CLIPImageConfig(**IMAGE_KW),
                        JCT.CLIPTextConfig(**TEXT_KW))
    ref_fc = JM.frame_clip_consistency(jnp.asarray(video), jp(jimg),
                                       JCI.CLIPImageConfig(**IMAGE_KW))
    _rel(got, ref, 1e-5)
    _rel(got_fc, ref_fc, 1e-5)


def _lpips_models(seed=34):
    tree = random_params(lambda: JL.init_lpips(jax.random.PRNGKey(0)), seed=seed)
    model = TL.LPIPS().eval()
    model.load_state_dict(lpips_state_dict(tree))
    return tree, model


@pytest.mark.parametrize("size", [64, 100])
def test_lpips_matches_jax(size):
    tree, model = _lpips_models()
    a, b = _video(5, (2, size, size, 3)), _video(6, (2, size, size, 3))
    with torch.no_grad():
        got = TL.lpips(model, torch.from_numpy(a), torch.from_numpy(b))
        same = TL.lpips(model, torch.from_numpy(a), torch.from_numpy(a))
    ref = JL.lpips(jax.tree_util.tree_map(jnp.asarray, tree), jnp.asarray(a), jnp.asarray(b))
    _rel(got, ref, 1e-4)
    assert float(same) == 0.0 and float(got) > 0


def _hf_clip_state_dict():
    """A random tiny Hugging Face CLIPModel's state dict: text and vision
    towers, both projections and logit_scale."""
    from transformers import CLIPConfig, CLIPModel

    cfg = CLIPConfig(
        text_config=dict(vocab_size=49408, hidden_size=HF_TEXT_KW["hidden_size"],
                         intermediate_size=HF_TEXT_KW["intermediate_size"],
                         num_hidden_layers=HF_TEXT_KW["num_layers"],
                         num_attention_heads=HF_TEXT_KW["num_heads"], max_position_embeddings=77,
                         hidden_act="quick_gelu"),
        vision_config=dict(hidden_size=HF_IMAGE_KW["hidden_size"],
                           intermediate_size=HF_IMAGE_KW["intermediate_size"],
                           num_hidden_layers=HF_IMAGE_KW["num_layers"],
                           num_attention_heads=HF_IMAGE_KW["num_heads"], image_size=224,
                           patch_size=14, hidden_act="quick_gelu"),
        projection_dim=IMAGE_KW["projection_dim"])
    torch.manual_seed(0)
    model = CLIPModel(cfg).eval()
    return model, {k: v.detach().clone() for k, v in model.state_dict().items()}


def test_clip_readers_on_a_clip_checkpoint_state_dict():
    """port_clip_image and load_clip_text against JAX's port_clip_image and
    port_clip_text on the same dict (and the Hugging Face model itself);
    also with the ``pre_layernorm`` spelling."""
    hf, sd = _hf_clip_state_dict()
    npsd = {k: v.numpy() for k, v in sd.items()}
    img, txt = TCI.port_clip_image(sd), TCT.load_clip_text(sd)
    assert img.config == TCI.CLIPImageConfig(**HF_IMAGE_KW)
    assert txt.config == TCT.CLIPTextConfig(**HF_TEXT_KW)
    pixels = TCI.preprocess_clip(torch.from_numpy(_video(7, (2, 64, 64, 3))))
    ids = TCT.tokenize(TCT.StubTokenizer(), ["a man is dancing"])
    with torch.no_grad():
        got_i = TCI.clip_image_embed(img, pixels)
        got_t = TCT.clip_text_embed(txt, ids, txt.config)
        hf_i = hf.get_image_features(pixel_values=pixels.permute(0, 3, 1, 2))
    ref_i = JCI.clip_image_embed(JCI.port_clip_image(npsd), jnp.asarray(pixels.numpy()),
                                 JCI.CLIPImageConfig(**HF_IMAGE_KW))
    ref_t = JCT.clip_text_embed(jax_port_clip_text(npsd), jnp.asarray(ids.numpy()),
                                JCT.CLIPTextConfig(**HF_TEXT_KW))
    _rel(got_i.numpy(), ref_i, 1e-4)
    _rel(got_i.numpy(), hf_i.numpy(), 1e-4)
    _rel(got_t.numpy(), ref_t, 1e-4)
    renamed = {k.replace("pre_layrnorm", "pre_layernorm"): v for k, v in sd.items()}
    img2 = TCI.port_clip_image(renamed)
    for (k1, v1), (k2, v2) in zip(img.state_dict().items(), img2.state_dict().items()):
        assert k1 == k2 and torch.equal(v1, v2)


def _alexnet_and_lpips_dicts(seed=35):
    """Numpy state dicts under torchvision alexnet's keys (its classifier
    too) and the lpips package's lin keys."""
    rng = np.random.default_rng(seed)
    alex, in_ch = {}, 3
    for i, (out_ch, k, _, _) in zip(TL.CONV_IDS, TL.ALEX_CONVS):
        alex[f"features.{i}.weight"] = rng.uniform(-0.1, 0.1, (out_ch, in_ch, k, k)).astype(
            np.float32)
        alex[f"features.{i}.bias"] = rng.uniform(-0.1, 0.1, out_ch).astype(np.float32)
        in_ch = out_ch
    alex["classifier.1.weight"] = rng.standard_normal((8, 9216)).astype(np.float32)
    lins = {f"lin{i}.model.1.weight": rng.uniform(-0.2, 1.0, (1, c, 1, 1)).astype(np.float32)
            for i, (c, *_) in enumerate(TL.ALEX_CONVS)}
    return alex, lins


def test_lpips_reader_on_alexnet_and_lpips_state_dicts():
    alex, lins = _alexnet_and_lpips_dicts()
    model = TL.port_lpips_alexnet({k: torch.from_numpy(v) for k, v in alex.items()},
                                  {k: torch.from_numpy(v) for k, v in lins.items()})
    a, b = _video(8, (2, 64, 64, 3)), _video(9, (2, 64, 64, 3))
    with torch.no_grad():
        got = TL.lpips(model, torch.from_numpy(a), torch.from_numpy(b))
    ref = JL.lpips(JL.port_lpips_alexnet(alex, lins), jnp.asarray(a), jnp.asarray(b))
    _rel(got, ref, 1e-4)


def _write_case(root, video, layout="case"):
    from PIL import Image

    frames = root / "images" if layout == "case" else root
    frames.mkdir(parents=True)
    for i, fr in enumerate(video):
        Image.fromarray((fr * 255).round().astype(np.uint8)).save(frames / f"{i:05d}.png")
    (root / "frame_list.txt").write_text("\n".join(f"{i:05d}.png" for i in range(len(video))))
    if layout == "case":
        (root / "man.mask").mkdir()
    return str(root)


@pytest.mark.parametrize("layout", ["case", "flat"])
def test_load_video_matches_jax(tmp_path, layout):
    path = _write_case(tmp_path / "clip", _video(10, (3, 24, 20, 3)), layout)
    got = evaluate.load_video(path)
    np.testing.assert_array_equal(got, jax_evaluate.load_video(path))
    assert got.shape == (3, 24, 20, 3) and got.dtype == np.float32
    empty = tmp_path / "empty"
    empty.mkdir()
    with pytest.raises(FileNotFoundError):
        evaluate.load_video(str(empty))


def _clips(tmp_path):
    """A source frame directory of 4 smooth frames at 48 x 40, and recon /
    edit GIFs of 3 frames at 32 x 32 (the pixel metrics resize the source):
    the recon is the source with noise, as a reconstruction is (a recon
    unrelated to the source has an SSIM near 0, a cancellation that fp32
    rounding decides)."""
    import imageio
    from PIL import Image

    rng = np.random.default_rng(11)
    yy, xx = np.mgrid[0:48, 0:40] / 40.0
    source = np.stack([np.stack([np.sin(3 * xx + i) * 0.4 + 0.5, np.cos(2 * yy - i) * 0.4 + 0.5,
                                 (xx * yy + 0.1 * i) % 1.0], -1) for i in range(4)])
    source = np.clip(source + 0.05 * rng.standard_normal(source.shape), 0, 1).astype(np.float32)
    paths = {"source": _write_case(tmp_path / "case", source)}
    small = np.stack([np.asarray(Image.fromarray((fr * 255).round().astype(np.uint8))
                                 .resize((32, 32), Image.BILINEAR), np.float32) / 255.0
                      for fr in source[:3]])
    clips = {"recon": np.clip(small + 0.05 * rng.standard_normal(small.shape), 0, 1),
             "edit": rng.random((3, 32, 32, 3))}
    for name, frames in clips.items():
        paths[name] = str(tmp_path / f"{name}.gif")
        imageio.mimsave(paths[name], list((frames * 255).round().astype(np.uint8)),
                        duration=0.1)
    return paths


def test_evaluate_main_matches_jax(tmp_path, monkeypatch, capsys):
    """The pixel metrics end to end, no CLIP or LPIPS directory: the same
    keys and values as scripts/evaluate.py, the JSON printed and written."""
    paths = _clips(tmp_path)
    argv = ["--source", paths["source"], "--recon", paths["recon"], "--edit", paths["edit"],
            "--prompt", "a man", "--clip_path", str(tmp_path / "none")]
    out = evaluate.main(argv + ["--lpips_path", str(tmp_path / "none"), "--device", "cpu",
                                "--out", str(tmp_path / "port.json")])
    assert json.loads(capsys.readouterr().out) == out
    assert json.loads((tmp_path / "port.json").read_text()) == out
    monkeypatch.setattr(sys, "argv", ["evaluate.py"] + argv + ["--out", str(tmp_path / "j.json")])
    jax_evaluate.main()
    ref = json.loads((tmp_path / "j.json").read_text())
    assert set(out) == set(ref) == {"recon_psnr", "recon_ssim", "edit_temporal_consistency"}
    for key in ref:
        assert abs(out[key] - ref[key]) <= 1e-5 * abs(ref[key]), key


def test_evaluate_main_runs_the_clip_and_lpips_branches(tmp_path, monkeypatch):
    """With checkpoint directories (a tiny CLIPModel's weights, synthetic
    alexnet and lpips weights; the tokenizer stubbed) the branches add
    edit_clip_score, edit_frame_clip_consistency and recon_lpips, each equal
    to the JAX functions on the readers' weights."""
    import transformers

    paths = _clips(tmp_path)
    _, sd = _hf_clip_state_dict()
    clip_dir, lpips_dir = tmp_path / "clip", tmp_path / "lpips"
    clip_dir.mkdir()
    lpips_dir.mkdir()
    torch.save(sd, clip_dir / "pytorch_model.bin")
    alex, lins = _alexnet_and_lpips_dicts()
    torch.save({k: torch.from_numpy(v) for k, v in alex.items()}, lpips_dir / "alexnet.pth")
    torch.save({k: torch.from_numpy(v) for k, v in lins.items()}, lpips_dir / "alex.pth")
    monkeypatch.setattr(transformers.CLIPTokenizer, "from_pretrained",
                        classmethod(lambda cls, path: TCT.StubTokenizer()))
    out = evaluate.main(["--source", paths["source"], "--recon", paths["recon"], "--edit",
                         paths["edit"], "--prompt", "a man is dancing", "--clip_path",
                         str(clip_dir), "--lpips_path", str(lpips_dir), "--device", "cpu"])
    npsd = {k: v.numpy() for k, v in sd.items()}
    edit = jnp.asarray(evaluate.load_video(paths["edit"]))
    s, r = evaluate.match(evaluate.load_video(paths["source"]), evaluate.load_video(paths["recon"]))
    ref = {
        "edit_clip_score": JM.clip_score(edit, "a man is dancing", JCI.port_clip_image(npsd),
                                         jax_port_clip_text(npsd), JCT.StubTokenizer(),
                                         JCI.CLIPImageConfig(**HF_IMAGE_KW),
                                         JCT.CLIPTextConfig(**HF_TEXT_KW)),
        "edit_frame_clip_consistency": JM.frame_clip_consistency(
            edit, JCI.port_clip_image(npsd), JCI.CLIPImageConfig(**HF_IMAGE_KW)),
        "recon_lpips": JL.lpips(JL.port_lpips_alexnet(alex, lins), jnp.asarray(r),
                                jnp.asarray(s)),
    }
    for key, value in ref.items():
        assert abs(out[key] - float(value)) <= 1e-4 * abs(float(value)), key


def test_evaluate_refuses_to_fall_back_to_the_cpu(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    paths = _clips(tmp_path)
    with pytest.raises(RuntimeError, match="--device cpu"):
        evaluate.main(["--source", paths["source"], "--edit", paths["edit"]])
