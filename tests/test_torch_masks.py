"""The mask side of the port's data preparation (prep/masks.py,
prep/tokenizer.py, models/gdino_weights.py, the SAM loader) against the
JAX package and ``transformers``, on the CPU.

- ``WordPieceTokenizer`` gives ``transformers.BertTokenizer``'s ids exactly
  on a vocab written here: accents, punctuation, a CJK character, unknown
  words, a word over 100 characters, control and zero-width characters,
  special tokens in the text.
- ``native_dino_boxes`` at TINY_GDINO and 64 px against JAX's (with
  BertTokenizer), boxes and scores within 1e-4 of max |JAX|.
- The masks CLI (``--dino_backend native --device cpu``) on generated PNGs,
  with tiny GroundingDINO and SAM files in the released layouts (the config
  choice monkeypatched to the tiny ones), writes the masks of JAX's
  ``native_dino_boxes`` + ``sam_predict_box`` composition.
- The real checkpoints' key manifests (tests/fixtures/manifests/
  gdino_swint.txt, sam_vit_h.txt) map onto the full-width modules, built
  on the meta device, with no key left over on either side; the keys the
  mapping drops are exactly the documented ones, and ``released_state_dict``
  writes the manifests' keys and shapes.
- The strict loaders refuse an extra and a missing key, and a box-head copy
  that differs; the CLI refuses to run without a GPU unless ``--device
  cpu`` is given, with either backend.
- The transformers backend, on stand-ins for the HF classes, moves both
  models and every input to the device asked for and writes the best box's
  mask.
"""

import dataclasses
import os.path as osp

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from motioneditor_tpu.models import grounding_dino as JG
from motioneditor_tpu.models import sam as JM
from motioneditor_tpu.prep import masks as JK

from motioneditor_tpu_torch.models import gdino_weights as TW
from motioneditor_tpu_torch.models import grounding_dino as TG
from motioneditor_tpu_torch.models import sam as TM
from motioneditor_tpu_torch.models.from_jax import grounding_dino_state_dict, sam_state_dict
from motioneditor_tpu_torch.prep import masks as TK
from motioneditor_tpu_torch.prep.tokenizer import WordPieceTokenizer

from test_grounding_dino import TINY_GDINO
from test_sam import TINY as TINY_SAM
from test_torch_grounding_dino import gdino_config
from torch_port_helpers import random_params, setup_torch, to_jax

MANIFESTS = osp.join(osp.dirname(__file__), "fixtures", "manifests")
WORDS = ("person", ".", "a", "man", "dog", "the", ",", "!", "?", "cafe", "deja", "vu", "un",
         "##known", "##s", "run", "##ning", "人", "x", "##x", "tab", "here", "zero", "width")


@pytest.fixture(autouse=True)
def _torch_threads():
    setup_torch()


def write_vocab(path, size: int = 200) -> str:
    """A BERT vocab.txt of ``size`` lines: [PAD] 0, [unusedN], [UNK] 100,
    [CLS] 101, [SEP] 102, [MASK] 103, then WORDS and filler."""
    lines = ["[PAD]"] + [f"[unused{i}]" for i in range(99)]
    lines += ["[UNK]", "[CLS]", "[SEP]", "[MASK]"] + list(WORDS)
    lines += [f"w{i}" for i in range(size - len(lines))]
    with open(path, "w", encoding="utf-8") as f:
        f.write("\n".join(lines) + "\n")
    return str(path)


CAPTIONS = [
    "person", "A Person.", "Café déjà vu!", "the man,the dog?", "人 person", "unknownwords",
    "running dogs", "x" * 100, "x" * 101, "a [MASK] person.", "man[SEP]dog", "tab\there\n",
    "zero\u200bwidth\x00 person\ufffd", "  ", "UNKNOWN ... ?!",
]


def test_tokenizer_ids_equal_bert_tokenizer(tmp_path):
    from transformers import BertTokenizer

    vocab = write_vocab(tmp_path / "vocab.txt")
    ref = BertTokenizer(vocab_file=vocab)
    got = WordPieceTokenizer(vocab)
    assert got.vocab == dict(ref.vocab)
    for caption in CAPTIONS:
        assert got(caption)["input_ids"] == ref(caption)["input_ids"], caption
    assert got("x" * 101)["input_ids"] == [101, 100, 102]  # over 100 characters: [UNK]


@pytest.fixture(scope="module")
def models():
    """Tiny GroundingDINO and SAM, each as a JAX tree and the port's module
    on the same seeded weights."""
    setup_torch()
    gtree = random_params(lambda: JG.init_grounding_dino(jax.random.PRNGKey(0), TINY_GDINO),
                          seed=41)
    gdino = TG.GroundingDINO(gdino_config(TINY_GDINO)).eval()
    gdino.load_state_dict(grounding_dino_state_dict(gtree))
    stree = random_params(lambda: JM.init_sam(jax.random.PRNGKey(0), TINY_SAM), seed=42)
    sam = TM.Sam(TM.SAMConfig(**dataclasses.asdict(TINY_SAM))).eval()
    sam.load_state_dict(sam_state_dict(stree))
    return to_jax(gtree), gdino, to_jax(stree), sam


def test_native_dino_boxes_match_jax(models, tmp_path):
    from transformers import BertTokenizer

    gtree, gdino, _, _ = models
    vocab = write_vocab(tmp_path / "vocab.txt")
    img = Image.fromarray(np.random.default_rng(43).integers(0, 256, (40, 56, 3), np.uint8))
    ref_xyxy, ref_scores = JK.native_dino_boxes(img, "A person. a dog", gtree,
                                                BertTokenizer(vocab_file=vocab), TINY_GDINO,
                                                box_threshold=0.0, size=64)
    xyxy, scores = TK.native_dino_boxes(img, "A person. a dog", gdino, WordPieceTokenizer(vocab),
                                        box_threshold=0.0, size=64)
    assert xyxy.shape == ref_xyxy.shape == (12, 4) and scores.shape == (12,)
    np.testing.assert_allclose(scores, ref_scores, atol=1e-4 * np.abs(ref_scores).max())
    np.testing.assert_allclose(xyxy, ref_xyxy, atol=1e-4 * np.abs(ref_xyxy).max())
    assert int(scores.argmax()) == int(ref_scores.argmax())
    # a threshold keeps the same queries
    mid = float(np.median(ref_scores))
    kept = TK.native_dino_boxes(img, "A person. a dog", gdino, WordPieceTokenizer(vocab),
                                box_threshold=mid, size=64)[1]
    np.testing.assert_allclose(kept, ref_scores[ref_scores > mid], atol=1e-4)


def _checkpoints(root, models):
    _, gdino, _, sam = models
    torch.save({"model": TW.released_state_dict(gdino)}, root / "groundingdino_tiny.pth")
    torch.save(TM.released_state_dict(sam), root / "sam_vit_tiny.pth")
    return str(root / "groundingdino_tiny.pth"), str(root / "sam_vit_tiny.pth")


def _tiny_configs(monkeypatch, models):
    _, gdino, _, sam = models
    monkeypatch.setattr(TW, "config_for", lambda path: gdino.config)
    monkeypatch.setattr(TM, "config_for", lambda path: sam.config)


def test_masks_cli_equals_jax_composition(models, tmp_path, monkeypatch):
    from transformers import BertTokenizer

    gtree, _, stree, _ = models
    dino_ckpt, sam_ckpt = _checkpoints(tmp_path, models)
    vocab = write_vocab(tmp_path / "vocab.txt")
    frames = tmp_path / "frames"
    frames.mkdir()
    rng = np.random.default_rng(44)
    for i, hw in enumerate(((48, 40), (36, 52))):
        Image.fromarray(rng.integers(0, 256, hw + (3,), np.uint8)).save(frames / f"{i:05d}.png")
    _tiny_configs(monkeypatch, models)
    TK.main(["--data", str(frames), "--save_dir", str(tmp_path / "port"), "--text_prompt",
             "person", "--dino_backend", "native", "--dino_ckpt", dino_ckpt, "--bert_vocab",
             vocab, "--sam_path", sam_ckpt, "--box_threshold", "0.0", "--device", "cpu"])
    tokenizer = BertTokenizer(vocab_file=vocab)
    for i in range(2):
        image = Image.open(frames / f"{i:05d}.png").convert("RGB")
        xyxy, scores = JK.native_dino_boxes(image, "person", gtree, tokenizer, TINY_GDINO, 0.0)
        ref = JM.sam_predict_box(stree, np.asarray(image), xyxy[int(scores.argmax())], TINY_SAM)
        got = np.asarray(Image.open(tmp_path / "port" / f"{i:05d}.png"))
        assert got.shape == image.size[::-1] and got.dtype == np.uint8
        assert 0 < ref.sum() < ref.size
        np.testing.assert_array_equal(got, (ref * 255).astype(np.uint8))


def _manifest(name):
    """{key: a zero tensor of the key's shape that holds one element}."""
    out = {}
    with open(osp.join(MANIFESTS, name + ".txt")) as f:
        for line in f:
            key, shape = line.split()
            out[key] = torch.zeros(()).expand(tuple(int(d) for d in shape.split(",")))
    return out


def _shapes(sd):
    return {k: tuple(v.shape) for k, v in sd.items()}


def test_gdino_swint_manifest_maps_onto_the_module():
    manifest = _manifest("gdino_swint")
    mapped = TW.map_groundingdino_state_dict({"model": {"module." + k: v
                                                        for k, v in manifest.items()}})
    with torch.device("meta"):
        model = TG.GroundingDINO(TG.GDINO_SWINT)
    assert _shapes(mapped) == _shapes(model.state_dict())
    dropped = set(manifest) - set(mapped)
    assert all(k.endswith(".relative_position_index") or k.startswith("bert.pooler.")
               or k.startswith(("transformer.decoder.bbox_embed.", "bbox_embed."))
               for k in dropped)
    assert sum(k.endswith(".relative_position_index") for k in dropped) == 12
    assert sum("bbox_embed" in k for k in dropped) == 11 * 6  # 5 + 6 copies of 6 tensors
    assert _shapes(TW.released_state_dict(model)) == _shapes(manifest)
    # 174.3 M parameters, as the manifest counts them without the dropped keys
    assert sum(v.numel() for v in model.parameters()) == sum(
        v.numel() for k, v in manifest.items() if k not in dropped)


def test_sam_vit_h_manifest_maps_onto_the_module():
    manifest = _manifest("sam_vit_h")
    mapped = TM.map_sam_state_dict(manifest)
    with torch.device("meta"):
        model = TM.Sam(TM.SAM_VIT_H)
    assert _shapes(mapped) == _shapes(model.state_dict())
    assert {k.split(".")[2] for k in set(manifest) - set(mapped)} == {"0", "1", "3", "4", "6"}
    assert all(k.startswith(TM.MASK_PROMPT) for k in set(manifest) - set(mapped))
    assert _shapes(TM.released_state_dict(model)) == _shapes(manifest)


def test_loaders_are_strict(models, tmp_path, monkeypatch):
    _, gdino, _, sam = models
    _tiny_configs(monkeypatch, models)
    dino_ckpt, sam_ckpt = _checkpoints(tmp_path, models)
    loaded = TW.load_groundingdino_checkpoint(dino_ckpt)
    for k, v in gdino.state_dict().items():
        assert torch.equal(loaded.state_dict()[k], v), k
    loaded = TM.load_sam_checkpoint(sam_ckpt)
    for k, v in sam.state_dict().items():
        assert torch.equal(loaded.state_dict()[k], v), k

    full = TW.released_state_dict(gdino)
    bad = tmp_path / "bad.pth"
    torch.save({"model": dict(full, **{"transformer.stray.weight": torch.zeros(1)})}, bad)
    with pytest.raises(KeyError, match="stray"):
        TW.load_groundingdino_checkpoint(str(bad))
    torch.save({"model": {k: v for k, v in full.items() if k != "feat_map.bias"}}, bad)
    with pytest.raises(KeyError, match="missing"):
        TW.load_groundingdino_checkpoint(str(bad))
    copy = dict(full)
    copy["bbox_embed.3.layers.0.bias"] = full["bbox_embed.0.layers.0.bias"] + 1.0
    torch.save({"model": copy}, bad)
    with pytest.raises(ValueError, match="bbox_embed.3"):
        TW.load_groundingdino_checkpoint(str(bad))

    full = TM.released_state_dict(sam)
    torch.save(dict(full, **{"mask_decoder.stray": torch.zeros(1)}), bad)
    with pytest.raises(KeyError, match="stray"):
        TM.load_sam_checkpoint(str(bad))
    torch.save({k: v for k, v in full.items() if k != "mask_decoder.iou_token.weight"}, bad)
    with pytest.raises(KeyError, match="missing"):
        TM.load_sam_checkpoint(str(bad))


def test_masks_cli_refusals(models, tmp_path, monkeypatch):
    dino_ckpt, sam_ckpt = _checkpoints(tmp_path, models)
    vocab = write_vocab(tmp_path / "vocab.txt")
    args = ["--data", str(tmp_path), "--save_dir", str(tmp_path / "o"), "--text_prompt",
            "person", "--dino_backend", "native", "--dino_ckpt", dino_ckpt, "--bert_vocab",
            vocab, "--sam_path", sam_ckpt]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        TK.main(args)
    with pytest.raises(RuntimeError, match="--device cpu"):
        TK.main(args + ["--device", "cuda"])
    with pytest.raises(SystemExit, match="missing"):
        TK.main(args[:-2] + ["--sam_path", str(tmp_path / "none.pth"), "--device", "cpu"])
    # the transformers backend (the default) refuses the CPU just the same,
    # also where its checkpoint directories exist
    hf = args[:6] + ["--dino_path", str(tmp_path), "--sam_path", str(tmp_path)]
    for extra in ([], ["--device", "cuda"]):
        with pytest.raises(RuntimeError, match="--device cpu"):
            TK.main(hf + extra)
    with pytest.raises(SystemExit, match="mask extraction needs local"):
        TK.main(args[:6] + ["--device", "cpu"])


class _FakeHF:
    """Stand-ins for the transformers classes the HF paths build: each model
    records the device it was moved to and asserts that every tensor it is
    called with lies there."""

    def __init__(self):
        self.devices = []

    def model(self, output):
        fake = self

        class Model:
            device = torch.device("meta")

            @classmethod
            def from_pretrained(cls, path):
                return cls()

            def to(self, device):
                fake.devices.append(torch.device(device))
                self.device = torch.device(device)
                return self

            def __call__(self, **inputs):
                assert all(v.device == self.device for v in inputs.values()), inputs
                return output(**inputs)

        return Model

    def processor(self, call, **methods):
        from transformers import BatchFeature

        class Processor:
            from_pretrained = classmethod(lambda cls, path: cls())

            def __call__(self, *a, **k):
                return BatchFeature(call(*a, **k))

        for name, fn in methods.items():
            setattr(Processor, name, staticmethod(fn))
        return Processor


def test_masks_cli_transformers_backend_runs_on_the_device(tmp_path, monkeypatch):
    import sys
    import types

    fake = _FakeHF()
    frames = tmp_path / "frames"
    frames.mkdir()
    Image.fromarray(np.zeros((6, 8, 3), np.uint8)).save(frames / "00000.png")

    def dino_call(images, text, return_tensors):
        return {"pixel_values": torch.zeros((1, 3, 4, 4)), "input_ids": torch.ones((1, 3))}

    def post_dino(out, input_ids, box_threshold, text_threshold, target_sizes):
        assert out.device == fake.devices[0] and target_sizes == [(6, 8)]
        return [{"scores": torch.tensor([0.4, 0.9]),
                 "boxes": torch.tensor([[0.0, 0.0, 1.0, 1.0], [1.0, 2.0, 5.0, 4.0]])}]

    def sam_call(image, input_boxes, return_tensors):
        assert input_boxes == [[[1.0, 2.0, 5.0, 4.0]]]
        return {"pixel_values": torch.zeros((1, 3, 4, 4)),
                "original_sizes": torch.tensor([[6, 8]]),
                "reshaped_input_sizes": torch.tensor([[6, 8]]),
                "input_boxes": torch.tensor([[[1.0, 2.0, 5.0, 4.0]]])}

    def post_masks(pred_masks, original_sizes, reshaped_input_sizes):
        mask = torch.zeros((1, 1, 6, 8), dtype=torch.bool)
        mask[..., 2:4, 1:5] = True
        return [mask]

    class ImageProcessor:
        post_process_masks = staticmethod(post_masks)

    sam_proc = fake.processor(sam_call)
    sam_proc.image_processor = ImageProcessor()
    hf = types.ModuleType("transformers")
    for name, cls in {
            "AutoProcessor": fake.processor(
                dino_call, post_process_grounded_object_detection=post_dino),
            "AutoModelForZeroShotObjectDetection": fake.model(
                lambda **k: type("Out", (), {"device": k["pixel_values"].device})()),
            "SamProcessor": sam_proc,
            "SamModel": fake.model(lambda **k: type(
                "Out", (), {"pred_masks": torch.zeros((1, 1, 3, 6, 8))})()),
    }.items():
        setattr(hf, name, cls)
    monkeypatch.setitem(sys.modules, "transformers", hf)
    # the meta device stands for the card: an input left on the CPU fails
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    TK.main(["--data", str(frames), "--save_dir", str(tmp_path / "o"), "--text_prompt",
             "person", "--dino_path", str(tmp_path), "--sam_path", str(tmp_path),
             "--device", "meta"])
    assert fake.devices == [torch.device("meta")] * 2
    got = np.asarray(Image.open(tmp_path / "o" / "00000.png"))
    ref = np.zeros((6, 8), np.uint8)
    ref[2:4, 1:5] = 255
    np.testing.assert_array_equal(got, ref)
