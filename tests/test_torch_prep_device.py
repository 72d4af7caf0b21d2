"""The preparation entry functions run on the card unless the caller asks
for the CPU: ``extract_masks_transformers`` and ``extract_masks_native``
(prep/masks.py), ``build_native_detector`` and
``build_native_depth_detector`` (prep/skeletons.py) default to ``cuda``
and resolve it through ``inference.resolve_device`` before any file is
read. So on a host without CUDA a call that leaves out ``device`` raises
at once (the files named here do not exist: a function that read one
first would raise FileNotFoundError instead), and with CUDA present the
networks are loaded onto the card (the loaders stubbed, recording the
device they were given). ROADMAP C6.

The public loaders of the models' checkpoints (models/weights.py,
openpose.py, midas.py, sam.py, gdino_weights.py) default to ``cuda`` the
same way, resolved before the file is read. ROADMAP C7.
"""

import inspect

import pytest
import torch

from motioneditor_tpu_torch.models import gdino_weights, midas, openpose, sam, weights
from motioneditor_tpu_torch.prep import masks, skeletons

MISSING = "/nonexistent/file"
CALLS = {
    "extract_masks_transformers": lambda: masks.extract_masks_transformers(
        MISSING, "person", MISSING, MISSING, MISSING),
    "extract_masks_native": lambda: masks.extract_masks_native(
        MISSING, "person", MISSING, MISSING, MISSING, MISSING),
    "build_native_detector": lambda: skeletons.build_native_detector(MISSING),
    "build_native_depth_detector": lambda: skeletons.build_native_depth_detector(MISSING),
}
MODULES = {"extract_masks_transformers": masks, "extract_masks_native": masks,
           "build_native_detector": skeletons, "build_native_depth_detector": skeletons}


@pytest.mark.parametrize("name", list(CALLS))
def test_prep_entry_defaults_to_the_card(name, monkeypatch):
    fn = getattr(MODULES[name], name)
    assert inspect.signature(fn).parameters["device"].default == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        CALLS[name]()


@pytest.mark.parametrize("name", ["build_native_detector", "build_native_depth_detector"])
def test_prep_detectors_load_onto_the_card(name, monkeypatch):
    from motioneditor_tpu_torch.models import midas, openpose

    seen = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(openpose, "load_body_params", lambda path, device: seen.append(device))
    monkeypatch.setattr(midas, "load_dpt_params", lambda path, device: seen.append(device))
    CALLS[name]()
    assert seen == [torch.device("cuda")]


LOADERS = {
    "load_sd15_unet": weights, "load_sd15_vae": weights, "load_sd15_text_encoder": weights,
    "load_controlnet": weights, "load_body_params": openpose, "load_hand_params": openpose,
    "load_face_params": openpose, "load_dpt_params": midas, "load_sam_checkpoint": sam,
    "load_groundingdino_checkpoint": gdino_weights,
}


@pytest.mark.parametrize("name", list(LOADERS))
def test_loaders_default_to_the_card(name, monkeypatch):
    fn = getattr(LOADERS[name], name)
    assert inspect.signature(fn).parameters["device"].default == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        fn(MISSING)
