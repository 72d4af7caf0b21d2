"""The port's training checkpoints (training/checkpoint.py) and its train
entry points (train_bg.py, train_adaptor.py), on the CPU, port only.

The entry points run configs/smoke/train-bg.yaml and train-motion.yaml
(2 steps, bf16 frozen weights with fp32 masters, gradient checkpointing)
on a clip of generated PNG frames, with tiny models in place of SD-1.5's
widths (``build_pipeline``'s model configs), then the inference entry
point's ``build_pipeline`` loads what they wrote. A run resumed from its
checkpoint draws the noise an uninterrupted run draws at the same step,
so its losses equal the uninterrupted run's exactly.
"""

import copy
import functools
import os.path as osp

import numpy as np
import pytest
import torch

from motioneditor_tpu_torch import configs as TCF
from motioneditor_tpu_torch import inference, train_adaptor, train_bg
from motioneditor_tpu_torch.models.clip_text import CLIPTextConfig
from motioneditor_tpu_torch.models.unet import UNetConfig
from motioneditor_tpu_torch.models.vae import VAEConfig
from motioneditor_tpu_torch.training.checkpoint import (
    latest_checkpoint,
    load_adapter,
    restore_train_state,
    save_adapter,
    save_train_state,
)
from motioneditor_tpu_torch.training.common import make_optimizer, make_train_state
from motioneditor_tpu_torch.training.stage1 import TRAINABLE_MODULES, train_step_stage1

from torch_port_helpers import TINY_KW, normal, setup_torch, tensor, tiny_unet

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))
F, SIZE = 2, 128
TINY_MODELS = dict(unet_config=UNetConfig(**TINY_KW),
                   vae_config=VAEConfig(block_out_channels=(8, 8, 16, 16), layers_per_block=1,
                                        norm_num_groups=4),
                   text_config=CLIPTextConfig(hidden_size=16, num_layers=1, num_heads=2,
                                              intermediate_size=32))


@pytest.fixture(autouse=True)
def _threads():
    setup_torch()


@pytest.fixture(scope="module")
def unet():
    return tiny_unet(seed=71)[1]


@pytest.fixture(scope="module")
def clip_dir(tmp_path_factory):
    """A data/case-N layout of F PNG frames and pose images."""
    from PIL import Image

    root = tmp_path_factory.mktemp("case")
    rng = np.random.default_rng(72)
    for d in ("images", "source_condition/openposefull", "target_condition/openposefull",
              "man.mask"):
        (root / d).mkdir(parents=True)
        for i in range(F):
            img = rng.integers(0, 256, (SIZE, SIZE, 3), dtype=np.uint8)
            Image.fromarray(img[..., 0] if d == "man.mask" else img).save(root / d / f"{i:05d}.png")
    return str(root)


def _config(tmp_path, clip_dir, name, out, **fields):
    cfg = TCF.load_config(osp.join(REPO, "configs", "smoke", name))
    cfg.input_data.video_dir = clip_dir
    cfg.output_dir = str(tmp_path / out)
    for k, v in fields.items():
        setattr(cfg, k, v)
    path = str(tmp_path / f"{out}.yaml")
    TCF.save_config(cfg, path)
    return path


@pytest.fixture
def tiny_models(monkeypatch):
    monkeypatch.setattr(train_bg, "build_pipeline",
                        functools.partial(inference.build_pipeline, **TINY_MODELS))


def _state(unet):
    return make_train_state(copy.deepcopy(unet), TRAINABLE_MODULES,
                            make_optimizer(learning_rate=1e-3))


def _step(state, seed=0):
    rng = np.random.default_rng(73)
    lat, enc = tensor(normal(rng, (1, F, 16, 16, 4), 0.5)), tensor(normal(rng, (1, 7, 16)))
    return train_step_stage1(state, lat, enc, torch.Generator().manual_seed(seed),
                             unet_config=UNetConfig(**TINY_KW), remat=False)


def test_save_restore_round_trip(unet, tmp_path):
    state, _ = _step(_state(unet))
    path = save_train_state(str(tmp_path), 42, state)
    assert osp.basename(path) == "checkpoint-42"
    fresh = restore_train_state(path, _state(unet))
    assert fresh.step == 42
    for name, p in state.trainable.items():
        assert torch.equal(fresh.trainable[name], p), name
        for key in ("exp_avg", "exp_avg_sq"):
            assert torch.equal(fresh.optimizer.inner.state[fresh.trainable[name]][key],
                               state.optimizer.inner.state[p][key])
    # the next step of the restored state is the next step of the original
    a, _ = _step(state, seed=1)
    b, _ = _step(fresh, seed=1)
    for name, p in a.trainable.items():
        assert torch.equal(b.trainable[name], p), name


def test_adapter_round_trip(unet, tmp_path):
    path = save_adapter(str(tmp_path), 7, unet.controlnet_adapter)
    assert osp.basename(path) == "controlnet_adapter_checkpoint-7"
    other = copy.deepcopy(unet.controlnet_adapter)
    with torch.no_grad():
        for p in other.parameters():
            p.zero_()
    load_adapter(path, other)
    for (n, a), b in zip(unet.controlnet_adapter.state_dict().items(), other.state_dict().values()):
        assert torch.equal(a, b), n


def test_latest_checkpoint(tmp_path):
    assert latest_checkpoint(str(tmp_path / "missing")) is None
    for name in ("checkpoint-2", "checkpoint-10", "checkpoint-x", "controlnet_adapter_checkpoint-99"):
        (tmp_path / name).mkdir()
    assert latest_checkpoint(str(tmp_path)) == (str(tmp_path / "checkpoint-10"), 10)


def test_resume_continues_the_loss_trajectory(tmp_path, clip_dir, tiny_models):
    full = train_bg.main(_config(tmp_path, clip_dir, "train-bg.yaml", "full", max_train_steps=4,
                                 checkpointing_steps=2), "cpu")
    first = train_bg.main(_config(tmp_path, clip_dir, "train-bg.yaml", "cut", max_train_steps=2,
                                  checkpointing_steps=2), "cpu")
    rest = train_bg.main(_config(tmp_path, clip_dir, "train-bg.yaml", "cut", max_train_steps=4,
                                 checkpointing_steps=2, resume_from_checkpoint="latest"), "cpu")
    assert len(full) == 4 and np.isfinite(full).all()
    assert first == full[:2] and rest == full[2:]


def test_entry_points_write_and_inference_loads(tmp_path, clip_dir, tiny_models, capsys):
    """train_bg then train_adaptor on the smoke configs write checkpoint-2/
    and controlnet_adapter_checkpoint-2/; build_pipeline loads both, and the
    reference's adapter .pth in place of the second."""
    losses = train_bg.main(_config(tmp_path, clip_dir, "train-bg.yaml", "bg"), "cpu")
    bg = tmp_path / "bg" / "checkpoint-2"
    assert len(losses) == 2 and np.isfinite(losses).all() and (bg / "state.pt").is_file()
    assert "The weights of the model have changed after training" in capsys.readouterr().out
    losses = train_adaptor.main(_config(tmp_path, clip_dir, "train-motion.yaml", "motion",
                                        one_stage_checkpoint=str(bg)), "cpu")
    assert len(losses) == 2 and np.isfinite(losses).all()
    out = capsys.readouterr().out
    assert f"loaded stage-1 checkpoint {bg}" in out
    adapter_dir = tmp_path / "motion" / "controlnet_adapter_checkpoint-2"
    assert (tmp_path / "motion" / "checkpoint-2" / "state.pt").is_file()
    assert (adapter_dir / "adapter.pt").is_file()

    cfg = TCF.load_config(osp.join(REPO, "configs", "smoke", "eval.yaml"))
    cfg.resume_from_checkpoint, cfg.adapter_weight_path = str(bg), str(adapter_dir)
    pipe = inference.build_pipeline(cfg, torch.device("cpu"), **TINY_MODELS)
    params = dict(pipe.unet.named_parameters())
    saved = torch.load(bg / "state.pt", weights_only=True)["trainable"]
    # the adapter's own checkpoint, loaded second, overrides its stage-1 attn_temp
    unet_side = {n: v for n, v in saved.items() if not n.startswith("controlnet_adapter.")}
    assert unet_side and all(torch.equal(params[n], v.to(params[n].dtype))
                             for n, v in unet_side.items())
    adapter = torch.load(adapter_dir / "adapter.pt", weights_only=True)
    for n, v in adapter.items():
        assert torch.equal(pipe.unet.controlnet_adapter.state_dict()[n], v.to(params[
            "controlnet_adapter." + n].dtype)), n
    # the reference's stand-alone adapter .pth (train_adaptor.py:397-399) loads
    # too (it raised NotImplementedError before the checkpoint readers)
    reference = {n: v + 1.0 for n, v in adapter.items()}
    torch.save(reference, tmp_path / "adapter.pth")
    cfg.adapter_weight_path = str(tmp_path / "adapter.pth")
    pipe = inference.build_pipeline(cfg, torch.device("cpu"), **TINY_MODELS)
    for n, v in reference.items():
        assert torch.equal(pipe.unet.controlnet_adapter.state_dict()[n], v.to(params[
            "controlnet_adapter." + n].dtype)), n
    cfg.adapter_weight_path = str(tmp_path / "missing.pth")
    with pytest.raises(FileNotFoundError):
        inference.build_pipeline(cfg, torch.device("cpu"), **TINY_MODELS)


def test_train_entry_points_refuse_to_fall_back_to_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for module, name in ((train_bg, "train-bg.yaml"), (train_adaptor, "train-motion.yaml")):
        with pytest.raises(RuntimeError, match="--device cpu"):
            module.main(osp.join(REPO, "configs", "smoke", name))


def test_step_generator_depends_on_seed_and_step_only():
    draw = [torch.randn(3, generator=train_bg.step_generator(33, s, torch.device("cpu")))
            for s in (0, 1, 0)]
    assert torch.equal(draw[0], draw[2]) and not torch.equal(draw[0], draw[1])
