"""The port's entry point under prompt-to-prompt control, fp32 on the CPU:
``inference.edit`` on configs/smoke/eval-p2p.yaml, and ``__call__`` with
the reweight controller and LocalBlend, against the JAX package on the same
converted weights, atol 2e-3 (tests/torch_p2p_helpers.py: the comparison
and the LocalBlend threshold guard).

``test_inference_edit_runs_p2p`` is the test of ROADMAP C5: before the
port's ``edit`` read ``use_p2p``, it ran eval-p2p.yaml as a plain mask edit
without a word, and this comparison with JAX's p2p edit of the same file
failed. It uses only what that tree had, so it runs there too.
"""

import os.path as osp

import jax.numpy as jnp
import numpy as np

from motioneditor_tpu.control import p2p as JP
from motioneditor_tpu.data.dataset import VideoDataset as JaxVideoDataset

from motioneditor_tpu_torch import configs as TCF
from motioneditor_tpu_torch import inference
from motioneditor_tpu_torch.data.dataset import VideoDataset

from torch_p2p_helpers import (  # noqa: F401 (fixtures)
    F,
    SIZE,
    check_call,
    clear_of_threshold,
    models,
    pipelines,
    write_clip,
)

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))


def test_call_with_reweight_matches_jax(pipelines, clear_of_threshold):
    check_call(pipelines, clear_of_threshold, "reweight", 0)


def test_inference_edit_runs_p2p(pipelines, tmp_path, capsys):
    """configs/smoke/eval-p2p.yaml (replace + LocalBlend on "man") through
    the port's entry point on generated frames, against JAX's edit as
    scripts/inference.py drives it for the same file (frames -> VAE mean ->
    DDIM inversion -> the p2p edit)."""
    jpipe, pipe = pipelines
    cfg = TCF.load_config(osp.join(REPO, "configs", "smoke", "eval-p2p.yaml"))
    cfg.input_data.video_dir = write_clip(tmp_path / "case")  # the config's case is not here
    vd = cfg.validation_data
    assert vd.use_p2p and list(vd.p2p_blend_words) == ["man"]
    batch = VideoDataset(**vars(cfg.input_data))[0]
    out = inference.edit(pipe, cfg, batch)
    target = vd.prompts[0]
    got = out[target]
    assert got.shape == (2, F, SIZE, SIZE, 3) and np.isfinite(got).all()

    jbatch = JaxVideoDataset(**vars(cfg.input_data))[0]
    latents = jpipe.encode_video(jnp.asarray(jbatch["pixel_values"])[None], sample=False)
    inv = jpipe.ddim_invert(latents, prompt="", num_inv_steps=vd.num_inv_steps,
                            normal_infer=True)
    prompts = [cfg.input_data.prompt, target]
    controller = JP.make_controller(prompts, jpipe.tokenizer, vd.num_inference_steps,
                                    cross_replace_steps=vd.p2p_cross_replace_steps,
                                    self_replace_steps=vd.p2p_self_replace_steps)
    blend = JP.make_local_blend(prompts, [list(vd.p2p_blend_words)] * 2, jpipe.tokenizer,
                                threshold=vd.p2p_blend_threshold)
    ref = np.asarray(jpipe(prompts, jnp.concatenate([inv, inv]),
                           jnp.asarray(jbatch["target_conditions"]["openposefull"]),
                           source_masks=jnp.asarray(jbatch["source_masks"]),
                           num_inference_steps=vd.num_inference_steps,
                           guidance_scale=vd.guidance_scale,
                           controlnet_conditioning_scale=vd.controlnet_conditioning_scale,
                           p2p_controller=controller, local_blend=blend))
    err = float(np.abs(got - ref).max())
    assert err <= 2e-3, f"the port's edit of eval-p2p.yaml is {err} from JAX's p2p edit"
    assert "p2p control: replace + LocalBlend" in capsys.readouterr().out
