"""``MotionEditorPipeline.__call__`` under prompt-to-prompt control with
LocalBlend, from latents to the decoded video, against JAX's pipeline on
the same converted weights, fp32 on the CPU (tests/torch_p2p_helpers.py:
the comparison, the tolerance atol 2e-3 and the LocalBlend threshold
guard): the replace controller over a vanilla and an injected segment (the
refine controller is in tests/test_torch_p2p_call_refine.py, reweight in
tests/test_torch_p2p_inference.py); also the refusal of a LocalBlend that
has no 16x16 site."""

import pytest
import torch

from torch_p2p_helpers import (  # noqa: F401 (fixtures)
    F,
    check_call,
    clear_of_threshold,
    controllers,
    models,
    pipelines,
)


def test_call_with_p2p_matches_jax(pipelines, clear_of_threshold):
    check_call(pipelines, clear_of_threshold, "replace", 2)


def test_call_refuses_local_blend_without_a_16x16_site(pipelines):
    _, pipe = pipelines
    ctl, _, blend, _ = controllers("replace", pipe.tokenizer, num_steps=3)
    with pytest.raises(ValueError, match="16x16"):
        pipe(["a girl is dancing", "a man is dancing"], torch.zeros((2, F, 8, 8, 4)),
             torch.zeros((F, 64, 64, 3)), p2p_controller=ctl, local_blend=blend,
             num_inference_steps=3)
