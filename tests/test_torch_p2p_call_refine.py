"""``MotionEditorPipeline.__call__`` under the refine controller with
LocalBlend, from latents to the decoded video (one injected segment),
against JAX's pipeline on the same converted weights, fp32 on the CPU
(tests/torch_p2p_helpers.py: the comparison, the tolerance atol 2e-3 and
the LocalBlend threshold guard)."""

from torch_p2p_helpers import check_call, clear_of_threshold, models, pipelines  # noqa: F401


def test_call_with_refine_matches_jax(pipelines, clear_of_threshold):
    check_call(pipelines, clear_of_threshold, "refine", 0)
