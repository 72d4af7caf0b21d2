"""The port's auto-mask denoise segment under prompt-to-prompt control with
each controller and LocalBlend, against JAX's ``_jit_denoise_segment`` on
the same converted weights, fp32 on the CPU (tests/torch_p2p_helpers.py:
the segment, the tolerance atol 2e-3 and the LocalBlend threshold guard).
With auto mode and LocalBlend both on, one list of 16x16 maps feeds the
injection and the running map sum, as in JAX."""

import pytest

from torch_p2p_helpers import check_segment, clear_of_threshold, models  # noqa: F401


@pytest.mark.parametrize("kind", ["replace", "refine", "reweight"])
def test_auto_segment_with_p2p_matches_jax(models, clear_of_threshold, kind):
    check_segment(models, clear_of_threshold, kind, "auto")
