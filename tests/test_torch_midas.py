"""The port's MiDaS DPT-Hybrid (models/midas.py) against the JAX package's,
fp32 on the CPU, on the same numpy-seeded weights (converted with
models/from_jax.dpt_state_dict) and inputs.

- ``dpt_forward`` at 64 x 64 and at 64 x 128 (a 4 x 8 patch grid: the
  position embedding's 24 x 24 grid is resized), within 1e-4 of max |JAX|.
- ``estimate_depth`` at a multiple of 64 (no resize) and at 100 x 140 (the
  PIL resizes), at most 1 gray level from JAX's.
- The TF-"same" primitives against JAX's at stride 1 and 2, odd and even
  sizes: the standardized conv within 1e-6 of max |JAX| (fp32 sums of up
  to 294 terms), the max pool exactly.
- The module's key set and shapes equal those of the torch mirror in
  tests/test_midas.py, which emits the checkpoint layout
  ``convert_dpt_state_dict`` reads; ``load_dpt_params`` reads such a file,
  drops the ViT's unused final norm and head, and refuses any other key.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from motioneditor_tpu.models import midas as JM

from motioneditor_tpu_torch.models import midas as TM
from motioneditor_tpu_torch.models.from_jax import dpt_state_dict

from torch_port_helpers import random_params, setup_torch, tensor, to_jax


@pytest.fixture(autouse=True)
def _torch_threads():
    setup_torch()


@pytest.fixture(scope="module")
def dpt():
    """(JAX tree, port module) on the same seeded weights."""
    setup_torch()
    tree = random_params(lambda: JM.init_dpt_params(jax.random.PRNGKey(0)), seed=11)
    model = TM.DPTHybrid().eval()
    model.load_state_dict(dpt_state_dict(tree))
    return to_jax(tree), model


@pytest.mark.parametrize("hw", [(64, 64), (64, 128)])
def test_dpt_forward_matches_jax(dpt, hw):
    tree, model = dpt
    x = np.random.default_rng(12).uniform(-1, 1, (1,) + hw + (3,)).astype(np.float32)
    ref = np.asarray(JM.dpt_forward(tree, jnp.asarray(x)))
    with torch.no_grad():
        got = TM.dpt_forward(model, tensor(x)).numpy()
    assert got.shape == ref.shape == (1,) + hw
    scale = float(np.abs(ref).max())
    assert scale > 0 and float(np.abs(got - ref).max()) <= 1e-4 * scale


@pytest.mark.parametrize("hw", [(64, 64), (100, 140)])
def test_estimate_depth_matches_jax(dpt, hw):
    tree, model = dpt
    img = np.random.default_rng(13).integers(0, 256, hw + (3,), dtype=np.uint8)
    ref = JM.estimate_depth(tree, img)
    got = TM.estimate_depth(model, img)
    assert got.shape == ref.shape == hw + (3,) and got.dtype == np.uint8
    assert int(np.abs(got.astype(int) - ref.astype(int)).max()) <= 1
    assert ref.max() > ref.min()  # not a flat image


@pytest.mark.parametrize("size", [(8, 8), (9, 7)])
@pytest.mark.parametrize("stride", [1, 2])
def test_same_padding_primitives_match_jax(size, stride):
    rng = np.random.default_rng(14)
    x = rng.standard_normal((1,) + size + (6,)).astype(np.float32)
    for k in (1, 3, 7):
        w = rng.standard_normal((k, k, 6, 4)).astype(np.float32)
        conv = torch.nn.Conv2d(6, 4, k, bias=False)
        conv.weight.data = torch.from_numpy(w.transpose(3, 2, 0, 1).copy())
        ref = np.asarray(JM.std_conv2d({"kernel": jnp.asarray(w)}, jnp.asarray(x), stride))
        with torch.no_grad():
            got = TM.std_conv2d(conv, tensor(x).permute(0, 3, 1, 2), stride)
        np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), ref,
                                   atol=1e-6 * float(np.abs(ref).max()))
    ref = np.asarray(JM.max_pool_same(jnp.asarray(x), 3, stride))
    got = TM.max_pool_same(tensor(x).permute(0, 3, 1, 2), 3, stride).permute(0, 2, 3, 1)
    np.testing.assert_array_equal(got.numpy(), ref)


def test_key_layout_is_the_checkpoint_mirror():
    from test_midas import TorchDPT

    with torch.device("meta"):
        mirror = {k: tuple(v.shape) for k, v in TorchDPT().state_dict().items()}
        port = {k: tuple(v.shape) for k, v in TM.DPTHybrid().state_dict().items()}
    assert port == mirror


def test_load_dpt_params_reads_the_checkpoint_layout(tmp_path, dpt):
    _, model = dpt
    sd = dict(model.state_dict())
    sd.update({"pretrained.model.norm.weight": torch.ones(768),
               "pretrained.model.norm.bias": torch.zeros(768),
               "pretrained.model.head.weight": torch.zeros(1000, 768),
               "pretrained.model.head.bias": torch.zeros(1000)})
    path = str(tmp_path / "dpt.pt")
    torch.save({"state_dict": sd}, path)
    loaded = TM.load_dpt_params(path).state_dict()
    for k, v in model.state_dict().items():
        assert torch.equal(loaded[k], v), k
    torch.save(dict(sd, **{"scratch.stray.weight": torch.zeros(1)}), path)
    with pytest.raises(KeyError, match="stray"):
        TM.load_dpt_params(path)
