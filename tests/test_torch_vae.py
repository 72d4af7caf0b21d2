"""The port's VAE (models/vae.py) against the JAX package on the same
converted weights, fp32 on the CPU, and its parameter names against the
SD-1.5 VAE checkpoint manifest.

Tolerances: moments and decoded images atol 1e-4, rtol 1e-4 (a few convs
and GroupNorms deep at a tiny width); sampling is checked as
mean + exp(logvar / 2) * noise with the generator's own noise, atol 1e-6.
"""

import os.path as osp

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from motioneditor_tpu.models import vae as JV

from motioneditor_tpu_torch.models import vae as TV
from motioneditor_tpu_torch.models.from_jax import vae_state_dict

from torch_port_helpers import assert_close, normal, random_params, setup_torch

TINY = dict(block_out_channels=(16, 32), layers_per_block=1, norm_num_groups=8)
MANIFEST = osp.join(osp.dirname(__file__), "fixtures", "manifests", "sd15_vae.txt")


@pytest.fixture(scope="module")
def tiny():
    setup_torch()
    jcfg, tcfg = JV.VAEConfig(**TINY), TV.VAEConfig(**TINY)
    tree = random_params(lambda: JV.init_vae(jax.random.PRNGKey(0), jcfg), seed=1)
    vae = TV.AutoencoderKL(tcfg).eval()
    vae.load_state_dict(vae_state_dict(tree))
    return jax.tree_util.tree_map(jnp.asarray, tree), jcfg, vae, tcfg


def test_config_defaults_match_jax():
    assert TV.VAEConfig() == TV.VAEConfig(**vars(JV.VAEConfig()))
    assert TV.SCALING_FACTOR == JV.SCALING_FACTOR


def test_encode_moments_match_jax(tiny):
    params, jcfg, vae, tcfg = tiny
    images = normal(np.random.default_rng(2), (2, 16, 16, 3), 0.5)
    mean_j, logvar_j = JV.vae_encode_moments(params, jnp.asarray(images), jcfg)
    with torch.no_grad():
        mean, logvar = TV.vae_encode_moments(vae, torch.from_numpy(images), tcfg)
    assert mean.shape == (2, 8, 8, 4)
    assert_close(mean, mean_j, atol=1e-4, rtol=1e-4)
    assert_close(logvar, logvar_j, atol=1e-4, rtol=1e-4)
    ref = JV.vae_encode(params, jnp.asarray(images), sample=False, config=jcfg)
    with torch.no_grad():
        lat = TV.vae_encode(vae, torch.from_numpy(images), config=tcfg)
    assert_close(lat, ref, atol=1e-4, rtol=1e-4)


def test_encode_samples_with_the_generator(tiny):
    _, _, vae, tcfg = tiny
    images = torch.from_numpy(normal(np.random.default_rng(3), (1, 16, 16, 3), 0.5))
    with torch.no_grad():
        mean, logvar = TV.vae_encode_moments(vae, images, tcfg)
        got = TV.vae_encode(vae, images, torch.Generator().manual_seed(4), config=tcfg)
    noise = torch.randn(mean.shape, generator=torch.Generator().manual_seed(4))
    want = (mean + torch.exp(0.5 * logvar) * noise) * TV.SCALING_FACTOR
    torch.testing.assert_close(got, want, atol=1e-6, rtol=0)
    assert not torch.allclose(got, mean * TV.SCALING_FACTOR)


def test_decode_and_video_match_jax(tiny):
    params, jcfg, vae, tcfg = tiny
    rng = np.random.default_rng(5)
    lat = normal(rng, (1, 2, 8, 8, 4), 0.2)
    ref = JV.vae_decode_video(params, jnp.asarray(lat), config=jcfg)
    with torch.no_grad():
        out = TV.vae_decode_video(vae, torch.from_numpy(lat), config=tcfg)
    assert out.shape == (1, 2, 16, 16, 3)
    assert_close(out, ref, atol=1e-4, rtol=1e-4)
    video = normal(rng, (1, 2, 16, 16, 3), 0.5)
    ref = JV.vae_encode_video(params, jnp.asarray(video), sample=False, config=jcfg)
    with torch.no_grad():
        out = TV.vae_encode_video(vae, torch.from_numpy(video), config=tcfg)
    assert_close(out, ref, atol=1e-4, rtol=1e-4)


def test_state_dict_matches_the_sd15_manifest():
    """Every key and shape of a real SD-1.5 VAE checkpoint, and no other
    (built on the meta device: no memory for 84M parameters)."""
    with open(MANIFEST) as f:
        want = {k: tuple(int(d) for d in s.split(",")) for k, s in
                (line.split() for line in f)}
    with torch.device("meta"):
        vae = TV.AutoencoderKL()
    got = {k: tuple(v.shape) for k, v in vae.state_dict().items()}
    assert got == want
