"""The port's OpenPose (models/openpose.py) against the JAX package's, fp32
on the CPU, on the same numpy-seeded weights and inputs.

- The body, hand and face networks at a small input (32 x 24), atol 1e-4.
- Both key layouts of the checkpoints load to the same module: the
  module-prefixed one and the prefix-stripped one the released files store
  (tests/fixtures/manifests/openpose_*.txt, checked at full size on the
  meta device).
- The cubic resize against ``jax.image.resize(..., "cubic")``, downsampling
  and upsampling at odd and even sizes, atol 1e-5 on values in [0, 1).
- The host decode (peaks, limbs, assembly) and the drawing on synthesized
  maps: equal results.
- ``render_skeleton_full`` on a stick figure, the networks of both packages
  replaced by the same stand-in that plants the figure's maps, body + hand
  + face: the same uint8 image.
"""

import os.path as osp

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from motioneditor_tpu.models import openpose as JO

from motioneditor_tpu_torch.models import openpose as TO
from motioneditor_tpu_torch.models.from_jax import (
    openpose_body_state_dict,
    openpose_face_state_dict,
    openpose_hand_state_dict,
)

from torch_port_helpers import random_params, setup_torch, tensor, to_jax

MANIFEST_DIR = osp.join(osp.dirname(__file__), "fixtures", "manifests")
NETS = {
    "body": (JO.init_body_params, openpose_body_state_dict, TO.BodyPoseModel, JO.body_forward,
             TO.body_forward, TO.load_body_params),
    "hand": (JO.init_hand_params, openpose_hand_state_dict, TO.HandPoseModel, JO.hand_forward,
             TO.hand_forward, TO.load_hand_params),
    "face": (JO.init_face_params, openpose_face_state_dict, TO.FaceModel, JO.face_forward,
             TO.face_forward, TO.load_face_params),
}


@pytest.fixture(autouse=True)
def _torch_threads():
    setup_torch()


def _nets(name, seed):
    init, to_sd, cls, _, _, _ = NETS[name]
    tree = random_params(lambda: init(jax.random.PRNGKey(0)), seed=seed)
    model = cls().eval()
    model.load_state_dict(to_sd(tree))
    return to_jax(tree), model


@pytest.mark.parametrize("name", ["body", "hand", "face"])
def test_forward_matches_jax(name):
    tree, model = _nets(name, seed={"body": 1, "hand": 2, "face": 3}[name])
    x = np.random.default_rng(4).standard_normal((1, 32, 24, 3)).astype(np.float32) * 0.5
    ref = jax.jit(NETS[name][3])(tree, jnp.asarray(x))
    with torch.no_grad():
        got = NETS[name][4](model, tensor(x))
    for g, r in zip(got if name == "body" else (got,), ref if name == "body" else (ref,)):
        assert g.shape == r.shape == (1, 4, 3, r.shape[-1])
        assert float(np.abs(np.asarray(r)).max()) > 1e-2
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=1e-4)


@pytest.mark.parametrize("name", ["body", "hand", "face"])
def test_both_key_layouts_load(tmp_path, name):
    """A checkpoint with the module-prefixed keys and one with the
    prefix-stripped keys give the same module through load_*_params."""
    _, model = _nets(name, seed=5)
    sd = model.state_dict()
    stripped = {k.split(".")[-2] + "." + k.split(".")[-1]: v for k, v in sd.items()}
    assert len(stripped) == len(sd)
    loaded = []
    for i, layout in enumerate((sd, stripped)):
        path = str(tmp_path / f"{i}.pth")
        torch.save(layout, path)
        loaded.append(NETS[name][5](path, device="cpu").state_dict())
    for k, v in sd.items():
        assert torch.equal(loaded[0][k], v) and torch.equal(loaded[1][k], v), k


@pytest.mark.parametrize("name", ["body", "hand", "face"])
def test_released_key_layout_maps_onto_the_module(name):
    """The released checkpoint's prefix-stripped keys and shapes
    (openpose_*.txt) map onto the full network with no key left over."""
    from motioneditor_tpu_torch.models.weights import load_into

    with open(osp.join(MANIFEST_DIR, f"openpose_{name}.txt")) as f:
        sd = {key: torch.empty(tuple(int(d) for d in shape.split(",")), device="meta")
              for key, shape in (line.split() for line in f)}
    convert = {"body": TO.convert_body_state_dict, "hand": TO.convert_hand_state_dict,
               "face": TO.convert_face_state_dict}[name]
    with torch.device("meta"):
        model = NETS[name][2]()
    load_into(model, convert(sd), name)
    with pytest.raises(ValueError, match="unexpected"):
        convert({"model0.conv1_1.weight.extra": sd[next(iter(sd))]})


@pytest.mark.parametrize("shape_in,shape_out", [
    ((512, 512), (184, 184)), ((37, 30), (11, 45)), ((23, 23), (184, 184)),
    ((184, 184), (512, 512)), ((30, 29), (30, 64)),
])
def test_cubic_resize_matches_jax(shape_in, shape_out):
    x = np.random.default_rng(6).random(shape_in + (3,)).astype(np.float32)
    ref = np.asarray(jax.image.resize(jnp.asarray(x), shape_out + (3,), "cubic"))
    got = TO.resize_cubic(torch.from_numpy(x), *shape_out).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-5)
    # F.interpolate's bicubic (a = -0.75, no antialias) is a different resize
    bicubic = torch.nn.functional.interpolate(
        torch.from_numpy(x).permute(2, 0, 1)[None], size=shape_out, mode="bicubic",
        align_corners=False)[0].permute(1, 2, 0).numpy()
    assert np.abs(bicubic - ref).max() > 1e-3


# -- decoding and drawing ---------------------------------------------------


def _stick_figure(scale=1.0):
    pts = {
        0: (64, 20), 1: (64, 34), 2: (50, 36), 3: (44, 56), 4: (40, 74),
        5: (78, 36), 6: (84, 56), 7: (88, 74), 8: (54, 70), 9: (52, 92),
        10: (52, 112), 11: (74, 70), 12: (76, 92), 13: (76, 112),
        14: (58, 16), 15: (70, 16), 16: (52, 18), 17: (76, 18),
    }
    return {k: (x * scale, y * scale) for k, (x, y) in pts.items()}


def _maps(pts, h, w, sigma2=8.0, width=2.0):
    """Heatmaps with a gaussian at each part and PAFs of unit vectors within
    ``width`` of each limb, on an h x w grid."""
    heat = np.zeros((h, w, TO.N_HEAT), np.float32)
    paf = np.zeros((h, w, TO.N_PAF), np.float32)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    for part, (px, py) in pts.items():
        heat[:, :, part] = np.exp(-((yy - py) ** 2 + (xx - px) ** 2) / sigma2)
    for k in range(len(TO.MAP_IDX)):
        a = np.array(pts[TO.LIMB_SEQ[k][0] - 1], np.float32)
        b = np.array(pts[TO.LIMB_SEQ[k][1] - 1], np.float32)
        d = b - a
        t = np.clip(((xx - a[0]) * d[0] + (yy - a[1]) * d[1]) / max(d @ d, 1e-6), 0, 1)
        near = np.hypot(xx - a[0] - t * d[0], yy - a[1] - t * d[1]) <= width
        unit = d / max(np.linalg.norm(d), 1e-6)
        paf[near, TO.MAP_IDX[k][0]] = unit[0]
        paf[near, TO.MAP_IDX[k][1]] = unit[1]
    return heat, paf


def test_decode_and_draw_match_jax():
    heat, paf = _maps(_stick_figure(), 128, 128)
    heat, paf = heat.astype(np.float64), paf.astype(np.float64)
    got = TO.decode_body(heat, paf)
    peaks = JO.find_peaks(heat)
    conn, special = JO.score_limbs(paf, peaks, 128)
    ref = JO.assemble_subsets(peaks, conn, special)
    assert got[1].shape == ref[1].shape == (1, 20) and got[1][0, -1] == 18
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g, r)
    np.testing.assert_array_equal(TO.draw_bodypose(*got, 128, 128),
                                  JO.draw_bodypose(*ref, 128, 128))
    np.testing.assert_array_equal(TO.gaussian_blur(heat[:, :, 0]), JO.gaussian_blur(heat[:, :, 0]))


def _planted(kind, pts_frame, frame):
    """A network stand-in: the maps of the stick figure (body), or of 21 / 70
    keypoints on a circle (hand, face), at the network's output grid for an
    input of the shape it is given."""

    def body(h, w):
        s = w / frame  # output cells per frame pixel
        return _maps({k: (x * s, y * s) for k, (x, y) in pts_frame.items()}, h, w,
                     sigma2=0.8, width=0.8)

    def ring(h, w, n):
        out = np.zeros((h, w, n + 1), np.float32)
        yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
        for i in range(n):
            a = 2 * np.pi * i / n
            cx, cy = w / 2 + 0.3 * w * np.cos(a), h / 2 + 0.3 * h * np.sin(a)
            out[:, :, i] = np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / 0.5)
        return out

    def maps(x_shape):
        h, w = x_shape[1] // 8, x_shape[2] // 8
        if kind == "body":
            heat, paf = body(h, w)
            return paf[None], heat[None]
        return ring(h, w, 21 if kind == "hand" else 70)[None]

    return maps


def test_render_skeleton_full_matches_jax(monkeypatch):
    """The whole estimation on one 256 x 256 frame with body, hand and face
    models, the networks of both packages replaced by the same stand-in:
    the same uint8 image, with every overlay drawn."""
    frame = 256
    pts = _stick_figure(frame / 128)
    image = np.random.default_rng(8).integers(0, 256, (frame, frame, 3), dtype=np.uint8)
    for kind in ("body", "hand", "face"):
        maps = _planted(kind, pts, frame)

        def port(model, x, maps=maps):
            out = maps(tuple(x.shape))
            return tuple(map(torch.from_numpy, out)) if isinstance(out, tuple) else \
                torch.from_numpy(out)

        def jax_net(params, x, maps=maps):
            out = maps(tuple(x.shape))
            return tuple(map(jnp.asarray, out)) if isinstance(out, tuple) else jnp.asarray(out)

        monkeypatch.setattr(TO, f"{kind}_forward", port)
        monkeypatch.setattr(JO, f"_jit_{kind}_forward", jax_net)
    nets = [torch.nn.Conv2d(1, 1, 1) for _ in range(3)]  # device holders only
    got = TO.render_skeleton_full(nets[0], image, hand_model=nets[1], face_model=nets[2])
    ref = JO.render_skeleton_full({}, image, hand_params={}, face_params={})
    cand, subset = TO.estimate_body(nets[0], image)
    assert subset.shape[0] == 1 and subset[0, -1] >= 14
    assert TO.hand_detect(cand, subset, frame, frame) and TO.face_detect(cand, subset, frame,
                                                                          frame)
    body_only = TO.draw_bodypose(cand, subset, frame, frame)
    assert (got != body_only).any()  # the hand and face overlays were drawn
    np.testing.assert_array_equal(got, ref)
