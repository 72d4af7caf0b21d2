"""OpenPose body, hand and face networks with host-side decoding and
drawing (port of motioneditor_tpu/models/openpose.py).

The reference makes its skeleton conditions with controlnet_aux's
OpenposeDetector (data_preparation/video_skeletons.py:13-21, :63-83): the
CMU two-branch body network (pytorch-openpose ``body.py``: a truncated
VGG-19 stem, then six stages of 38 part-affinity-field (PAF) and 19
heatmap channels), and with ``hand_and_face`` the hand (``hand.py``) and
face (``FaceNet``) keypoint networks. ``BodyPoseModel``, ``HandPoseModel``
and ``FaceModel`` hold their convolutions under pytorch-openpose's
module-prefixed names (``model0.conv1_1.weight``,
``model2_1.Mconv1_stage2_L1.weight``; the face network's are flat); the
``convert_*_state_dict`` functions also take the prefix-stripped keys the
released checkpoints store (tests/fixtures/manifests/openpose_*.txt).

Only the networks and the resizes run on the device. The resizes are
``jax.image.resize(..., "cubic")``: a Keys cubic (a = -0.5) at half-pixel
centres whose kernel widens by the scale when it downsamples
(``cubic_resize_weights``), applied as two einsums. Peak finding, limb
scoring, multi-person assembly, the hand and face boxes and the drawing
are host-side numpy, a copy of JAX's.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

# ---------------------------------------------------------------------------
# architecture tables (pytorch-openpose body.py / hand.py, FaceNet)
# ---------------------------------------------------------------------------

# (name, in_ch, out_ch, kernel); "pool" entries are 2x2 stride-2 max pools
_STEM: Tuple = (
    ("conv1_1", 3, 64, 3), ("conv1_2", 64, 64, 3), "pool1",
    ("conv2_1", 64, 128, 3), ("conv2_2", 128, 128, 3), "pool2",
    ("conv3_1", 128, 256, 3), ("conv3_2", 256, 256, 3),
    ("conv3_3", 256, 256, 3), ("conv3_4", 256, 256, 3), "pool3",
    ("conv4_1", 256, 512, 3), ("conv4_2", 512, 512, 3),
    ("conv4_3_CPM", 512, 256, 3), ("conv4_4_CPM", 256, 128, 3),
)

N_PAF = 38
N_HEAT = 19
_STAGE1_OUT = {1: N_PAF, 2: N_HEAT}
STRIDE = 8  # three 2x2 pools


def _stage1_layers(branch: int) -> List[Tuple[str, int, int, int]]:
    s = f"_CPM_L{branch}"
    return [
        (f"conv5_1{s}", 128, 128, 3), (f"conv5_2{s}", 128, 128, 3),
        (f"conv5_3{s}", 128, 128, 3), (f"conv5_4{s}", 128, 512, 1),
        (f"conv5_5{s}", 512, _STAGE1_OUT[branch], 1),
    ]


def _stageT_layers(stage: int, branch: int) -> List[Tuple[str, int, int, int]]:
    s = f"_stage{stage}_L{branch}"
    cin = N_PAF + N_HEAT + 128
    return [
        (f"Mconv1{s}", cin, 128, 7), (f"Mconv2{s}", 128, 128, 7),
        (f"Mconv3{s}", 128, 128, 7), (f"Mconv4{s}", 128, 128, 7),
        (f"Mconv5{s}", 128, 128, 7), (f"Mconv6{s}", 128, 128, 1),
        (f"Mconv7{s}", 128, _STAGE1_OUT[branch], 1),
    ]


def _branch_layers(stage: int, branch: int):
    return _stage1_layers(branch) if stage == 1 else _stageT_layers(stage, branch)


N_HAND = 22  # 21 keypoints + background

_HAND_STEM: Tuple = (
    ("conv1_1", 3, 64, 3), ("conv1_2", 64, 64, 3), "pool1",
    ("conv2_1", 64, 128, 3), ("conv2_2", 128, 128, 3), "pool2",
    ("conv3_1", 128, 256, 3), ("conv3_2", 256, 256, 3),
    ("conv3_3", 256, 256, 3), ("conv3_4", 256, 256, 3), "pool3",
    ("conv4_1", 256, 512, 3), ("conv4_2", 512, 512, 3),
    ("conv4_3", 512, 512, 3), ("conv4_4", 512, 512, 3),
    ("conv5_1", 512, 512, 3), ("conv5_2", 512, 512, 3),
    ("conv5_3_CPM", 512, 128, 3),
)
_HAND_STAGE1 = [("conv6_1_CPM", 128, 512, 1), ("conv6_2_CPM", 512, N_HAND, 1)]


def _hand_stageT_layers(stage: int) -> List[Tuple[str, int, int, int]]:
    s = f"_stage{stage}"
    cin = N_HAND + 128
    return [
        (f"Mconv1{s}", cin, 128, 7), (f"Mconv2{s}", 128, 128, 7),
        (f"Mconv3{s}", 128, 128, 7), (f"Mconv4{s}", 128, 128, 7),
        (f"Mconv5{s}", 128, 128, 7), (f"Mconv6{s}", 128, 128, 1),
        (f"Mconv7{s}", 128, N_HAND, 1),
    ]


N_FACE = 71  # 70 landmarks + background
_FACE_STEM: Tuple = _HAND_STEM  # the same VGG stem through conv5_3_CPM
_FACE_STAGE1 = [("conv6_1_CPM", 128, 512, 1), ("conv6_2_CPM", 512, N_FACE, 1)]


def _face_stageT_layers(stage: int) -> List[Tuple[str, int, int, int]]:
    s = f"_stage{stage}"
    cin = N_FACE + 128
    return [
        (f"Mconv1{s}", cin, 128, 7), (f"Mconv2{s}", 128, 128, 7),
        (f"Mconv3{s}", 128, 128, 7), (f"Mconv4{s}", 128, 128, 7),
        (f"Mconv5{s}", 128, 128, 7), (f"Mconv6{s}", 128, 128, 1),
        (f"Mconv7{s}", 128, N_FACE, 1),
    ]


# ---------------------------------------------------------------------------
# the networks
# ---------------------------------------------------------------------------


def _add_convs(m: nn.Module, layers: Sequence) -> nn.Module:
    for item in layers:
        if not isinstance(item, str):
            name, cin, cout, k = item
            setattr(m, name, nn.Conv2d(cin, cout, k, padding=k // 2))
    return m


def _run(m: nn.Module, layers: Sequence, x: torch.Tensor, no_relu: str) -> torch.Tensor:
    """NCHW layers of a table: 2x2 VALID max pools, convs padded k // 2, a
    ReLU after every conv but ``no_relu``."""
    for item in layers:
        if isinstance(item, str):
            x = F.max_pool2d(x, 2, 2)
            continue
        conv = getattr(m, item[0])
        x = F.conv2d(x, conv.weight.to(x.dtype), conv.bias.to(x.dtype), padding=item[3] // 2)
        if item[0] != no_relu:
            x = F.relu(x)
    return x


class BodyPoseModel(nn.Module):
    """pytorch-openpose's ``bodypose_model``: ``model0`` (the stem) and
    ``model{stage}_{branch}`` (branch 1 PAFs, branch 2 heatmaps)."""

    def __init__(self):
        super().__init__()
        self.model0 = _add_convs(nn.Module(), _STEM)
        for stage in range(1, 7):
            for branch in (1, 2):
                setattr(self, f"model{stage}_{branch}",
                        _add_convs(nn.Module(), _branch_layers(stage, branch)))


class HandPoseModel(nn.Module):
    """pytorch-openpose's ``handpose_model``: ``model1_0`` (the stem),
    ``model1_1`` (stage 1) and ``model2`` ... ``model6``."""

    def __init__(self):
        super().__init__()
        self.model1_0 = _add_convs(nn.Module(), _HAND_STEM)
        self.model1_1 = _add_convs(nn.Module(), _HAND_STAGE1)
        for stage in range(2, 7):
            setattr(self, f"model{stage}", _add_convs(nn.Module(), _hand_stageT_layers(stage)))


class FaceModel(nn.Module):
    """controlnet_aux's ``FaceNet``: every layer at the top level."""

    def __init__(self):
        super().__init__()
        _add_convs(self, _FACE_STEM)
        _add_convs(self, _FACE_STAGE1)
        for stage in range(2, 7):
            _add_convs(self, _face_stageT_layers(stage))


def body_forward(model: BodyPoseModel, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: [B, H, W, 3] (H, W multiples of 8), already ``img / 256 - 0.5``.
    Returns the stage-6 (paf [B, H/8, W/8, 38], heatmap [B, H/8, W/8, 19]).
    The stem's last conv keeps its ReLU, a stage's last conv has none."""
    feat = _run(model.model0, _STEM, x.permute(0, 3, 1, 2), no_relu="")
    paf = _run(model.model1_1, _stage1_layers(1), feat, "conv5_5_CPM_L1")
    heat = _run(model.model1_2, _stage1_layers(2), feat, "conv5_5_CPM_L2")
    for stage in range(2, 7):
        inp = torch.cat([paf, heat, feat], dim=1)
        paf = _run(getattr(model, f"model{stage}_1"), _stageT_layers(stage, 1), inp,
                   f"Mconv7_stage{stage}_L1")
        heat = _run(getattr(model, f"model{stage}_2"), _stageT_layers(stage, 2), inp,
                    f"Mconv7_stage{stage}_L2")
    return paf.permute(0, 2, 3, 1), heat.permute(0, 2, 3, 1)


def hand_forward(model: HandPoseModel, x: torch.Tensor) -> torch.Tensor:
    """x: [B, H, W, 3], ``img / 256 - 0.5`` -> stage-6 heatmaps
    [B, H/8, W/8, 22]; each stage reads cat([heatmap, features])."""
    feat = _run(model.model1_0, _HAND_STEM, x.permute(0, 3, 1, 2), no_relu="")
    out = _run(model.model1_1, _HAND_STAGE1, feat, "conv6_2_CPM")
    for stage in range(2, 7):
        out = _run(getattr(model, f"model{stage}"), _hand_stageT_layers(stage),
                   torch.cat([out, feat], dim=1), f"Mconv7_stage{stage}")
    return out.permute(0, 2, 3, 1)


def face_forward(model: FaceModel, x: torch.Tensor) -> torch.Tensor:
    """x: [B, H, W, 3], ``img / 256 - 0.5`` -> stage-6 heatmaps
    [B, H/8, W/8, 71]."""
    feat = _run(model, _FACE_STEM, x.permute(0, 3, 1, 2), no_relu="")
    out = _run(model, _FACE_STAGE1, feat, "conv6_2_CPM")
    for stage in range(2, 7):
        out = _run(model, _face_stageT_layers(stage), torch.cat([out, feat], dim=1),
                   f"Mconv7_stage{stage}")
    return out.permute(0, 2, 3, 1)


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------


def _body_module_for_layer(layer: str) -> str:
    if layer.startswith(("conv1_", "conv2_", "conv3_", "conv4_")):
        return "model0"
    if layer.startswith("conv5_") and "_CPM_L" in layer:
        return f"model1_{layer.rsplit('L', 1)[1]}"
    if layer.startswith("Mconv") and "_stage" in layer:
        stage, branch = layer.rsplit("_stage", 1)[1].split("_L")
        return f"model{stage}_{branch}"
    raise ValueError(f"unexpected body checkpoint layer {layer!r}")


def _hand_module_for_layer(layer: str) -> str:
    if layer.startswith(("conv1_", "conv2_", "conv3_", "conv4_", "conv5_")):
        return "model1_0"
    if layer.startswith("conv6_"):
        return "model1_1"
    if layer.startswith("Mconv") and "_stage" in layer:
        return f"model{layer.rsplit('_stage', 1)[1]}"
    raise ValueError(f"unexpected hand checkpoint layer {layer!r}")


def _prefixed(sd: Dict[str, torch.Tensor], module_for_layer, what: str):
    out = {}
    for key, value in sd.items():
        parts = key.split(".")
        if len(parts) == 2 and parts[1] in ("weight", "bias"):
            key = f"{module_for_layer(parts[0])}.{key}"
        elif not (len(parts) == 3 and parts[2] in ("weight", "bias")):
            raise ValueError(f"unexpected {what} checkpoint key {key!r}")
        out[key] = value
    return out


def convert_body_state_dict(sd: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """``body_pose_model.pth`` keys, module-prefixed or prefix-stripped (as
    the released file stores them: ``conv1_1.weight``), onto
    ``BodyPoseModel``'s: the layer name alone names the module (JAX
    openpose.py:99-139)."""
    return _prefixed(sd, _body_module_for_layer, "body")


def convert_hand_state_dict(sd: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """``hand_pose_model.pth`` keys, prefixed or prefix-stripped, onto
    ``HandPoseModel``'s (JAX openpose.py:507-537)."""
    return _prefixed(sd, _hand_module_for_layer, "hand")


def convert_face_state_dict(sd: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """``facenet.pth``'s flat ``layer.weight`` keys, which are ``FaceModel``'s
    (JAX openpose.py:728)."""
    for key in sd:
        parts = key.split(".")
        if len(parts) != 2 or parts[1] not in ("weight", "bias"):
            raise ValueError(f"unexpected face checkpoint key {key!r}")
    return dict(sd)


def _load(cls, convert, path: str, device) -> nn.Module:
    from motioneditor_tpu_torch.models.weights import load_into, load_state_dict

    with torch.device(device):
        model = cls()
    return load_into(model, convert(load_state_dict(path)), path).eval()


def load_body_params(path: str, device="cpu") -> BodyPoseModel:
    """A ``body_pose_model.pth`` into a ``BodyPoseModel`` on ``device``."""
    return _load(BodyPoseModel, convert_body_state_dict, path, device)


def load_hand_params(path: str, device="cpu") -> HandPoseModel:
    return _load(HandPoseModel, convert_hand_state_dict, path, device)


def load_face_params(path: str, device="cpu") -> FaceModel:
    return _load(FaceModel, convert_face_state_dict, path, device)


# ---------------------------------------------------------------------------
# the resize (jax.image.resize "cubic") and the device part of estimation
# ---------------------------------------------------------------------------


def cubic_resize_weights(in_size: int, out_size: int) -> np.ndarray:
    """[in_size, out_size] float32 weights of ``jax.image.resize(...,
    "cubic")`` along one axis (jax.image.scale_and_translate's
    ``compute_weight_mat``, in its float32 order of operations): the Keys
    cubic (a = -0.5) at the sample positions of half-pixel centres, its
    argument divided by the scale when downsampling (antialiasing), each
    output's weights normalised to sum 1, outputs whose sample falls outside
    the input zeroed. (``F.interpolate(mode="bicubic")`` has a = -0.75 and
    no antialiasing.)"""
    f32 = np.float32
    inv_scale = f32(1.0 / (out_size / in_size))
    kernel_scale = max(inv_scale, f32(1.0))
    sample = (np.arange(out_size, dtype=f32) + f32(0.5)) * inv_scale - f32(0.0) - f32(0.5)
    x = np.abs(sample[None, :] - np.arange(in_size, dtype=f32)[:, None]) / kernel_scale
    w = ((f32(1.5) * x - f32(2.5)) * x) * x + f32(1.0)
    w = np.where(x >= 1.0, ((f32(-0.5) * x + f32(2.5)) * x - f32(4.0)) * x + f32(2.0), w)
    w = np.where(x >= 2.0, f32(0.0), w).astype(f32)
    total = w.sum(axis=0, keepdims=True, dtype=f32)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(f32).eps),
                 w / np.where(total != 0, total, f32(1.0)), f32(0.0)).astype(f32)
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return np.where(inside[None, :], w, f32(0.0)).astype(f32)


def resize_cubic(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """[H, W, C] -> [h, w, C] in fp32, ``jax.image.resize(x, (h, w, C),
    "cubic")``: two einsums with ``cubic_resize_weights`` (an axis whose
    size stays is left as it is, as JAX does)."""
    x = x.float()
    if x.shape[0] != h:
        wh = torch.from_numpy(cubic_resize_weights(x.shape[0], h)).to(x.device)
        x = torch.einsum("hwc,ho->owc", x, wh)
    if x.shape[1] != w:
        ww = torch.from_numpy(cubic_resize_weights(x.shape[1], w)).to(x.device)
        x = torch.einsum("hwc,wo->hoc", x, ww)
    return x


def _pad_to_stride(img: torch.Tensor, pad_value: float = 0.0) -> torch.Tensor:
    """Pad [H, W, C] right and down to multiples of STRIDE (body.py
    padRightDownCorner)."""
    h, w = img.shape[:2]
    ph, pw = (STRIDE - h % STRIDE) % STRIDE, (STRIDE - w % STRIDE) % STRIDE
    if ph or pw:
        img = F.pad(img, (0, 0, 0, pw, 0, ph), value=pad_value)
    return img


def _network_maps(forward, model, image: torch.Tensor, h: int, w: int, out_h: int,
                  out_w: int) -> torch.Tensor:
    """One scale of estimation on the device: the frame resized to (h, w),
    ``/ 256 - 0.5``, padded to the stride, the network, its maps resized
    back to the padded size, cropped to (h, w), resized to (out_h, out_w)."""
    img = _pad_to_stride(resize_cubic(image, h, w) / 256.0 - 0.5)
    with torch.no_grad():
        maps = forward(model, img[None])
    if isinstance(maps, tuple):
        return tuple(_maps_back(m[0], img.shape, h, w, out_h, out_w) for m in maps)
    return _maps_back(maps[0], img.shape, h, w, out_h, out_w)


def _maps_back(m, padded_shape, h, w, out_h, out_w):
    m = resize_cubic(m, padded_shape[0], padded_shape[1])[:h, :w]
    return resize_cubic(m, out_h, out_w)


def _device_image(image_rgb, model) -> torch.Tensor:
    device = next(model.parameters()).device
    return torch.tensor(np.asarray(image_rgb), device=device).float()


def body_maps(model: BodyPoseModel, image_rgb: np.ndarray, boxsize: int = 368,
              scale_search: Sequence[float] = (0.5,)) -> Tuple[np.ndarray, np.ndarray]:
    """The scale-averaged (heatmap [H, W, 19], paf [H, W, 38]) of one uint8
    RGB frame at its own size, float64 on the host (body.py __call__)."""
    ori_h, ori_w = image_rgb.shape[:2]
    image = _device_image(image_rgb, model)
    heat_avg = np.zeros((ori_h, ori_w, N_HEAT), np.float64)
    paf_avg = np.zeros((ori_h, ori_w, N_PAF), np.float64)
    for scale in [s * boxsize / ori_h for s in scale_search]:
        h, w = int(round(ori_h * scale)), int(round(ori_w * scale))
        paf, heat = _network_maps(body_forward, model, image, h, w, ori_h, ori_w)
        heat_avg += heat.cpu().numpy() / len(scale_search)
        paf_avg += paf.cpu().numpy() / len(scale_search)
    return heat_avg, paf_avg


# ---------------------------------------------------------------------------
# host-side decoding (body.py __call__ post-processing, numpy)
# ---------------------------------------------------------------------------

# limb part pairs (1-indexed) and their PAF channel pairs (body.py limbSeq /
# mapIdx, the +19 offset removed)
LIMB_SEQ = np.array([
    [2, 3], [2, 6], [3, 4], [4, 5], [6, 7], [7, 8], [2, 9], [9, 10],
    [10, 11], [2, 12], [12, 13], [13, 14], [2, 1], [1, 15], [15, 17],
    [1, 16], [16, 18], [3, 17], [6, 18],
])
MAP_IDX = np.array([
    [12, 13], [20, 21], [14, 15], [16, 17], [22, 23], [24, 25], [0, 1],
    [2, 3], [4, 5], [6, 7], [8, 9], [10, 11], [28, 29], [30, 31], [34, 35],
    [32, 33], [36, 37], [18, 19], [26, 27],
])


def gaussian_blur(x: np.ndarray, sigma: float = 3.0) -> np.ndarray:
    """Separable gaussian with scipy.ndimage.gaussian_filter's reflect
    boundary and truncate 4.0, on a 2D map."""
    radius = int(4.0 * sigma + 0.5)
    t = np.arange(-radius, radius + 1, dtype=np.float64)
    k = np.exp(-0.5 * (t / sigma) ** 2)
    k /= k.sum()
    pad = np.pad(x.astype(np.float64), radius, mode="symmetric")
    out = np.apply_along_axis(lambda r: np.convolve(r, k, mode="valid"), 1, pad)
    return np.apply_along_axis(lambda c: np.convolve(c, k, mode="valid"), 0, out)


def find_peaks(heatmap: np.ndarray, thre1: float = 0.1):
    """Per part (18), the local maxima of the blurred map above ``thre1``:
    a list of [(x, y, score, peak_id)], scores from the unblurred map."""
    all_peaks = []
    peak_counter = 0
    for part in range(N_HEAT - 1):
        map_ori = heatmap[:, :, part]
        m = gaussian_blur(map_ori)
        up = np.zeros_like(m); up[1:, :] = m[:-1, :]
        down = np.zeros_like(m); down[:-1, :] = m[1:, :]
        left = np.zeros_like(m); left[:, 1:] = m[:, :-1]
        right = np.zeros_like(m); right[:, :-1] = m[:, 1:]
        binary = (m >= up) & (m >= down) & (m >= left) & (m >= right) & (m > thre1)
        ys, xs = np.nonzero(binary)
        peaks = [(x, y, float(map_ori[y, x]), peak_counter + i)
                 for i, (x, y) in enumerate(zip(xs, ys))]
        peak_counter += len(peaks)
        all_peaks.append(peaks)
    return all_peaks


def score_limbs(paf: np.ndarray, all_peaks, img_h: int, thre2: float = 0.05):
    """PAF line-integral limb scores and greedy matching per limb type.
    Returns (connection_all, special_k)."""
    mid_num = 10
    connection_all = []
    special_k = []
    for k in range(len(MAP_IDX)):
        score_mid = paf[:, :, MAP_IDX[k]]
        cand_a = all_peaks[LIMB_SEQ[k][0] - 1]
        cand_b = all_peaks[LIMB_SEQ[k][1] - 1]
        if not cand_a or not cand_b:
            special_k.append(k)
            connection_all.append([])
            continue
        candidates = []
        for i, a in enumerate(cand_a):
            for j, b in enumerate(cand_b):
                vec = np.subtract(b[:2], a[:2], dtype=np.float64)
                norm = max(math.sqrt(vec @ vec), 1e-8)
                vecn = vec / norm
                xs = np.linspace(a[0], b[0], num=mid_num)
                ys = np.linspace(a[1], b[1], num=mid_num)
                pts = np.stack([np.round(ys), np.round(xs)], -1).astype(int)
                score_midpts = score_mid[pts[:, 0], pts[:, 1]] @ vecn
                prior = score_midpts.mean() + min(0.5 * img_h / norm - 1, 0)
                crit1 = np.count_nonzero(score_midpts > thre2) > 0.8 * mid_num
                if crit1 and prior > 0:
                    candidates.append((i, j, prior, prior + a[2] + b[2]))
        candidates.sort(key=lambda c: c[2], reverse=True)
        connection = []
        used_a, used_b = set(), set()
        for i, j, s, _ in candidates:
            if i in used_a or j in used_b:
                continue
            connection.append([cand_a[i][3], cand_b[j][3], s, i, j])
            used_a.add(i); used_b.add(j)
            if len(connection) >= min(len(cand_a), len(cand_b)):
                break
        connection_all.append(np.array(connection, dtype=np.float64))
    return connection_all, special_k


def assemble_subsets(all_peaks, connection_all, special_k):
    """Greedy multi-person assembly. Returns (candidate [num_peaks, 4],
    subset [num_people, 20])."""
    flat = [p for part in all_peaks for p in part]
    candidate = np.array(flat, dtype=np.float64).reshape(-1, 4)
    subset = np.empty((0, 20), dtype=np.float64)
    for k in range(len(MAP_IDX)):
        if k in special_k or len(connection_all[k]) == 0:
            continue
        part_as = connection_all[k][:, 0]
        part_bs = connection_all[k][:, 1]
        idx_a, idx_b = LIMB_SEQ[k] - 1
        for i in range(len(connection_all[k])):
            found = 0
            subset_idx = [-1, -1]
            for j in range(len(subset)):
                if subset[j][idx_a] == part_as[i] or subset[j][idx_b] == part_bs[i]:
                    subset_idx[found] = j
                    found += 1
            if found == 1:
                j = subset_idx[0]
                if subset[j][idx_b] != part_bs[i]:
                    subset[j][idx_b] = part_bs[i]
                    subset[j][-1] += 1
                    subset[j][-2] += candidate[int(part_bs[i]), 2] + connection_all[k][i][2]
            elif found == 2:
                j1, j2 = subset_idx
                membership = ((subset[j1] >= 0).astype(int) + (subset[j2] >= 0).astype(int))[:-2]
                if not np.any(membership == 2):  # disjoint: merge
                    subset[j1][:-2] += subset[j2][:-2] + 1
                    subset[j1][-2:] += subset[j2][-2:]
                    subset[j1][-2] += connection_all[k][i][2]
                    subset = np.delete(subset, j2, 0)
                else:
                    subset[j1][idx_b] = part_bs[i]
                    subset[j1][-1] += 1
                    subset[j1][-2] += candidate[int(part_bs[i]), 2] + connection_all[k][i][2]
            elif found == 0 and k < 17:
                row = -1 * np.ones(20)
                row[idx_a] = part_as[i]
                row[idx_b] = part_bs[i]
                row[-1] = 2
                row[-2] = (candidate[connection_all[k][i, :2].astype(int), 2].sum()
                           + connection_all[k][i][2])
                subset = np.vstack([subset, row])
    keep = [i for i in range(len(subset))
            if subset[i][-1] >= 4 and subset[i][-2] / subset[i][-1] >= 0.4]
    return candidate, subset[keep]


def decode_body(heat: np.ndarray, paf: np.ndarray, thre1: float = 0.1, thre2: float = 0.05):
    """(candidate, subset) from the frame-size maps."""
    all_peaks = find_peaks(heat, thre1=thre1)
    connection_all, special_k = score_limbs(paf, all_peaks, heat.shape[0], thre2=thre2)
    return assemble_subsets(all_peaks, connection_all, special_k)


def estimate_body(model: BodyPoseModel, image_rgb: np.ndarray, boxsize: int = 368,
                  scale_search: Sequence[float] = (0.5,), thre1: float = 0.1,
                  thre2: float = 0.05):
    """Body estimation on one uint8 RGB frame (body.py __call__; one 0.5
    scale as controlnet_aux runs it). Returns (candidate, subset) in image
    coordinates."""
    heat, paf = body_maps(model, image_rgb, boxsize, scale_search)
    return decode_body(heat, paf, thre1, thre2)


# controlnet_aux util.draw_bodypose colors (18 parts / 17 drawn limbs)
_COLORS = [
    (255, 0, 0), (255, 85, 0), (255, 170, 0), (255, 255, 0), (170, 255, 0),
    (85, 255, 0), (0, 255, 0), (0, 255, 85), (0, 255, 170), (0, 255, 255),
    (0, 170, 255), (0, 85, 255), (0, 0, 255), (85, 0, 255), (170, 0, 255),
    (255, 0, 255), (255, 0, 170), (255, 0, 85),
]


def _fill_ellipse(canvas, cx, cy, a, b, angle, color):
    """A filled rotated ellipse through a coordinate mask."""
    h, w = canvas.shape[:2]
    r = int(math.ceil(max(a, b))) + 1
    x0, x1 = max(int(cx) - r, 0), min(int(cx) + r + 1, w)
    y0, y1 = max(int(cy) - r, 0), min(int(cy) + r + 1, h)
    if x0 >= x1 or y0 >= y1:
        return
    ys, xs = np.mgrid[y0:y1, x0:x1]
    dx, dy = xs - cx, ys - cy
    ca, sa = math.cos(angle), math.sin(angle)
    u = dx * ca + dy * sa
    v = -dx * sa + dy * ca
    mask = (u / max(a, 1e-6)) ** 2 + (v / max(b, 1e-6)) ** 2 <= 1.0
    canvas[y0:y1, x0:x1][mask] = color


def draw_bodypose(candidate: np.ndarray, subset: np.ndarray, height: int,
                  width: int) -> np.ndarray:
    """The skeleton image (controlnet_aux util.draw_bodypose): 17 limb
    ellipses blended at 0.6, then 18 keypoint circles."""
    canvas = np.zeros((height, width, 3), np.float64)
    stickwidth = 4
    for i in range(17):
        for n in range(len(subset)):
            index = subset[n][LIMB_SEQ[i] - 1]
            if -1 in index:
                continue
            ys = candidate[index.astype(int), 1]
            xs = candidate[index.astype(int), 0]
            m_x, m_y = xs.mean(), ys.mean()
            length = math.hypot(xs[0] - xs[1], ys[0] - ys[1])
            angle = math.atan2(ys[0] - ys[1], xs[0] - xs[1])
            cur = canvas.copy()
            _fill_ellipse(cur, m_x, m_y, length / 2, stickwidth, angle, _COLORS[i])
            canvas = canvas * 0.4 + cur * 0.6
    for i in range(18):
        for n in range(len(subset)):
            index = int(subset[n][i])
            if index == -1:
                continue
            x, y = candidate[index][0:2]
            _fill_ellipse(canvas, x, y, 4, 4, 0.0, _COLORS[i])
    return canvas.clip(0, 255).astype(np.uint8)


# ---------------------------------------------------------------------------
# hands and faces
# ---------------------------------------------------------------------------


def hand_maps(model: HandPoseModel, image_rgb: np.ndarray, boxsize: int = 368,
              scale_search: Sequence[float] = (0.5, 1.0, 1.5, 2.0)) -> np.ndarray:
    """The scale-averaged hand heatmaps [H, W, 22] of one crop, float64 on
    the host (hand.py __call__)."""
    ori_h, ori_w = image_rgb.shape[:2]
    image = _device_image(image_rgb, model)
    heat_avg = np.zeros((ori_h, ori_w, N_HAND), np.float64)
    for scale in [s * boxsize / ori_h for s in scale_search]:
        h, w = int(round(ori_h * scale)), int(round(ori_w * scale))
        heat = _network_maps(hand_forward, model, image, h, w, ori_h, ori_w)
        heat_avg += heat.cpu().numpy() / len(scale_search)
    return heat_avg


def hand_peaks(heat_avg: np.ndarray, thre: float = 0.05) -> np.ndarray:
    """[21, 2] (x, y) per hand part, (0, 0) for a miss: the argmax inside
    the blurred map's largest connected component above ``thre``."""
    from scipy.ndimage import label as cc_label

    peaks = np.zeros((N_HAND - 1, 2), np.float64)
    for part in range(N_HAND - 1):
        map_ori = heat_avg[:, :, part].copy()
        binary = gaussian_blur(map_ori, sigma=3.0) > thre
        if not binary.any():
            continue
        labels, n_labels = cc_label(binary)
        sums = [map_ori[labels == i].sum() for i in range(1, n_labels + 1)]
        best = int(np.argmax(sums)) + 1
        map_ori[labels != best] = 0
        y, x = np.unravel_index(np.argmax(map_ori), map_ori.shape)
        peaks[part] = (x, y)
    return peaks


def estimate_hand(model: HandPoseModel, image_rgb: np.ndarray, boxsize: int = 368,
                  scale_search: Sequence[float] = (0.5, 1.0, 1.5, 2.0),
                  thre: float = 0.05) -> np.ndarray:
    """Hand keypoints [21, 2] of one cropped hand image."""
    return hand_peaks(hand_maps(model, image_rgb, boxsize, scale_search), thre)


def hand_detect(candidate: np.ndarray, subset: np.ndarray, height: int, width: int):
    """Hand boxes from the body keypoints (pytorch-openpose util.handDetect):
    [(x, y, w, is_left), ...]."""
    ratio_wrist_elbow = 0.33
    results = []
    for person in subset.astype(int):
        hands = []
        if np.all(person[[5, 6, 7]] >= 0):  # left shoulder / elbow / wrist
            hands.append((*candidate[person[5]][:2], *candidate[person[6]][:2],
                          *candidate[person[7]][:2], True))
        if np.all(person[[2, 3, 4]] >= 0):  # right
            hands.append((*candidate[person[2]][:2], *candidate[person[3]][:2],
                          *candidate[person[4]][:2], False))
        for x1, y1, x2, y2, x3, y3, is_left in hands:
            x = x3 + ratio_wrist_elbow * (x3 - x2)
            y = y3 + ratio_wrist_elbow * (y3 - y2)
            d_we = math.hypot(x3 - x2, y3 - y2)
            d_es = math.hypot(x2 - x1, y2 - y1)
            w = 1.5 * max(d_we, 0.9 * d_es)
            x, y = x - w / 2, y - w / 2
            if x < 0:
                w += x; x = 0
            if y < 0:
                w += y; y = 0
            w = min(w, width - x, height - y)
            if w >= 20:
                results.append((int(x), int(y), int(w), is_left))
    return results


# controlnet_aux util.draw_handpose edges
_HAND_EDGES = [
    [0, 1], [1, 2], [2, 3], [3, 4], [0, 5], [5, 6], [6, 7], [7, 8], [0, 9],
    [9, 10], [10, 11], [11, 12], [0, 13], [13, 14], [14, 15], [15, 16],
    [0, 17], [17, 18], [18, 19], [19, 20],
]


def _hsv_to_rgb(h: float) -> Tuple[int, int, int]:
    i = int(h * 6.0) % 6
    f = h * 6.0 - int(h * 6.0)
    q, t = 1.0 - f, f
    rgb = [(1, t, 0), (q, 1, 0), (0, 1, t), (0, q, 1), (t, 0, 1), (1, 0, q)][i]
    return tuple(int(255 * c) for c in rgb)


def _draw_line(canvas, x0, y0, x1, y1, color, thickness=2):
    n = int(max(abs(x1 - x0), abs(y1 - y0))) + 1
    xs = np.linspace(x0, x1, n)
    ys = np.linspace(y0, y1, n)
    h, w = canvas.shape[:2]
    r = thickness // 2
    for x, y in zip(xs, ys):
        xi, yi = int(round(x)), int(round(y))
        canvas[max(yi - r, 0):min(yi + r + 1, h), max(xi - r, 0):min(xi + r + 1, w)] = color


def draw_handpose(canvas: np.ndarray, peaks: np.ndarray, x0: int, y0: int):
    """One hand's 21 keypoints onto ``canvas`` in place (hsv-colored bones,
    red joints)."""
    for ie, (a, b) in enumerate(_HAND_EDGES):
        pa, pb = peaks[a], peaks[b]
        if (pa == 0).all() or (pb == 0).all():
            continue
        color = _hsv_to_rgb(ie / len(_HAND_EDGES))
        _draw_line(canvas, pa[0] + x0, pa[1] + y0, pb[0] + x0, pb[1] + y0, color)
    for p in peaks:
        if (p == 0).all():
            continue
        _fill_ellipse(canvas, p[0] + x0, p[1] + y0, 4, 4, 0.0, (0, 0, 255))
    return canvas


def face_maps(model: FaceModel, image_rgb: np.ndarray, inference_size: int = 384) -> np.ndarray:
    """The face heatmaps [H, W, 71] of one crop on the host (controlnet_aux
    face.Face.__call__: one forward at a fixed size, resized back)."""
    ori_h, ori_w = image_rgb.shape[:2]
    image = _device_image(image_rgb, model)
    img = resize_cubic(image, inference_size, inference_size) / 256.0 - 0.5
    with torch.no_grad():
        heat = face_forward(model, img[None])[0]
    return resize_cubic(heat, ori_h, ori_w).cpu().numpy()


def face_peaks(heat: np.ndarray, thre: float = 0.05) -> np.ndarray:
    """[70, 2] (x, y) per landmark, (0, 0) where the map stays <= ``thre``."""
    peaks = np.zeros((N_FACE - 1, 2), np.float64)
    for part in range(N_FACE - 1):
        m = heat[:, :, part]
        if m.max() <= thre:
            continue
        y, x = np.unravel_index(np.argmax(m), m.shape)
        peaks[part] = (x, y)
    return peaks


def estimate_face(model: FaceModel, image_rgb: np.ndarray, inference_size: int = 384,
                  thre: float = 0.05) -> np.ndarray:
    """Face landmarks [70, 2] of one cropped face image."""
    return face_peaks(face_maps(model, image_rgb, inference_size), thre)


def face_detect(candidate: np.ndarray, subset: np.ndarray, height: int, width: int):
    """Face boxes from the body keypoints (controlnet_aux util.faceDetect):
    [(x, y, w), ...]."""
    results = []
    for person in subset.astype(int):
        if person[0] < 0:  # nose
            continue
        x0, y0 = candidate[person[0]][:2]
        w = 0.0
        for idx, factor in ((14, 3.0), (15, 3.0), (16, 1.5), (17, 1.5)):
            if person[idx] >= 0:
                x1, y1 = candidate[person[idx]][:2]
                w = max(w, math.hypot(x1 - x0, y1 - y0) * factor)
        if w < 20:
            continue
        x, y = x0 - w / 2, y0 - w / 2
        if x < 0:
            w += x; x = 0
        if y < 0:
            w += y; y = 0
        w = min(w, width - x, height - y)
        if w >= 20:
            results.append((int(x), int(y), int(w)))
    return results


def draw_facepose(canvas: np.ndarray, peaks: np.ndarray, x0: int, y0: int):
    """White 3 px landmark dots (controlnet_aux util.draw_facepose)."""
    for p in peaks:
        if (p == 0).all():
            continue
        _fill_ellipse(canvas, p[0] + x0, p[1] + y0, 3, 3, 0.0, (255, 255, 255))
    return canvas


def render_skeleton_full(body_model: BodyPoseModel, image_rgb: np.ndarray,
                         hand_model: Optional[HandPoseModel] = None,
                         face_model: Optional[FaceModel] = None, **kwargs) -> np.ndarray:
    """The openposefull image of one uint8 RGB frame: the body skeleton,
    with hand and face overlays when their models are given
    (OpenposeDetector(hand_and_face=...); the reference's configs run
    body only, video_skeletons.py:78)."""
    candidate, subset = estimate_body(body_model, image_rgb, **kwargs)
    h, w = image_rgb.shape[:2]
    canvas = draw_bodypose(candidate, subset, h, w).astype(np.float64)
    if hand_model is not None:
        for (x, y, bw, is_left) in hand_detect(candidate, subset, h, w):
            crop = image_rgb[y:y + bw, x:x + bw]
            if min(crop.shape[:2]) < 20:
                continue
            draw_handpose(canvas, estimate_hand(hand_model, crop), x, y)
    if face_model is not None:
        for (x, y, bw) in face_detect(candidate, subset, h, w):
            crop = image_rgb[y:y + bw, x:x + bw]
            if min(crop.shape[:2]) < 20:
                continue
            draw_facepose(canvas, estimate_face(face_model, crop), x, y)
    return canvas.clip(0, 255).astype(np.uint8)
