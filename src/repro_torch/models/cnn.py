"""The paper's benchmark DNNs on PyTorch: ResNet18/50, UNet, InceptionV3.

Counterpart of src/repro/models/cnn.py. Each model exposes ``stages``, the
paper's four logical stage boundaries (ResNet: its four residual stages,
§III-B1), as separate callables ``stage(params, x) -> x``: what DARIS
schedules. The parameter tree keeps the reference's keys (``stem``,
``stage{i}``, ``c1``/``c2``/``proj``, ``bn.scale``/``bn.bias``, ``down{i}``,
``mid``, ``up{i}``, ``out``, ``a{i}``, ``red``, ``b{i}``, ``head``).

Layouts are cuDNN's: activations NCHW, conv weights OIHW, both in the
``channels_last`` memory format. Stage 0 takes the realtime backend's NHWC
input (``runtime/backend.py`` ``_default_input_factory``) and views it as
NCHW, which on a contiguous NHWC tensor is a ``channels_last`` view, not a
copy. Between stages activations are NCHW (UNet's state is ``(x, skips)``);
the last stage returns what the reference does: ``(B, n_classes)`` logits,
or UNet's 2-channel map as NHWC.

Where XLA's semantics differ from PyTorch's defaults, the port follows XLA:

- ``"SAME"`` padding puts ``total // 2`` before and the rest after, so a
  stride-2 window pads more at the end (the 7x7 stride-2 stem at 224 pads 2
  and 3); convolutions pad with zeros, max pools with ``-inf``.
- ``bn_apply`` normalises with the batch's own mean and biased variance
  over (N, H, W), not with running statistics.
- UNet's nearest resize has half-pixel centres (``"nearest-exact"``).
- Inception's pool sums a zero-padded 3x3 window and divides by 9.

The builders draw the reference's distributions (truncated normal over ±2
over sqrt(fan-in)) from a seeded ``torch.Generator``, not JAX's numbers:
``cnn_params_from_jax`` carries the reference's own parameters across.

The reference computes in f32. A builder given a CUDA device therefore
turns cuDNN's TF32 off for the process (``torch.backends.cudnn.allow_tf32
= False``; torch's default lets cuDNN round convolution inputs to TF32),
so every entry point serves what ``stage_errors`` holds to the CPU.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List

import torch
import torch.nn.functional as F

from ..device import DeviceLike, resolve_device
from .api import params_from_jax
from .layers import dense_init


def _conv_layout(w: torch.Tensor) -> torch.Tensor:
    # cuDNN converts an OIHW-contiguous weight on every call when the
    # activations are channels_last; stored channels_last, it takes it as is
    return w.contiguous(memory_format=torch.channels_last)


def conv_init(gen: torch.Generator, kh: int, kw: int, cin: int, cout: int,
              device: torch.device) -> torch.Tensor:
    return _conv_layout(dense_init(gen, (cout, cin, kh, kw), torch.float32,
                                   fan_in=kh * kw * cin, device=device))


def _same_pads(size: int, k: int, stride: int):
    """XLA's ``"SAME"`` padding of one spatial axis: (before, after)."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def _pads(x: torch.Tensor, kh: int, kw: int, stride: int):
    (ht, hb), (wl, wr) = (_same_pads(x.shape[2], kh, stride),
                          _same_pads(x.shape[3], kw, stride))
    return wl, wr, ht, hb


def conv(x: torch.Tensor, w: torch.Tensor, stride: int = 1) -> torch.Tensor:
    wl, wr, ht, hb = _pads(x, w.shape[2], w.shape[3], stride)
    if wl == wr and ht == hb:
        return F.conv2d(x, w, stride=stride, padding=(ht, wl))
    return F.conv2d(F.pad(x, (wl, wr, ht, hb)), w, stride=stride)


def max_pool(x: torch.Tensor, k: int, stride: int) -> torch.Tensor:
    """``reduce_window(max)`` with ``"SAME"`` padding of ``-inf``."""
    pads = _pads(x, k, k, stride)
    if any(pads):
        x = F.pad(x, pads, value=-float("inf"))
    return F.max_pool2d(x, k, stride)


def bn_apply(p: dict, x: torch.Tensor) -> torch.Tensor:
    """The reference's norm: the batch's mean and biased variance over
    (N, H, W), eps 1e-5, then scale and bias (f32)."""
    n, _, h, w = x.shape
    if n * h * w > 1:
        return F.batch_norm(x, None, None, p["scale"], p["bias"],
                            training=True, eps=1e-5)
    # one value a channel, which F.batch_norm refuses: the variance is 0
    # and the centred value 0, so this gives ``bias`` as the reference does
    mu = x.mean(dim=(0, 2, 3), keepdim=True)
    var = x.var(dim=(0, 2, 3), unbiased=False, keepdim=True)
    y = (x - mu) * torch.rsqrt(var + 1e-5)
    return y * p["scale"].view(1, -1, 1, 1) + p["bias"].view(1, -1, 1, 1)


def bn_init(c: int, device: torch.device) -> dict:
    return {"scale": torch.ones((c,), dtype=torch.float32, device=device),
            "bias": torch.zeros((c,), dtype=torch.float32, device=device)}


def _convbn(gen, kh, kw, cin, cout, device):
    return {"w": conv_init(gen, kh, kw, cin, cout, device),
            "bn": bn_init(cout, device)}


def _convbn_apply(p, x, stride=1, act=True):
    y = bn_apply(p["bn"], conv(x, p["w"], stride))
    return F.relu(y) if act else y


def _nchw(x: torch.Tensor) -> torch.Tensor:
    """The backend's NHWC input as NCHW (a view: channels_last)."""
    return x.permute(0, 3, 1, 2)


def _head(p, x):
    return x.mean(dim=(2, 3)) @ p["head"]


# ---------------------------------------------------------------- ResNet
def _basic_block(gen, cin, cout, stride, device):
    p = {"c1": _convbn(gen, 3, 3, cin, cout, device),
         "c2": _convbn(gen, 3, 3, cout, cout, device)}
    if stride != 1 or cin != cout:
        p["proj"] = _convbn(gen, 1, 1, cin, cout, device)
    return p


def _basic_apply(p, x, stride):
    y = _convbn_apply(p["c1"], x, stride)
    y = _convbn_apply(p["c2"], y, act=False)
    sc = _convbn_apply(p["proj"], x, stride, act=False) if "proj" in p else x
    return F.relu(y + sc)


def _bottleneck_block(gen, cin, cmid, stride, device):
    cout = cmid * 4
    p = {"c1": _convbn(gen, 1, 1, cin, cmid, device),
         "c2": _convbn(gen, 3, 3, cmid, cmid, device),
         "c3": _convbn(gen, 1, 1, cmid, cout, device)}
    if stride != 1 or cin != cout:
        p["proj"] = _convbn(gen, 1, 1, cin, cout, device)
    return p


def _bottleneck_apply(p, x, stride):
    y = _convbn_apply(p["c1"], x)
    y = _convbn_apply(p["c2"], y, stride)
    y = _convbn_apply(p["c3"], y, act=False)
    sc = _convbn_apply(p["proj"], x, stride, act=False) if "proj" in p else x
    return F.relu(y + sc)


@dataclasses.dataclass
class StagedCNN:
    name: str
    params: dict
    stages: List[Callable]            # stage_fn(params, x) -> x
    device: torch.device
    input_hw: int = 64
    n_classes: int = 100

    def forward(self, params, x):
        for st in self.stages:
            x = st(params, x)
        return x


def _model_device(device: DeviceLike) -> torch.device:
    """``resolve_device``; on the card it also keeps cuDNN's convolutions
    in f32 (with TF32, width-8 copies on an H100 differ from the CPU by
    1.5e-3-4.9e-3 of the output's scale, past ``stage_errors``' 1e-3)."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.backends.cudnn.allow_tf32 = False
    return dev


def _generator(seed: int, device: torch.device) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return gen


def build_resnet(depth: int = 18, *, seed: int = 0, n_classes: int = 100,
                 width: int = 32, device: DeviceLike = None) -> StagedCNN:
    dev = _model_device(device)
    gen = _generator(seed, dev)
    basic = depth == 18
    blocks_per = {18: (2, 2, 2, 2), 50: (3, 4, 6, 3)}[depth]
    widths = (width, width * 2, width * 4, width * 8)
    params = {"stem": _convbn(gen, 7, 7, 3, width, dev)}
    cin = width
    for si, (n, w) in enumerate(zip(blocks_per, widths)):
        blocks = []
        for bi in range(n):
            stride = 2 if (bi == 0 and si > 0) else 1
            if basic:
                blocks.append(_basic_block(gen, cin, w, stride, dev))
                cin = w
            else:
                blocks.append(_bottleneck_block(gen, cin, w, stride, dev))
                cin = w * 4
        params[f"stage{si}"] = blocks
    params["head"] = dense_init(gen, (cin, n_classes), torch.float32,
                                fan_in=cin, device=dev)

    def make_stage(si):
        def fn(p, x):
            if si == 0:
                x = _convbn_apply(p["stem"], _nchw(x), 2)
                x = max_pool(x, 3, 2)
            for bi, bp in enumerate(p[f"stage{si}"]):
                stride = 2 if (bi == 0 and si > 0) else 1
                x = (_basic_apply(bp, x, stride) if basic
                     else _bottleneck_apply(bp, x, stride))
            if si == 3:
                x = _head(p, x)
            return x
        return fn

    return StagedCNN(name=f"resnet{depth}", params=params,
                     stages=[make_stage(i) for i in range(4)], device=dev,
                     n_classes=n_classes)


# ---------------------------------------------------------------- UNet
def build_unet(*, seed: int = 0, width: int = 24,
               device: DeviceLike = None) -> StagedCNN:
    dev = _model_device(device)
    gen = _generator(seed, dev)
    ws = (width, width * 2, width * 4, width * 8)
    params = {}
    cin = 3
    for i, w in enumerate(ws):
        params[f"down{i}"] = {"c1": _convbn(gen, 3, 3, cin, w, dev),
                              "c2": _convbn(gen, 3, 3, w, w, dev)}
        cin = w
    params["mid"] = {"c1": _convbn(gen, 3, 3, cin, cin * 2, dev),
                     "c2": _convbn(gen, 3, 3, cin * 2, cin, dev)}
    for i, w in reversed(list(enumerate(ws))):
        cin_up = ws[min(i + 1, len(ws) - 1)] + w   # upsampled x + skip
        params[f"up{i}"] = {"c1": _convbn(gen, 3, 3, cin_up, w, dev),
                            "c2": _convbn(gen, 3, 3, w, w, dev)}
    params["out"] = conv_init(gen, 1, 1, ws[0], 2, dev)

    def down_path(p, x, rng):
        skips = x[1] if isinstance(x, tuple) else []
        x = x[0] if isinstance(x, tuple) else _nchw(x)
        for i in range(*rng):
            blk = p[f"down{i}"]
            x = _convbn_apply(blk["c2"], _convbn_apply(blk["c1"], x))
            skips = skips + [x]
            x = max_pool(x, 2, 2)
        return (x, skips)

    def stage0(p, x):
        return down_path(p, x, (0, 2))

    def stage1(p, x):
        x, skips = down_path(p, x, (2, 4))
        blk = p["mid"]
        x = _convbn_apply(blk["c2"], _convbn_apply(blk["c1"], x))
        return (x, skips)

    def up_path(p, state, rng):
        x, skips = state
        for i in rng:
            sk = skips[i]
            x = F.interpolate(x, size=sk.shape[2:], mode="nearest-exact")
            x = torch.cat([x, sk], dim=1)
            blk = p[f"up{i}"]
            x = _convbn_apply(blk["c2"], _convbn_apply(blk["c1"], x))
        return (x, skips)

    def stage2(p, state):
        return up_path(p, state, (3, 2))

    def stage3(p, state):
        x, _ = up_path(p, state, (1, 0))
        return conv(x, p["out"]).permute(0, 2, 3, 1)     # NHWC, as XLA's

    return StagedCNN(name="unet", params=params,
                     stages=[stage0, stage1, stage2, stage3], device=dev)


# ------------------------------------------------------------ InceptionV3
def _inception_a(gen, cin, w, device):
    return {
        "b1": _convbn(gen, 1, 1, cin, w, device),
        "b2a": _convbn(gen, 1, 1, cin, w, device),
        "b2b": _convbn(gen, 5, 5, w, w, device),
        "b3a": _convbn(gen, 1, 1, cin, w, device),
        "b3b": _convbn(gen, 3, 3, w, w, device),
        "b3c": _convbn(gen, 3, 3, w, w, device),
        "bp": _convbn(gen, 1, 1, cin, w, device),
    }


def _inception_a_apply(p, x):
    b1 = _convbn_apply(p["b1"], x)
    b2 = _convbn_apply(p["b2b"], _convbn_apply(p["b2a"], x))
    b3 = _convbn_apply(p["b3c"], _convbn_apply(p["b3b"],
                                               _convbn_apply(p["b3a"], x)))
    pool = F.avg_pool2d(x, 3, 1, padding=1, count_include_pad=True)
    bp = _convbn_apply(p["bp"], pool)
    return torch.cat([b1, b2, b3, bp], dim=1)


def build_inception(*, seed: int = 0, width: int = 24, n_classes: int = 100,
                    device: DeviceLike = None) -> StagedCNN:
    dev = _model_device(device)
    gen = _generator(seed, dev)
    params = {
        "stem1": _convbn(gen, 3, 3, 3, width, dev),
        "stem2": _convbn(gen, 3, 3, width, width * 2, dev),
    }
    cin = width * 2
    for i in range(3):
        params[f"a{i}"] = _inception_a(gen, cin, width, dev)
        cin = width * 4
    params["red"] = _convbn(gen, 3, 3, cin, cin, dev)
    for i in range(2):
        params[f"b{i}"] = _inception_a(gen, cin, width * 2, dev)
        cin = width * 8
    params["head"] = dense_init(gen, (cin, n_classes), torch.float32,
                                fan_in=cin, device=dev)

    def stage0(p, x):
        x = _convbn_apply(p["stem1"], _nchw(x), 2)
        x = _convbn_apply(p["stem2"], x, 1)
        return _inception_a_apply(p["a0"], x)

    def stage1(p, x):
        x = _inception_a_apply(p["a1"], x)
        return _inception_a_apply(p["a2"], x)

    def stage2(p, x):
        x = _convbn_apply(p["red"], x, 2)
        return _inception_a_apply(p["b0"], x)

    def stage3(p, x):
        x = _inception_a_apply(p["b1"], x)
        return _head(p, x)

    return StagedCNN(name="inceptionv3", params=params,
                     stages=[stage0, stage1, stage2, stage3], device=dev,
                     n_classes=n_classes)


BUILDERS = {
    "resnet18": lambda **kw: build_resnet(18, **kw),
    "resnet50": lambda **kw: build_resnet(50, **kw),
    "unet": build_unet,
    "inceptionv3": build_inception,
}


def cnn_params_from_jax(tree, *, device: DeviceLike = None):
    """A CNN parameter tree exported from the JAX package
    (``jax.device_get(model.params)``) as the port's: conv weights (the
    only 4-D leaves) from HWIO to OIHW in the ``channels_last`` memory
    format, every other leaf as ``params_from_jax`` carries it."""
    dev = resolve_device(device)
    if isinstance(tree, dict):
        return {k: cnn_params_from_jax(v, device=dev) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(cnn_params_from_jax(v, device=dev) for v in tree)
    leaf = params_from_jax(tree, device=dev)
    return _conv_layout(leaf.permute(3, 2, 0, 1)) if leaf.dim() == 4 else leaf


def _to(tree, device: torch.device):
    # blocking copies, unlike ``serving.staging.migrate``: the host reads
    # the results at once
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to(v, device) for v in tree)
    return tree.to(device)


def _leaves(state) -> List[torch.Tensor]:
    return [state[0], *state[1]] if isinstance(state, tuple) else [state]


def stage_errors(model: StagedCNN, x: torch.Tensor,
                 ref_device: DeviceLike = "cpu") -> List[float]:
    """Each stage of ``model`` on its own device against the same stage
    function and parameters on ``ref_device``, both chains fed the NHWC
    input ``x``: per stage, the largest absolute difference over its
    outputs (UNet's ``(x, skips)`` whole) over ``max(1, max |reference|)``,
    or ``inf`` where a shape differs. The port holds the card to the CPU
    within 1e-3 (cuDNN's algorithms sum in other orders)."""
    ref = torch.device(ref_device)
    ref_params = _to(model.params, ref)
    a, b = x.to(model.device), x.to(ref)
    errs = []
    for stage in model.stages:
        a, b = stage(model.params, a), stage(ref_params, b)
        errs.append(max(
            float((u.to(ref) - v).abs().max()) / max(1.0, float(v.abs().max()))
            if u.shape == v.shape else float("inf")
            for u, v in zip(_leaves(a), _leaves(b))))
    return errs
