"""ResNet-18 (port of ``repro.models.resnet``) -- the paper's
image-classification application (§4.2, Table 3).

Same parameter tree as the reference: conv weights stay HWIO, GroupNorm
(``min(8, c)`` groups) in place of BatchNorm, ``stages`` a list of lists of
blocks.  Images arrive NHWC; they are permuted to NCHW once, which leaves
them channels-last in memory, cuDNN's natural layout.  Convolutions pad as
XLA's ``SAME`` does: at stride 2 on an even input a 3x3 conv pads 0 before
and 1 after, which ``F.conv2d(padding=1)`` does not, so the padding is
explicit.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from .common import Spec, init_params, param_axes, param_shapes

STAGES = (2, 2, 2, 2)                      # ResNet-18 basic blocks
WIDTHS = (64, 128, 256, 512)


def _conv_spec(cin, cout, k):
    return Spec((k, k, cin, cout), (None, None, None, "mlp"),
                scale=math.sqrt(2.0))


def _gn_spec(c):
    return {"scale": Spec((c,), ("mlp",), init="ones"),
            "bias": Spec((c,), ("mlp",), init="zeros")}


def resnet18_specs(num_classes: int = 200, in_ch: int = 3):
    stages, cin = [], 64
    for si, (n, w) in enumerate(zip(STAGES, WIDTHS)):
        blocks = []
        for bi in range(n):
            stride = 2 if (bi == 0 and si > 0) else 1
            block = {
                "conv1": _conv_spec(cin, w, 3), "gn1": _gn_spec(w),
                "conv2": _conv_spec(w, w, 3), "gn2": _gn_spec(w),
            }
            if stride != 1 or cin != w:
                block["proj"] = _conv_spec(cin, w, 1)
            blocks.append(block)
            cin = w
        stages.append(blocks)
    return {
        "stem": {"conv": _conv_spec(in_ch, 64, 3), "gn": _gn_spec(64)},
        "stages": stages,
        "fc": {"w": Spec((WIDTHS[-1], num_classes), (None, "mlp")),
               "b": Spec((num_classes,), ("mlp",), init="zeros")},
    }


def _same_pad(size: int, k: int, stride: int) -> tuple[int, int]:
    """XLA's ``SAME`` padding (before, after) of one spatial dim."""
    total = max((-(-size // stride) - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def _conv(x, w, stride: int = 1):
    """x NCHW, w HWIO: a ``SAME`` convolution."""
    k = w.shape[0]
    (top, bottom), (left, right) = (_same_pad(x.shape[2], k, stride),
                                    _same_pad(x.shape[3], k, stride))
    if (top, left) == (bottom, right):
        return F.conv2d(x, w.permute(3, 2, 0, 1), stride=stride,
                        padding=top)
    return F.conv2d(F.pad(x, (left, right, top, bottom)),
                    w.permute(3, 2, 0, 1), stride=stride)


def _gn(x, p, groups: int = 8):
    """GroupNorm over NCHW: fp32 statistics, biased variance, eps 1e-5."""
    g = min(groups, x.shape[1])
    y = F.group_norm(x.float(), g, eps=1e-5).to(x.dtype)
    return (y * p["scale"].to(x.dtype)[:, None, None]
            + p["bias"].to(x.dtype)[:, None, None])


def resnet18_apply(params, images):
    """images: (B, H, W, 3) -> logits (B, num_classes)."""
    x = images.permute(0, 3, 1, 2)
    x = F.relu(_gn(_conv(x, params["stem"]["conv"].to(x.dtype)),
                   params["stem"]["gn"]))
    for si, blocks in enumerate(params["stages"]):
        for bi, bp in enumerate(blocks):
            stride = 2 if (bi == 0 and si > 0) else 1
            r = x
            y = F.relu(_gn(_conv(x, bp["conv1"].to(x.dtype), stride),
                           bp["gn1"]))
            y = _gn(_conv(y, bp["conv2"].to(x.dtype)), bp["gn2"])
            if "proj" in bp:
                r = _conv(x, bp["proj"].to(x.dtype), stride)
            x = F.relu(y + r)
    x = x.mean(dim=(2, 3))                                  # global avg pool
    return x @ params["fc"]["w"].to(x.dtype) + params["fc"]["b"].to(x.dtype)


def resnet18_loss(params, batch):
    logits = resnet18_apply(params, batch["images"]).float()
    labels = batch["labels"].long()
    logp = torch.log_softmax(logits, dim=-1)
    nll = -logp.gather(-1, labels[:, None]).mean()
    acc = (logits.argmax(-1) == labels).float().mean()
    return nll, {"acc": acc}


class ResNet18:
    def __init__(self, num_classes: int = 200):
        self.num_classes = num_classes

    def specs(self):
        return resnet18_specs(self.num_classes)

    def init(self, seed: int = 0, device="cuda",
             dtype: Optional[torch.dtype] = None):
        gen = torch.Generator(device=device).manual_seed(seed)
        return init_params(self.specs(), gen, device=device, dtype=dtype)

    def shapes(self, device="cuda", dtype: Optional[torch.dtype] = None):
        return param_shapes(self.specs(), device=device, dtype=dtype)

    def axes(self):
        return param_axes(self.specs())

    def loss_fn(self, params, batch):
        return resnet18_loss(params, batch)
