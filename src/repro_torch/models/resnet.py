"""The paper's CIFAR-10 experiment model: a 32-layer residual network
(He et al. 2016) with batch normalization REMOVED (paper Fig. 2 right):
BN breaks the i.i.d.-likelihood reading that posterior sampling needs, so
the paper drops it, and so does the port.

ResNet-32 = 3 stages x 5 basic blocks x 2 convs + stem + head.  The
weights keep the reference's HWIO layout, so they cross to and from the
reference and its checkpoints unchanged; each convolution runs
``F.conv2d`` (cuDNN on the card) on an OIHW view of them, with the
activations in NCHW.  Padding is XLA's ``SAME``: at stride 2 on an even
input a 3x3 convolution pads 0 before and 1 after, which ``F.conv2d``'s
symmetric ``padding=`` cannot express, so such inputs are padded
explicitly.
"""
from __future__ import annotations

import torch.nn.functional as F

from .common import ParamSpec
from .mlp import class_nll


def _conv_spec(cin, cout, k=3):
    return ParamSpec((k, k, cin, cout), (None, None, None, "mlp"), scale=0.05)


def param_specs(width: int = 16, num_classes: int = 10):
    w = width
    specs = {"stem": _conv_spec(3, w)}
    for stage in range(3):
        cin = w if stage == 0 else w * 2 ** (stage - 1)
        cout = w * 2**stage
        for blk in range(5):
            bin_ = cin if blk == 0 else cout
            specs[f"s{stage}b{blk}c1"] = _conv_spec(bin_, cout)
            specs[f"s{stage}b{blk}c2"] = _conv_spec(cout, cout)
            if bin_ != cout:
                specs[f"s{stage}b{blk}proj"] = _conv_spec(bin_, cout, k=1)
    specs["head_w"] = ParamSpec((w * 4, num_classes), ("mlp", None))
    specs["head_b"] = ParamSpec((num_classes,), (None,), init="zeros")
    return specs


def same_padding(size: int, k: int, stride: int) -> tuple[int, int]:
    """XLA's SAME padding of one spatial axis: (before, after), the total
    making the output ceil(size / stride), the odd element after."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def conv(x, w, stride=1):
    """SAME convolution of NCHW activations with an HWIO weight."""
    k = w.shape[0]
    (top, bottom), (left, right) = (same_padding(x.shape[2], k, stride),
                                    same_padding(x.shape[3], k, stride))
    pad = 0
    if (top, left) == (bottom, right):
        pad = (top, left)
    else:
        x = F.pad(x, (left, right, top, bottom))
    return F.conv2d(x, w.permute(3, 2, 0, 1), stride=stride, padding=pad)


def apply(params, x):
    """x: (B, 32, 32, 3) NHWC -> logits (B, 10)."""
    # NCHW-contiguous activations: torch's CPU convolution crashes in the
    # backward of a 1x1 stride-2 convolution of a channels-last input
    h = conv(x.permute(0, 3, 1, 2).contiguous(), params["stem"])
    for stage in range(3):
        for blk in range(5):
            stride = 2 if (stage > 0 and blk == 0) else 1
            r = h
            h1 = conv(F.relu(h), params[f"s{stage}b{blk}c1"], stride)
            h2 = conv(F.relu(h1), params[f"s{stage}b{blk}c2"])
            if f"s{stage}b{blk}proj" in params:
                r = conv(r, params[f"s{stage}b{blk}proj"], stride)
            h = r + h2
    h = F.relu(h).mean(dim=(2, 3))
    return h @ params["head_w"] + params["head_b"]


def nll_fn(params, batch):
    """(sum_nll, batch_size) for the classification posterior."""
    return class_nll(apply(params, batch["x"]), batch["y"])
