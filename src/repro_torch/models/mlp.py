"""The paper's MNIST experiment model: a 2-layer fully-connected network,
800 units per layer, ReLU activations (Fig. 2 left).  The GEMMs are
cuBLAS's on the card: the reference computes them outside any Pallas
kernel."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .common import ParamSpec


def param_specs(in_dim: int = 784, hidden: int = 800, out_dim: int = 10):
    return {
        "w1": ParamSpec((in_dim, hidden), ("embed", "mlp")),
        "b1": ParamSpec((hidden,), ("mlp",), init="zeros"),
        "w2": ParamSpec((hidden, hidden), ("mlp", "mlp2")),
        "b2": ParamSpec((hidden,), ("mlp2",), init="zeros"),
        "w3": ParamSpec((hidden, out_dim), ("mlp2", None)),
        "b3": ParamSpec((out_dim,), (None,), init="zeros"),
    }


def apply(params, x):
    """x: (B, in_dim) -> logits (B, out_dim)."""
    h = F.relu(x @ params["w1"] + params["b1"])
    h = F.relu(h @ params["w2"] + params["b2"])
    return h @ params["w3"] + params["b3"]


def class_nll(logits, y):
    """(sum over the batch of -log softmax(logits)[y], batch size), the
    log-softmax in f32.  The batch size is a host int, so that
    ``core.make_potential`` scales by it without a copy to the card."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    gold = torch.gather(logp, -1, y.long()[:, None])[:, 0]
    return -torch.sum(gold), int(y.shape[0])


def nll_fn(params, batch):
    """(sum_nll, batch_size) for the classification posterior (Eq. 7/8)."""
    return class_nll(apply(params, batch["x"]), batch["y"])
