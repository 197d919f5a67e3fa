"""Convolutional networks — the paper's own benchmark models.

AlexNet and VGG16 (Table 1), and the parametric "toy" CNNs of Figures 1–3
(first-layer channels c0, channel rate r, kernel size K, ReLU after each
conv, max-pool every 2 convs).  No batch normalization — the paper
excludes it because it mixes examples (per-example gradients become
ill-defined); dropout is likewise omitted.

Params and layer names are the JAX package's, leaf for leaf.  Max
pooling is ``F.max_pool2d(k, s)``, which equals ``reduce_window`` with
``VALID`` padding.

On a model axis every conv and fc whose out-channels the axis divides
arrives as this rank's slice of them (column-sharded, ``"mlp"``): it
takes the full input and gives its slice of the channels, which is
all-gathered before the next layer (whose backward reduce-scatters a
column-sharded consumer's cotangent); a head the axis does not divide
stays replicated, and a sliced head's loss is the vocabulary-parallel
cross entropy.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.core.tapper import Tapper
from repro_torch.device import resolve_device
from repro_torch.launch import sharding as sh
from repro_torch.models import common as cm

ALEXNET = [  # (out_ch, kernel, stride, pad, pool_after)
    (64, 11, 4, 2, True), (192, 5, 1, 2, True), (384, 3, 1, 1, False),
    (256, 3, 1, 1, False), (256, 3, 1, 1, True)]
VGG16 = [(64, 3, 1, 1, False), (64, 3, 1, 1, True),
         (128, 3, 1, 1, False), (128, 3, 1, 1, True),
         (256, 3, 1, 1, False), (256, 3, 1, 1, False), (256, 3, 1, 1, True),
         (512, 3, 1, 1, False), (512, 3, 1, 1, False), (512, 3, 1, 1, True),
         (512, 3, 1, 1, False), (512, 3, 1, 1, False), (512, 3, 1, 1, True)]


def _conv_plan(cfg: ModelConfig):
    if cfg.cnn_arch == "alexnet":
        plan, pool_k, pool_s = ALEXNET, 3, 2
        fcs = (4096, 4096)
    elif cfg.cnn_arch == "vgg16":
        plan, pool_k, pool_s = VGG16, 2, 2
        fcs = (4096, 4096)
    else:  # toy
        plan = []
        for i, ch in enumerate(cfg.cnn_channels):
            pool = (i % 2 == 1)
            plan.append((ch, cfg.cnn_kernel, 1, 0, pool))
        pool_k, pool_s = 2, 2
        fcs = ()
    return plan, pool_k, pool_s, fcs


def _spatial_after(cfg, plan, pool_k, pool_s):
    h = cfg.img_size
    for (ch, k, s, p, pool) in plan:
        h = (h + 2 * p - k) // s + 1
        if pool:
            h = (h - pool_k) // pool_s + 1
    return h


class CNN:
    def __init__(self, cfg: ModelConfig):
        self.cfg = cfg
        self.plan, self.pool_k, self.pool_s, self.fcs = _conv_plan(cfg)

    def init(self, key: int | torch.Generator = 0, *, device="cuda"):
        """-> (params, logical axes).  ``key`` seeds a CPU generator (or is
        one), so a seed gives the same weights on every device."""
        dev = resolve_device(device)
        gen = key if isinstance(key, torch.Generator) \
            else torch.Generator().manual_seed(int(key))
        cfg = self.cfg
        dt = cfg.torch_dtype
        tree = {}
        cin = 3
        for i, (ch, k, s, p, pool) in enumerate(self.plan):
            tree[f"conv{i}"] = {
                "w": cm.mk(gen, (ch, cin, k, k),
                           ("mlp", None, None, "conv_k"),
                           scale=(cin * k * k) ** -0.5, dtype=dt, device=dev),
                "b": cm.mk(gen, (ch,), ("mlp",), dist="zeros", dtype=dt,
                           device=dev)}
            cin = ch
        side = _spatial_after(cfg, self.plan, self.pool_k, self.pool_s)
        feat = cin * side * side
        dims = (feat,) + self.fcs + (cfg.n_classes,)
        for j in range(len(dims) - 1):
            tree[f"fc{j}"] = {
                "w": cm.mk(gen, (dims[j], dims[j + 1]), ("embed", "mlp"),
                           scale=dims[j] ** -0.5, dtype=dt, device=dev),
                "b": cm.mk(gen, (dims[j + 1],), ("mlp",), dist="zeros",
                           dtype=dt, device=dev)}
        return cm.split_tree(tree)

    def features(self, params, img, tp: Tapper, cut_fc0: bool = False):
        """Conv trunk -> (B, features); ``cut_fc0``: the consumer (fc0)
        is column-sharded."""
        h, cut = img, False
        for i, (ch, k, s, p, pool) in enumerate(self.plan):
            w = params[f"conv{i}"]["w"]
            out_cut = sh.split(w.shape[0], ch)
            h = tp.conv(f"conv{i}", _enter(h, cut, 1, out_cut), w,
                        params[f"conv{i}"]["b"], stride=s, padding=p)
            cut = out_cut
            h = F.relu(h)
            if pool:
                h = F.max_pool2d(h, self.pool_k, self.pool_s)
        return _enter(h, cut, 1, cut_fc0).reshape(h.shape[0], -1)

    def apply(self, params, batch, tp: Tapper):
        n_fc = len(self.fcs) + 1
        widths = self.fcs + (self.cfg.n_classes,)
        cuts = [sh.split(params[f"fc{j}"]["w"].shape[1], widths[j])
                for j in range(n_fc)]
        h = self.features(params, batch["img"].to(self.cfg.torch_dtype), tp,
                          cut_fc0=cuts[0])
        for j in range(n_fc):
            if j:
                h = _enter(h, cuts[j - 1], -1, cuts[j])
            h = tp.dense(f"fc{j}", h, params[f"fc{j}"]["w"],
                         params[f"fc{j}"]["b"])
            if j < n_fc - 1:
                h = F.relu(h)
        return cm.per_example_xent_cls(h, batch["label"],
                                       n_classes=self.cfg.n_classes)


def _enter(h, cut: bool, dim: int, sharded: bool):
    """``h`` (this rank's slice along ``dim`` when ``cut``) as the full
    input of the next layer (``sharded``: a column-sharded one, whose
    input cotangent is partial on each rank)."""
    if cut:
        return sh.gather_from_model(h, dim, sharded_consumer=sharded)
    return sh.copy_to_model(h) if sharded else h


def toy_cnn_config(n_layers: int, channel_rate: float, *, c0: int = 25,
                   kernel: int = 3, img: int = 256,
                   n_classes: int = 10) -> ModelConfig:
    """The paper's Fig-1/2/3 toy CNNs."""
    chans = tuple(int(round(c0 * channel_rate ** i)) for i in range(n_layers))
    return ModelConfig(
        name=f"toy{n_layers}_r{channel_rate}", family="cnn", n_layers=n_layers,
        d_model=0, n_heads=0, n_kv=0, d_ff=0, vocab=0, cnn_arch="toy",
        cnn_channels=chans, cnn_kernel=kernel, img_size=img,
        n_classes=n_classes)
