"""ResNet-50 — the ImageNet amp and DDP + SyncBatchNorm model
(``BASELINE.md`` rows 1 and 2); counterpart of
``apex_tpu/models/resnet.py``.

The input is NHWC ``(N, H, W, 3)``, as the reference's.  Inside, the
activations are PyTorch's NCHW with channels-last strides (the
reference's NHWC in memory; cuDNN's fast layout for bf16), and the
convolutions and batch norms are PyTorch's own (``F.conv2d``, cuDNN):
the reference runs them outside Pallas too.

Three details of the reference are kept:

- **Flax's "SAME" padding.** A strided 3×3 convolution pads
  ``total = max((ceil(n/s) - 1)·s + k - n, 0)`` split low ``total // 2``
  and high the rest: at stride 2 on an even size that is (0, 1), not
  PyTorch's symmetric (1, 1), which gives the same shape and other
  values.  The stem (explicit (3, 3)) and the max pool (explicit (1,
  1), -inf fill) are symmetric.
- **Two norm branches with different running statistics.** The default
  is :class:`BatchNorm`, flax's ``nn.BatchNorm`` arithmetic: the biased
  batch variance as E[x²] − E[x]² (clipped at 0), ``running = 0.9 ·
  running + 0.1 · batch``.  ``use_syncbn`` takes the port's
  :class:`~apex_tpu_torch.parallel.SyncBatchNorm` (statistics over the
  dp group; PyTorch's momentum convention with momentum ``1 -
  bn_momentum``, the unbiased variance).  Statistics are f32 in both;
  the output is in ``cfg.dtype``.
- **bn3's scale starts at zero**, so each residual branch starts as the
  identity; the classifier head is f32 over the mean of H and W.

In training, ``forward`` returns ``(logits, batch_stats)``: the running
statistics after this batch, keyed like :meth:`ResNet.batch_stats`,
computed without touching the buffers (the reference's
``mutable=["batch_stats"]``); :meth:`ResNet.load_batch_stats` commits
them once the step is taken.  :func:`from_jax_variables` and
:func:`to_jax_variables` carry a JAX model's ``params`` and
``batch_stats`` across (HWIO kernels to OIHW, the head's (in, out) to
``Linear``'s (out, in)).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from apex_tpu_torch.models.convert import _host_f32
from apex_tpu_torch.ops._dispatch import resolve_device
from apex_tpu_torch.parallel.sync_batchnorm import SyncBatchNorm

__all__ = ["ResNetConfig", "ResNet", "BatchNorm", "resnet50",
           "resnet50_config", "same_pads", "forward_flops",
           "from_jax_variables", "load_jax_variables", "to_jax_variables"]

Stats = Dict[str, Tuple[torch.Tensor, torch.Tensor]]


@dataclasses.dataclass(frozen=True)
class ResNetConfig:
    stage_sizes: Sequence[int] = (3, 4, 6, 3)  # ResNet-50
    num_classes: int = 1000
    width: int = 64
    dtype: torch.dtype = torch.bfloat16
    use_syncbn: bool = False  # dp-wide batch statistics (BASELINE row 2)
    bn_momentum: float = 0.9
    bn_eps: float = 1e-5


def resnet50_config(**overrides) -> ResNetConfig:
    return ResNetConfig(**overrides)


def same_pads(n: int, k: int, s: int) -> Tuple[int, int]:
    """Flax's (and XLA's) "SAME" padding of one axis of size ``n`` for
    a kernel ``k`` at stride ``s``: (low, high)."""
    total = max((-(-n // s) - 1) * s + k - n, 0)
    return total // 2, total - total // 2


def _lecun_normal(shape, fan_in: int, generator: torch.Generator):
    """flax's default kernel init: N(0, 1/fan_in) truncated at 2 std."""
    std = fan_in ** -0.5 / 0.87962566103423978
    w = torch.empty(shape)
    nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std,
                          generator=generator)
    return w


class Conv(nn.Module):
    """A bias-free convolution with an f32 OIHW weight, computed in
    ``dtype``; ``padding`` is ``"SAME"`` (flax's rule, per input size)
    or a symmetric int."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1,
                 padding="SAME", dtype=torch.bfloat16, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin, k, k,
                                               device=device))
        self.k, self.stride, self.padding, self.dtype = k, stride, padding, \
            dtype

    def forward(self, x):
        pad = self.padding
        if pad == "SAME":
            (t, b), (l, r) = (same_pads(n, self.k, self.stride)
                              for n in x.shape[2:])
            if t == b and l == r:
                pad = (t, l)
            else:
                x = F.pad(x, (l, r, t, b))
                pad = 0
        return F.conv2d(x.to(self.dtype), self.weight.to(self.dtype),
                        stride=self.stride, padding=pad)


class BatchNorm(nn.Module):
    """flax's ``nn.BatchNorm`` arithmetic over NCHW (the reference's
    default branch): f32 statistics, the biased variance as E[x²] −
    E[x]² clipped at 0, ``y = (x - mean) * (rsqrt(var + eps) * scale) +
    bias`` in f32 and returned in ``dtype``; running statistics
    ``momentum * running + (1 - momentum) * batch``."""

    def __init__(self, features: int, momentum: float = 0.9,
                 eps: float = 1e-5, dtype=torch.bfloat16, device=None):
        super().__init__()
        self.momentum, self.eps, self.dtype = momentum, eps, dtype
        self.weight = nn.Parameter(torch.ones(features, device=device))
        self.bias = nn.Parameter(torch.zeros(features, device=device))
        self.register_buffer("running_mean",
                             torch.zeros(features, device=device))
        self.register_buffer("running_var",
                             torch.ones(features, device=device))

    def normalize(self, x, use_running_average: bool):
        """``(y, stats)``; ``stats`` the running (mean, var) after this
        batch (detached), None when normalizing with the running ones."""
        xf = x.float()
        stats = None
        if use_running_average:
            mean, var = self.running_mean, self.running_var
        else:
            mean = xf.mean(dim=(0, 2, 3))
            var = torch.clamp((xf * xf).mean(dim=(0, 2, 3)) - mean * mean,
                              min=0.0)
            with torch.no_grad():
                m = self.momentum
                stats = (m * self.running_mean + (1 - m) * mean,
                         m * self.running_var + (1 - m) * var)
        mul = torch.rsqrt(var + self.eps) * self.weight.float()
        y = (xf - mean[:, None, None]) * mul[:, None, None] \
            + self.bias.float()[:, None, None]
        return y.to(self.dtype), stats


def _norm(cfg: ResNetConfig, features: int, device) -> nn.Module:
    if cfg.use_syncbn:
        return SyncBatchNorm(features, eps=cfg.bn_eps,
                             momentum=1.0 - cfg.bn_momentum, device=device)
    return BatchNorm(features, cfg.bn_momentum, cfg.bn_eps, cfg.dtype,
                     device)


def _bn(mod, x, train: bool, stats: Optional[Stats]):
    y, new = mod.normalize(x, not train)
    if new is not None and stats is not None:
        stats[mod.path] = new
    return y


class BottleneckBlock(nn.Module):
    def __init__(self, cfg: ResNetConfig, cin: int, filters: int,
                 strides: int, device):
        super().__init__()
        dt = cfg.dtype
        self.conv1 = Conv(cin, filters, 1, dtype=dt, device=device)
        self.bn1 = _norm(cfg, filters, device)
        self.conv2 = Conv(filters, filters, 3, strides, dtype=dt,
                          device=device)
        self.bn2 = _norm(cfg, filters, device)
        self.conv3 = Conv(filters, 4 * filters, 1, dtype=dt, device=device)
        self.bn3 = _norm(cfg, 4 * filters, device)
        if strides != 1 or cin != 4 * filters:
            self.downsample_conv = Conv(cin, 4 * filters, 1, strides,
                                        dtype=dt, device=device)
            self.downsample_bn = _norm(cfg, 4 * filters, device)
        else:
            self.downsample_conv = self.downsample_bn = None

    def forward(self, x, train: bool, stats: Optional[Stats]):
        residual = x
        y = F.relu(_bn(self.bn1, self.conv1(x), train, stats))
        y = F.relu(_bn(self.bn2, self.conv2(y), train, stats))
        y = _bn(self.bn3, self.conv3(y), train, stats)
        if self.downsample_conv is not None:
            residual = _bn(self.downsample_bn, self.downsample_conv(residual),
                           train, stats)
        return F.relu(residual + y)


class ResNet(nn.Module):
    """Input (N, H, W, 3) -> logits (N, num_classes) in f32; in training
    ``(logits, batch_stats)`` (see the module docstring).  The weights
    are drawn from ``generator`` on the host (flax's initializers: lecun
    normal kernels, BN scale 1 and bn3's 0, biases 0), so a seed gives
    the same model on every device."""

    def __init__(self, cfg: ResNetConfig, *, device="cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        self.conv_stem = Conv(3, cfg.width, 7, 2, padding=3, dtype=cfg.dtype,
                              device=dev)
        self.bn_stem = _norm(cfg, cfg.width, dev)
        self.blocks = []
        cin = cfg.width
        for i, n_blocks in enumerate(cfg.stage_sizes):
            for j in range(n_blocks):
                name = f"stage{i}_block{j}"
                block = BottleneckBlock(
                    cfg, cin, cfg.width * 2 ** i,
                    2 if (j == 0 and i > 0) else 1, dev)
                self.add_module(name, block)
                self.blocks.append(name)
                cin = 4 * cfg.width * 2 ** i
        self.fc = nn.Linear(cin, cfg.num_classes, device=dev)
        for name, mod in self.named_modules():
            if isinstance(mod, (BatchNorm, SyncBatchNorm)):
                mod.path = name.replace(".", "/")
        self.reset_parameters(generator or torch.Generator().manual_seed(0))

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        for name, p in self.named_parameters():
            if p.ndim == 4:  # a convolution's OIHW kernel
                fan_in = p.shape[1] * p.shape[2] * p.shape[3]
                p.copy_(_lecun_normal(p.shape, fan_in, generator))
            elif name == "fc.weight":
                p.copy_(_lecun_normal(p.shape, p.shape[1], generator))
            elif name.endswith(".bias"):
                p.zero_()
            else:  # a norm's scale; bn3 starts the branch at identity
                p.fill_(0.0 if name.endswith("bn3.weight") else 1.0)
        for name, b in self.named_buffers():
            if name.endswith("running_mean"):
                b.zero_()
            elif name.endswith("running_var"):
                b.fill_(1.0)

    def forward(self, x, train: bool = True):
        stats: Optional[Stats] = {} if train else None
        x = x.permute(0, 3, 1, 2)  # NCHW view, channels-last strides
        x = self.conv_stem(x.to(self.cfg.dtype))
        x = F.relu(_bn(self.bn_stem, x, train, stats))
        x = F.max_pool2d(x, 3, 2, padding=1)
        for name in self.blocks:
            x = getattr(self, name)(x, train, stats)
        x = x.mean(dim=(2, 3))
        logits = F.linear(x.float(), self.fc.weight.float(),
                          self.fc.bias.float())
        return (logits, stats) if train else logits

    def norms(self):
        return [(mod.path, mod) for _, mod in self.named_modules()
                if isinstance(mod, (BatchNorm, SyncBatchNorm))]

    def batch_stats(self) -> Stats:
        """Every norm's running (mean, var), keyed by its path
        (``"stage0_block0/bn1"``)."""
        return {path: (mod.running_mean, mod.running_var)
                for path, mod in self.norms()}

    @torch.no_grad()
    def load_batch_stats(self, stats: Stats) -> None:
        """Store running statistics as :meth:`forward` returned them."""
        for path, mod in self.norms():
            if path in stats:
                mod.running_mean.copy_(stats[path][0])
                mod.running_var.copy_(stats[path][1])


def resnet50(*, device="cuda", generator=None, **overrides) -> ResNet:
    return ResNet(resnet50_config(**overrides), device=device,
                  generator=generator)


def forward_flops(cfg: ResNetConfig, image_size: int) -> int:
    """The forward's floating-point operations for one image, from the
    convolution and fc shapes: 2 · H_out · W_out · C_out · C_in · k² a
    convolution and 2 · in · out for the head (the norms, ReLUs, pool
    and adds left out)."""
    def out(n, k, s, pad=None):
        lo, hi = same_pads(n, k, s) if pad is None else (pad, pad)
        return (n + lo + hi - k) // s + 1

    h = out(image_size, 7, 2, 3)
    flops = 2 * h * h * cfg.width * 3 * 49
    h = (h + 2 - 3) // 2 + 1  # the max pool
    cin = cfg.width
    for i, n_blocks in enumerate(cfg.stage_sizes):
        f = cfg.width * 2 ** i
        for j in range(n_blocks):
            s = 2 if (j == 0 and i > 0) else 1
            ho = out(h, 3, s)
            flops += 2 * h * h * cin * f            # conv1
            flops += 2 * ho * ho * f * f * 9        # conv2
            flops += 2 * ho * ho * f * 4 * f        # conv3
            if s != 1 or cin != 4 * f:
                flops += 2 * ho * ho * cin * 4 * f  # downsample
            h, cin = ho, 4 * f
    return flops + 2 * cin * cfg.num_classes


# ---------------------------------------------------------------------------
# weights carried across from and to the JAX model's variables
# ---------------------------------------------------------------------------


def _bn_name(cfg: ResNetConfig) -> str:
    return "SyncBatchNorm_0" if cfg.use_syncbn else "BatchNorm_0"


def _leaf(tree, path):
    for k in path:
        tree = tree[k]
    return np.asarray(tree)


def _put(tree, path, value):
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = value


def _param_paths(model: ResNet):
    """(torch name, JAX path under "params", transpose) of every
    parameter."""
    bn = _bn_name(model.cfg)
    for name, p in model.named_parameters():
        parts = name.split(".")
        mod, leaf = parts[:-1], parts[-1]
        if p.ndim == 4:
            yield name, (*mod, "kernel"), (2, 3, 1, 0)
        elif mod == ["fc"]:
            yield name, ("fc", "kernel" if leaf == "weight" else "bias"), \
                ((1, 0) if leaf == "weight" else None)
        else:
            yield name, (*mod, bn, "scale" if leaf == "weight" else "bias"), \
                None


@torch.no_grad()
def load_jax_variables(model: ResNet, variables_np: Mapping) -> ResNet:
    """Copy a JAX ``ResNet.init``/training ``{"params", "batch_stats"}``
    (numpy arrays) into ``model``; returns it."""
    params = dict(model.named_parameters())
    for name, path, perm in _param_paths(model):
        a = _leaf(variables_np["params"], path)
        if perm is not None:
            a = np.transpose(a, np.argsort(perm)) if a.ndim == 4 else a.T
        params[name].copy_(torch.from_numpy(np.array(a, np.float32)))
    bn = _bn_name(model.cfg)
    for path, mod in model.norms():
        stats = variables_np["batch_stats"]
        for buf, leaf in ((mod.running_mean, "mean"),
                          (mod.running_var, "var")):
            buf.copy_(torch.from_numpy(np.array(
                _leaf(stats, (*path.split("/"), bn, leaf)), np.float32)))
    return model


def from_jax_variables(variables_np: Mapping, cfg: ResNetConfig, *,
                       device="cuda") -> ResNet:
    """A port :class:`ResNet` holding a JAX model's variables."""
    return load_jax_variables(ResNet(cfg, device=device), variables_np)


def to_jax_variables(model: ResNet, tensors: Optional[Mapping] = None,
                     stats: Optional[Stats] = None) -> dict:
    """``{"params", "batch_stats"}`` in the JAX model's layout as f32
    numpy arrays: the model's parameters (or ``tensors`` keyed by
    parameter name, e.g. gradients) and its running statistics (or
    ``stats`` as :meth:`ResNet.forward` returns them)."""
    if tensors is None:
        tensors = dict(model.named_parameters())
    if stats is None:
        stats = model.batch_stats()
    out = {"params": {}, "batch_stats": {}}
    for name, path, perm in _param_paths(model):
        a = _host_f32(tensors[name])
        if perm is not None:
            a = np.ascontiguousarray(np.transpose(a, perm) if a.ndim == 4
                                     else a.T)
        _put(out["params"], path, a)
    bn = _bn_name(model.cfg)
    for path, (mean, var) in stats.items():
        base = (*path.split("/"), bn)
        _put(out["batch_stats"], (*base, "mean"),
             _host_f32(mean))
        _put(out["batch_stats"], (*base, "var"),
             _host_f32(var))
    return out
