"""DCGAN with amp: two models and two optimizers under mixed precision,
each with its own amp handle and loss scaler.

The port's counterpart of ``examples/dcgan/main_amp.py`` (≙ the
reference's ``amp.initialize([netD, netG], [optD, optG], num_losses=3)``
pattern: per-loss scaling maps to one handle and one state per model).
The generator is ``nn.Linear`` -> 3 x (``nn.GroupNorm`` (8 groups),
ReLU, ``nn.ConvTranspose2d`` 4x4 / 2) -> ``nn.Conv2d`` 3x3 -> tanh,
32 x 32 RGB; the discriminator 3 x (``nn.Conv2d`` 4x4 / 2, leaky ReLU
0.2) -> ``nn.Linear`` to one logit.  Each step trains the discriminator
on a batch of synthetic "real" images and the generator's detached
fakes, then the generator against the updated discriminator, both with
Adam (lr 2e-4, beta1 0.5) through :meth:`AmpHandle.step`.  The weights
are drawn from a seeded generator on the host and moved to the device.

    python -m apex_tpu_torch.examples.dcgan.main_amp --steps 20
    python -m apex_tpu_torch.examples.dcgan.main_amp --device cpu --steps 3

It reaches no hand-written kernel: its layers are PyTorch's own.
"""

from __future__ import annotations

import argparse
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from apex_tpu_torch import amp
from apex_tpu_torch.ops._dispatch import resolve_device
from apex_tpu_torch.optimizers import fused_adam
from apex_tpu_torch.train import module_loss, module_params

__all__ = ["Generator", "Discriminator", "bce", "parse_args", "main"]


class Generator(nn.Module):
    def __init__(self, zdim: int = 64, ch: int = 32, device=None):
        super().__init__()
        self.ch = ch
        self.fc = nn.Linear(zdim, 4 * 4 * ch * 4, device=device)
        self.norms = nn.ModuleList()
        self.ups = nn.ModuleList()
        cin = ch * 4
        for mult in (4, 2, 1):
            self.norms.append(nn.GroupNorm(8, cin, device=device))
            self.ups.append(nn.ConvTranspose2d(cin, ch * mult, 4, stride=2,
                                               padding=1, device=device))
            cin = ch * mult
        self.out = nn.Conv2d(cin, 3, 3, padding=1, device=device)

    def forward(self, z):
        x = self.fc(z.to(self.fc.weight.dtype))
        x = x.reshape(z.shape[0], 4 * self.ch, 4, 4)
        for norm, up in zip(self.norms, self.ups):
            x = up(F.relu(norm(x)))
        return torch.tanh(self.out(x))


class Discriminator(nn.Module):
    def __init__(self, ch: int = 32, device=None):
        super().__init__()
        self.convs = nn.ModuleList()
        cin = 3
        for mult in (1, 2, 4):
            self.convs.append(nn.Conv2d(cin, ch * mult, 4, stride=2,
                                        padding=1, device=device))
            cin = ch * mult
        self.fc = nn.Linear(cin * 4 * 4, 1, device=device)

    def forward(self, img):
        x = img.to(self.fc.weight.dtype)
        for conv in self.convs:
            x = F.leaky_relu(conv(x), 0.2)
        return self.fc(x.reshape(x.shape[0], -1))[:, 0]


def reset_parameters(module: nn.Module, generator: torch.Generator,
                     std: float = 0.02) -> None:
    """Weights N(0, std) from ``generator`` (drawn on the host, so a
    seed gives the same weights on every device), biases 0, the
    GroupNorm scales 1."""
    with torch.no_grad():
        for name, p in module.named_parameters():
            if name.startswith("norms.") and name.endswith(".weight"):
                p.fill_(1.0)
            elif name.endswith(".bias"):
                p.zero_()
            else:
                p.copy_(torch.randn(p.shape, generator=generator) * std)


def bce(logits, label: float):
    """Mean binary cross entropy of ``logits`` against a constant label,
    in f32 (the reference's stable form)."""
    x = logits.float()
    return torch.mean(torch.clamp(x, min=0) - x * label
                      + torch.log1p(torch.exp(-x.abs())))


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--steps", type=int, default=20)
    p.add_argument("--batch", type=int, default=16)
    p.add_argument("--zdim", type=int, default=64)
    p.add_argument("--ch", type=int, default=32)
    p.add_argument("--opt-level", default="O1")
    p.add_argument("--loss-scale", default=None,
                   help="a number or 'dynamic' (default: the opt level's)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def _grads(loss, leaves: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))


def _leaves(params):
    return {k: p.detach().requires_grad_(True) for k, p in params.items()}


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, List[float]]:
    """Train ``--steps`` steps; returns the per-step losses (``d_real``,
    ``d_fake``, ``g``)."""
    args = parse_args(argv)
    dev = resolve_device(args.device)
    loss_scale = args.loss_scale
    if loss_scale not in (None, "dynamic"):
        loss_scale = float(loss_scale)
    gen, disc = Generator(args.zdim, args.ch, dev), Discriminator(args.ch, dev)
    host = torch.Generator().manual_seed(args.seed)
    reset_parameters(gen, host)
    reset_parameters(disc, host)

    # two models, two optimizers, independent scaler state each
    g_params, g_handle = amp.initialize(
        module_params(gen), fused_adam(2e-4, beta1=0.5),
        opt_level=args.opt_level, loss_scale=loss_scale)
    d_params, d_handle = amp.initialize(
        module_params(disc), fused_adam(2e-4, beta1=0.5),
        opt_level=args.opt_level, loss_scale=loss_scale)
    g_state, d_state = g_handle.init(g_params), d_handle.init(d_params)
    run_g = module_loss(gen, lambda m, z: m(z))
    run_d = module_loss(disc, lambda m, img: m(img))

    rng = np.random.RandomState(args.seed)
    losses: Dict[str, List[float]] = {"d_real": [], "d_fake": [], "g": []}
    for i in range(args.steps):
        real = torch.from_numpy(rng.randn(args.batch, 32, 32, 3).astype(
            np.float32)).permute(0, 3, 1, 2).to(dev)
        z = torch.from_numpy(rng.randn(args.batch, args.zdim).astype(
            np.float32)).to(dev)

        # the discriminator: real images against the generator's fakes
        with torch.no_grad():
            fake = run_g(g_params, z)
        leaves = _leaves(d_params)
        l_real = bce(run_d(leaves, real), 1.0)
        l_fake = bce(run_d(leaves, fake), 0.0)
        grads = _grads(d_handle.scale_loss(l_real + l_fake, d_state), leaves)
        d_params, d_state, _ = d_handle.step(d_params, grads, d_state)

        # the generator, against the updated discriminator
        leaves = _leaves(g_params)
        l_g = bce(run_d(d_params, run_g(leaves, z)), 1.0)
        grads = _grads(g_handle.scale_loss(l_g, g_state), leaves)
        g_params, g_state, _ = g_handle.step(g_params, grads, g_state)

        for key, value in (("d_real", l_real), ("d_fake", l_fake),
                           ("g", l_g)):
            losses[key].append(float(value.detach()))
        if i % 5 == 0:
            d = losses["d_real"][-1] + losses["d_fake"][-1]
            print(f"step {i:3d}  D {d:.4f}  G {losses['g'][-1]:.4f}")
    print("done")
    return losses


if __name__ == "__main__":
    main()
