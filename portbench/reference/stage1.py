"""Plain PyTorch reference of a stage-1 training step: the 1-D
AutoencoderKL (``models.AutoencoderKL``) against MONAI-generative's
``PatchDiscriminator(spatial_dims=1, num_layers_d=3, num_channels=64,
kernel_size=3, norm="BATCH")``, as the reference repository's
``train_autoencoderkl.py`` trains them with ``config/config_aekl_eeg.yaml``.

One step is the G step, then the D step:

  G: L1(recon, x) + kl_weight * KL + adv_weight * LSGAN(D(recon) -> 1),
     the discriminator's parameters frozen; Adam on the autoencoder
  D: adv_weight * 0.5 * (LSGAN(D(recon) -> 0) + LSGAN(D(x) -> 1)) on the
     G step's recon, made before the G update; Adam on the discriminator

The posterior sample is ``z_mu + eps * exp(log_var / 2)``, the log-variance
clamped to [-30, 20]; KL is ``0.5 (mu^2 + sigma^2 - log sigma^2 - 1)``
summed over (C, L) and averaged over the batch; LSGAN is the mean squared
error of LeakyReLU(0.05) of the logits against the label. The
discriminator: convolutions with flax's "SAME" padding ((0, 1) for k 3,
stride 2 on an even length), LeakyReLU(0.2), BatchNorm with the batch's
statistics (biased variance, eps 1e-5) in every forward of a training
step; its running statistics do not enter the step and are not kept.

The autoencoder runs in blocks of rows so that a batch of 2048 windows
fits in float32: the G step first makes every row's reconstruction
without autograd, runs the discriminator over the whole batch (its
batch statistics are the whole batch's) for the gradient of the
adversarial term at the reconstruction, then each block's forward again
with autograd and its backward with that gradient added. The sum over
blocks is the whole batch's gradient.

Float32 throughout, no fused kernels; ``models.Precision`` rounds every
product's operands. Two switches plant a fault: ``leaky`` False (LSGAN on
the raw logits) and ``running`` True (BatchNorm on its running statistics,
0 and 1, in place of the batch's).

Nothing here imports the program under test or the JAX package.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import torch
import torch.nn.functional as F
from torch import nn

from .models import AutoencoderKL, Precision

BN_EPS = 1e-5


def same_padding(length: int, k: int, stride: int) -> tuple:
    """flax's "SAME": ceil(L / stride) outputs, the odd pad on the right."""
    out = -(-length // stride)
    total = max((out - 1) * stride + k - length, 0)
    return total // 2, total - total // 2


class SameConv(nn.Module):
    def __init__(self, cin: int, cout: int, k: int, stride: int, bias: bool, prec: Precision):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin, k))
        self.bias = nn.Parameter(torch.empty(cout)) if bias else None
        self.stride, self.k, self.prec = stride, k, prec

    def forward(self, x):
        x = F.pad(x, same_padding(x.shape[-1], self.k, self.stride))
        return F.conv1d(self.prec(x), self.prec(self.weight), self.bias, stride=self.stride)


class BatchNorm(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(channels))
        self.bias = nn.Parameter(torch.empty(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def forward(self, x, running: bool = False):
        if running:
            mean, var = self.running_mean[:, None], self.running_var[:, None]
        else:
            mean = x.mean(dim=(0, 2), keepdim=True)
            var = (x - mean).square().mean(dim=(0, 2), keepdim=True)
        return (x - mean) * torch.rsqrt(var + BN_EPS) * self.weight[:, None] + self.bias[:, None]


class PatchDiscriminator(nn.Module):
    """(B, 1, L) -> logits (B, 1, L / 2^(layers - 1)): conv k3 s2 (bias),
    LeakyReLU(0.2); per layer conv k3 (stride 2, 1 for the last; no
    bias), BatchNorm, LeakyReLU(0.2); conv k3 s1 (bias)."""

    def __init__(self, num_layers_d: int = 3, num_channels: int = 64, in_channels: int = 1,
                 out_channels: int = 1, kernel_size: int = 3, prec: Precision | None = None):
        super().__init__()
        prec = prec or Precision()
        k, ch = kernel_size, num_channels
        self.layers = num_layers_d
        self.initial_conv = SameConv(in_channels, ch, k, 2, True, prec)
        for l in range(num_layers_d):
            stride = 1 if l == num_layers_d - 1 else 2
            self.add_module(f"layer_{l}_conv", SameConv(ch, 2 * ch, k, stride, False, prec))
            self.add_module(f"layer_{l}_bn", BatchNorm(2 * ch))
            ch *= 2
        self.final_conv = SameConv(ch, out_channels, k, 1, True, prec)

    def forward(self, x, running: bool = False):
        h = F.leaky_relu(self.initial_conv(x), 0.2)
        for l in range(self.layers):
            h = getattr(self, f"layer_{l}_bn")(getattr(self, f"layer_{l}_conv")(h), running)
            h = F.leaky_relu(h, 0.2)
        return self.final_conv(h)


def lsgan_rows(logits: torch.Tensor, target: float, leaky: bool = True) -> torch.Tensor:
    """Per row, the mean of (LeakyReLU(0.05)(logits) - target)^2."""
    x = F.leaky_relu(logits, 0.05) if leaky else logits
    return (x - target).square().mean(dim=tuple(range(1, x.dim())))


def kl_rows(mu: torch.Tensor, sigma: torch.Tensor) -> torch.Tensor:
    var = sigma.square()
    return 0.5 * (mu.square() + var - torch.log(var) - 1.0).sum(dim=tuple(range(1, mu.dim())))


def reconstruct(ae: AutoencoderKL, x: torch.Tensor, eps: torch.Tensor):
    """(recon, mu, sigma) of x through the posterior sample."""
    h = ae.encoder(x)
    mu = ae.quant_conv_mu(h)
    sigma = torch.exp(0.5 * ae.quant_conv_log_sigma(h).clamp(-30.0, 20.0))
    return ae.decode(mu + eps * sigma), mu, sigma


def grads(module: nn.Module) -> Dict[str, torch.Tensor]:
    return {k: p.grad.detach().clone() for k, p in module.named_parameters()}


def train_step(ae: AutoencoderKL, disc: PatchDiscriminator, x: torch.Tensor,
               eps: torch.Tensor, adv_weight: float, kl_weight: float, block: int,
               leaky: bool = True, running: bool = False,
               blocks: Optional[List[Dict[str, torch.Tensor]]] = None):
    """The gradients of one step at the parameters given, without updating
    them: (g_loss, d_loss, G gradients, D gradients) by name. With
    ``blocks`` (a list), it also gets each block of rows' part of both
    gradients, scaled to the batch (the parts sum to the gradient), as one
    dict over both networks' leaves, prefixed ``ae.`` and ``disc.``."""
    n = x.shape[0]
    starts = range(0, n, block)
    with torch.no_grad():
        recon = torch.cat([reconstruct(ae, x[s:s + block], eps[s:s + block])[0]
                           for s in starts])
    disc.requires_grad_(False)
    r = recon.clone().requires_grad_(True)
    gen = lsgan_rows(disc(r, running), 1.0, leaky).mean()
    (adv_weight * gen).backward()
    disc.requires_grad_(True)
    g_adv, l1, kl, before = r.grad, 0.0, 0.0, None
    parts = []
    for s in starts:
        e = min(n, s + block)
        rb, mu, sigma = reconstruct(ae, x[s:e], eps[s:e])
        l1_part = (rb - x[s:e]).abs().sum() / x.numel()
        kl_part = kl_rows(mu, sigma).sum() / n
        (l1_part + kl_weight * kl_part + (rb * g_adv[s:e]).sum()).backward()
        l1, kl = l1 + float(l1_part.detach()), kl + float(kl_part.detach())
        if blocks is not None:
            now = grads(ae)
            parts.append({f"ae.{k}": (v - (before[k] if before else 0.0)) * (n / (e - s))
                          for k, v in now.items()})
            before = now
    g = grads(ae)
    ae.zero_grad(set_to_none=True)

    fake = lsgan_rows(disc(recon, running), 0.0, leaky)
    real = lsgan_rows(disc(x, running), 1.0, leaky)
    d_loss = 0.5 * (fake.mean() + real.mean())
    params = dict(disc.named_parameters())
    if blocks is not None:
        for part, s in zip(parts, starts):
            e = min(n, s + block)
            got = torch.autograd.grad(adv_weight * 0.5 * (fake[s:e].sum() + real[s:e].sum()) / n,
                                      list(params.values()), retain_graph=True)
            part.update({f"disc.{k}": v * (n / (e - s)) for k, v in zip(params, got)})
        blocks.extend(parts)
    (adv_weight * d_loss).backward()
    d = grads(disc)
    disc.zero_grad(set_to_none=True)
    g_loss = l1 + kl_weight * kl + adv_weight * float(gen.detach())
    return g_loss, float(d_loss.detach()), g, d
