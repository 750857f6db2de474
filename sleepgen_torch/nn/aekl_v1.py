"""The first-generation VAE (the reference's own AutoencoderKL) and the
max-pool baseline, in torch's (B, C, L) layout.

Counterpart of ``sleepgen/nn/aekl_v1.py`` (reference ``src/models/ae_kl.py``,
the stage-1 model of its first-version pipeline). Against the main-path
``AutoencoderKL``: GroupNorm with 32 groups, an ``n_channels x ch_mult``
channel progression with optional attention per resolution, a mandatory
attention block in the middle of each column, a ``z_channels``
bottleneck with separate ``embed_dim`` 1x1 convolutions.

Submodules follow the reference's flat layout, the one
``sleepgen.utils.torch_import.import_aekl_v1`` walks: ``encoder.blocks.N``
and ``decoder.blocks.N`` number conv_in, the resblocks (``norm1``,
``conv1``, ``norm2``, ``conv2``, ``nin_shortcut``), the attention blocks
(``norm``, ``q``, ``k``, ``v``, ``proj_out``) and the resampling convs
(``conv``) in order, then norm_out and conv_out; so a reference v1 state
dict loads with ``strict=True``. Every GroupNorm runs kernel K1 on a CUDA
tensor (K3 for its gradient); the convolutions run ``F.conv1d`` and the
attention ``layers.attention``.

Random draws: ``sampling`` takes the eps tensor itself or a generator to
draw it from, so tests can feed the JAX package's threefry draws.
"""
from __future__ import annotations

from typing import Sequence, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from sleepgen_torch.nn.aekl import AEResBlock, Downsample, Upsample
from sleepgen_torch.nn.layers import AttentionBlock1d, GroupNorm32, conv1d

Eps = Union[torch.Tensor, torch.Generator]


def _res(cin: int, cout: int, groups: int) -> AEResBlock:
    return AEResBlock(cin, cout, groups, conv=conv1d)


def _attn(ch: int, groups: int) -> AttentionBlock1d:
    return AttentionBlock1d(ch, 1, groups, split_qkv=True)


class EncoderV1(nn.Module):
    def __init__(self, in_channels: int = 1, n_channels: int = 64, z_channels: int = 3,
                 ch_mult: Sequence[int] = (1, 2, 4), num_res_blocks: int = 2,
                 resolution: int = 3072, attn_resolutions: Sequence[int] = (),
                 num_groups: int = 32):
        super().__init__()
        blocks = [conv1d(in_channels, n_channels, 3)]
        ch, res = n_channels, resolution
        for i, mult in enumerate(ch_mult):
            out_ch = n_channels * mult
            for _ in range(num_res_blocks):
                blocks.append(_res(ch, out_ch, num_groups))
                ch = out_ch
                if res in attn_resolutions:
                    blocks.append(_attn(ch, num_groups))
            if i != len(ch_mult) - 1:
                blocks.append(Downsample(ch, conv=conv1d))
                res //= 2
        blocks += [_res(ch, ch, num_groups), _attn(ch, num_groups), _res(ch, ch, num_groups),
                   GroupNorm32(ch, num_groups), conv1d(ch, z_channels, 3)]
        self.blocks = nn.ModuleList(blocks)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for block in self.blocks:
            x = block(x)
        return x


class DecoderV1(nn.Module):
    def __init__(self, n_channels: int = 64, z_channels: int = 3, out_channels: int = 1,
                 ch_mult: Sequence[int] = (1, 2, 4), num_res_blocks: int = 2,
                 resolution: int = 3072, attn_resolutions: Sequence[int] = (),
                 num_groups: int = 32):
        super().__init__()
        ch = n_channels * ch_mult[-1]
        res = resolution // 2 ** (len(ch_mult) - 1)
        blocks = [conv1d(z_channels, ch, 3), _res(ch, ch, num_groups), _attn(ch, num_groups),
                  _res(ch, ch, num_groups)]
        for i in reversed(range(len(ch_mult))):
            out_ch = n_channels * ch_mult[i]
            for _ in range(num_res_blocks):
                blocks.append(_res(ch, out_ch, num_groups))
                ch = out_ch
                if res in attn_resolutions:
                    blocks.append(_attn(ch, num_groups))
            if i != 0:
                blocks.append(Upsample(ch, conv=conv1d))
                res *= 2
        blocks += [GroupNorm32(ch, num_groups), conv1d(ch, out_channels, 3)]
        self.blocks = nn.ModuleList(blocks)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        for block in self.blocks:
            z = block(z)
        return z


class AutoencoderKLV1(nn.Module):
    """The v1 VAE over (B, in_channels, L) windows; the latent is
    (B, embed_dim, L / 2**(len(ch_mult) - 1)). fp32, as the JAX package's
    v1 trainers run it."""

    def __init__(self, embed_dim: int = 3, in_channels: int = 1, out_channels: int = 1,
                 n_channels: int = 64, z_channels: int = 3, ch_mult: Sequence[int] = (1, 2, 4),
                 num_res_blocks: int = 2, resolution: int = 3072,
                 attn_resolutions: Sequence[int] = (), num_groups: int = 32):
        super().__init__()
        self.embed_dim, self.ch_mult = embed_dim, tuple(ch_mult)
        kw = dict(n_channels=n_channels, z_channels=z_channels, ch_mult=ch_mult,
                  num_res_blocks=num_res_blocks, resolution=resolution,
                  attn_resolutions=tuple(attn_resolutions), num_groups=num_groups)
        self.encoder = EncoderV1(in_channels=in_channels, **kw)
        self.decoder = DecoderV1(out_channels=out_channels, **kw)
        self.quant_conv_mu = conv1d(z_channels, embed_dim, 1)
        self.quant_conv_log_sigma = conv1d(z_channels, embed_dim, 1)
        self.post_quant_conv = conv1d(embed_dim, z_channels, 1)

    @property
    def dtype(self) -> torch.dtype:
        return self.post_quant_conv.weight.dtype

    def encode(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """x -> (z_mu, z_sigma); the log-variance clamped to [-30, 20] in fp32."""
        h = self.encoder(x.to(self.dtype))
        z_mu = self.quant_conv_mu(h)
        z_log_var = self.quant_conv_log_sigma(h).float().clamp(-30.0, 20.0)
        return z_mu, torch.exp(0.5 * z_log_var).to(h.dtype)

    def sampling(self, z_mu: torch.Tensor, z_sigma: torch.Tensor, eps: Eps) -> torch.Tensor:
        """z_mu + eps * z_sigma; ``eps`` is the draw itself, or a generator
        on z_mu's device to draw it from."""
        if isinstance(eps, torch.Generator):
            eps = torch.randn(z_sigma.shape, generator=eps, device=z_sigma.device,
                              dtype=z_sigma.dtype)
        return z_mu + eps.to(z_sigma.dtype) * z_sigma

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        return self.decoder(self.post_quant_conv(z.to(self.dtype)))

    def get_ldm_inputs(self, x: torch.Tensor, eps: Eps) -> torch.Tensor:
        """A posterior sample of x, the diffusion model's input."""
        return self.sampling(*self.encode(x), eps)

    def reconstruct_ldm_outputs(self, z: torch.Tensor) -> torch.Tensor:
        return self.decode(z)

    def forward(self, x: torch.Tensor, eps: Eps):
        """(recon, z_mu, z_sigma) of x through the posterior sample."""
        z_mu, z_sigma = self.encode(x)
        return self.decode(self.sampling(z_mu, z_sigma, eps)), z_mu, z_sigma


class VAEDownsample(nn.Module):
    """The non-learned baseline: max-pool by ``factor`` (VALID) down, linear
    interpolation by ``factor`` up (``jax.image.resize(..., "linear")``,
    half-pixel centres, the edge samples held)."""

    def __init__(self, factor: int = 4):
        super().__init__()
        self.factor = factor

    def get_ldm_inputs(self, x: torch.Tensor) -> torch.Tensor:
        return F.max_pool1d(x, self.factor, self.factor)

    def reconstruct_ldm_outputs(self, z: torch.Tensor) -> torch.Tensor:
        return F.interpolate(z, size=z.shape[-1] * self.factor, mode="linear",
                             align_corners=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.get_ldm_inputs(x)
