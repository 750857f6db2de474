"""1-D AutoencoderKL (the stage-1 VAE) in torch's (B, C, L) layout.

Counterpart of ``sleepgen/nn/aekl.py`` (MONAI-generative ``AutoencoderKL``;
the reference configuration has GroupNorm with one group and no
attention). Submodules carry MONAI's names (``encoder.blocks.1.norm1``,
``decoder.blocks.0.conv.weight``, ...), so state dicts of
``sleepgen.utils.torch_import.export_aekl_monai`` load with ``strict=True``.
Every GroupNorm runs kernel K1 (K3 for its gradient in stage-1 training);
the convolutions run ``F.conv1d``.

``attention_levels`` and the two non-local attentions place
``AttentionBlock``s where MONAI's AutoencoderKL and the JAX package place
them: after each resblock of an attention level, and as resblock,
attention, resblock before ``norm_out`` (encoder) or after ``conv_in``
(decoder). One head, the AEKL's groups; the attention is the JAX
package's strict path (its AEKL never takes fast_math).
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from sleepgen_torch.nn.layers import GroupNorm32, attention, conv1d


class Convolution(nn.Module):
    """A Conv1d held as child ``conv``, as MONAI's Convolution block."""

    def __init__(self, in_channels: int, out_channels: int, kernel: int = 3,
                 stride: int = 1, padding: int | None = None):
        super().__init__()
        self.conv = conv1d(in_channels, out_channels, kernel, stride, padding)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x)


class AEResBlock(nn.Module):
    """GN -> SiLU -> conv3 -> GN -> SiLU -> conv3, plus a 1x1 shortcut when
    the channel count changes. ``conv`` makes the convolutions: MONAI's
    ``Convolution`` (``conv1.conv.weight``), or ``conv1d`` for the
    first-generation VAE's names (``conv1.weight``)."""

    def __init__(self, in_channels: int, out_channels: int, num_groups: int = 1,
                 conv=Convolution):
        super().__init__()
        self.norm1 = GroupNorm32(in_channels, num_groups, fuse_silu=True)
        self.conv1 = conv(in_channels, out_channels, 3)
        self.norm2 = GroupNorm32(out_channels, num_groups, fuse_silu=True)
        self.conv2 = conv(out_channels, out_channels, 3)
        self.nin_shortcut = (conv(in_channels, out_channels, 1)
                             if in_channels != out_channels else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv2(self.norm2(self.conv1(self.norm1(x))))
        if self.nin_shortcut is not None:
            x = self.nin_shortcut(x)
        return x + h


class Downsample(nn.Module):
    """Right-pad by one, then a stride-2 VALID conv: ceil(L / 2) outputs.
    ``conv`` as ``AEResBlock``'s."""

    def __init__(self, channels: int, conv=Convolution):
        super().__init__()
        self.conv = conv(channels, channels, 3, stride=2, padding=0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(F.pad(x, (0, 1)))


class Upsample(nn.Module):
    """Nearest x2 along L, then a conv3. ``conv`` as ``AEResBlock``'s."""

    def __init__(self, channels: int, conv=Convolution):
        super().__init__()
        self.conv = conv(channels, channels, 3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x.repeat_interleave(2, dim=-1))


class PointwiseLinear(nn.Linear):
    """MONAI's ``nn.Linear`` over the channels, on (B, C, L)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv1d(x, self.weight[:, :, None], self.bias)


class AttentionBlock(nn.Module):
    """GroupNorm (no SiLU) -> one-head self-attention -> residual add, with
    MONAI's names (``norm``, ``to_q``, ``to_k``, ``to_v``, ``proj_attn``,
    linear weights (C, C)) and the math of ``layers.attention`` on its
    strict path."""

    def __init__(self, channels: int, num_groups: int = 1):
        super().__init__()
        self.norm = GroupNorm32(channels, num_groups)
        self.to_q, self.to_k, self.to_v, self.proj_attn = (
            PointwiseLinear(channels, channels) for _ in range(4))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.norm(x)
        qkv = torch.cat([self.to_q(h), self.to_k(h), self.to_v(h)], dim=1)
        return x + self.proj_attn(attention(qkv, 1, mixed_precision=False))


def _column(first: nn.Module, chans: Sequence[int], in_ch: int, num_res_blocks: int,
            num_groups: int, resample, last_out: int, attention_levels: Sequence[bool],
            mid: str = "") -> nn.ModuleList:
    """MONAI's block list: conv_in, resblocks (each followed by an
    attention block on an attention level) with resampling between
    levels, norm_out (GroupNorm without SiLU), conv_out; ``mid`` "first" or
    "last" puts resblock, attention, resblock after conv_in or before
    norm_out."""
    def mid_blocks(ch):
        return [AEResBlock(ch, ch, num_groups), AttentionBlock(ch, num_groups),
                AEResBlock(ch, ch, num_groups)]

    blocks = [first] + (mid_blocks(in_ch) if mid == "first" else [])
    ch = in_ch
    for level, out_ch in enumerate(chans):
        for _ in range(num_res_blocks):
            blocks.append(AEResBlock(ch, out_ch, num_groups))
            ch = out_ch
            if attention_levels[level]:
                blocks.append(AttentionBlock(ch, num_groups))
        if level != len(chans) - 1:
            blocks.append(resample(ch))
    blocks += mid_blocks(ch) if mid == "last" else []
    blocks += [GroupNorm32(ch, num_groups), Convolution(ch, last_out, 3)]
    return nn.ModuleList(blocks)


class Encoder(nn.Module):
    def __init__(self, in_channels: int, num_channels: Sequence[int],
                 latent_channels: int, num_res_blocks: int = 2, num_groups: int = 1,
                 attention_levels: Sequence[bool] = (), with_nonlocal_attn: bool = False):
        super().__init__()
        self.blocks = _column(Convolution(in_channels, num_channels[0], 3),
                              num_channels, num_channels[0], num_res_blocks,
                              num_groups, Downsample, latent_channels,
                              attention_levels or [False] * len(num_channels),
                              "last" if with_nonlocal_attn else "")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for block in self.blocks:
            x = block(x)
        return x


class Decoder(nn.Module):
    def __init__(self, num_channels: Sequence[int], latent_channels: int,
                 out_channels: int = 1, num_res_blocks: int = 2, num_groups: int = 1,
                 attention_levels: Sequence[bool] = (), with_nonlocal_attn: bool = False):
        super().__init__()
        rev = list(reversed(num_channels))
        self.blocks = _column(Convolution(latent_channels, rev[0], 3), rev, rev[0],
                              num_res_blocks, num_groups, Upsample, out_channels,
                              list(reversed(attention_levels or [False] * len(rev))),
                              "first" if with_nonlocal_attn else "")

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        for block in self.blocks:
            z = block(z)
        return z


class AutoencoderKL(nn.Module):
    """VAE over (B, in_channels, L) windows; the latent is
    (B, latent_channels, L / 4) for three levels."""

    def __init__(self, num_channels: Sequence[int] = (32, 32, 64),
                 latent_channels: int = 1, in_channels: int = 1,
                 out_channels: int = 1, num_res_blocks: int = 2,
                 norm_num_groups: int = 1,
                 attention_levels: Sequence[bool] = (False, False, False),
                 with_encoder_nonlocal_attn: bool = False,
                 with_decoder_nonlocal_attn: bool = False):
        super().__init__()
        self.encoder = Encoder(in_channels, num_channels, latent_channels,
                               num_res_blocks, norm_num_groups, attention_levels,
                               with_encoder_nonlocal_attn)
        self.decoder = Decoder(num_channels, latent_channels, out_channels,
                               num_res_blocks, norm_num_groups, attention_levels,
                               with_decoder_nonlocal_attn)
        self.quant_conv_mu = Convolution(latent_channels, latent_channels, 1)
        self.quant_conv_log_sigma = Convolution(latent_channels, latent_channels, 1)
        self.post_quant_conv = Convolution(latent_channels, latent_channels, 1)

    @property
    def dtype(self) -> torch.dtype:
        return self.post_quant_conv.conv.weight.dtype

    def encode(self, x: torch.Tensor):
        """x -> (z_mu, z_sigma); log-variance clamped to [-30, 20] in fp32."""
        h = self.encoder(x.to(self.dtype))
        z_mu = self.quant_conv_mu(h)
        z_log_var = self.quant_conv_log_sigma(h).float().clamp(-30.0, 20.0)
        return z_mu, torch.exp(0.5 * z_log_var).to(h.dtype)

    def sampling(self, z_mu: torch.Tensor, z_sigma: torch.Tensor,
                 generator: torch.Generator) -> torch.Tensor:
        """z_mu + eps * z_sigma, eps drawn from ``generator`` (which must
        live on z_mu's device)."""
        eps = torch.randn(z_sigma.shape, generator=generator,
                          device=z_sigma.device, dtype=z_sigma.dtype)
        return z_mu + eps * z_sigma

    def encode_stage_2_inputs(self, x: torch.Tensor,
                              generator: torch.Generator) -> torch.Tensor:
        """A posterior sample z = z_mu + eps * z_sigma of x, the diffusion
        model's input; eps drawn from ``generator``."""
        return self.sampling(*self.encode(x), generator)

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        return self.decoder(self.post_quant_conv(z.to(self.dtype)))

    def reconstruct(self, x: torch.Tensor) -> torch.Tensor:
        """Deterministic reconstruction through the posterior mean."""
        return self.decode(self.encode(x)[0])

    def decode_stage_2_outputs(self, z: torch.Tensor) -> torch.Tensor:
        return self.decode(z)

    def forward(self, x: torch.Tensor, eps: torch.Tensor):
        """(recon, z_mu, z_sigma) of x through the posterior sample
        z = z_mu + eps * z_sigma, with eps given (B, latent_channels, L')."""
        z_mu, z_sigma = self.encode(x)
        return self.decode(z_mu + eps.to(z_sigma.dtype) * z_sigma), z_mu, z_sigma
