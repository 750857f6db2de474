"""Plain PyTorch reference of the two networks the benchmark drives: the
1-D diffusion UNet (the reference repository's ``UNetModel`` as its
``config/config_ldm.yaml`` and ``config/config_dm.yaml`` build it) and the
1-D AutoencoderKL (MONAI-generative's, as ``config/config_aekl_eeg.yaml``
builds it), in torch's (B, C, L) layout.

Float32 throughout, no fused kernels, no caches: GroupNorm, SiLU, the
convolutions and the attention are written out with ``torch`` operations.
Parameter names follow the reference's modules (``input_blocks.1.0.in_layers.2``,
``encoder.blocks.1.norm1``, ...), so one state dict made by the benchmark
loads into this reference and into the program under test alike.

``Precision`` decides how every product (convolution, linear layer,
attention product) rounds its operands: ``fp32`` (no rounding; TF32 must be
off, ``set_fp32_math``) or ``fp8`` (each operand rounded to float8 e4m3
with a per-tensor scale, products accumulated in fp32): the benchmark's
control, one precision below the configuration's bf16.

Nothing here imports the program under test or the JAX package.
"""
from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

FP8_MAX = 448.0  # largest finite float8 e4m3 value


def set_fp32_math() -> None:
    """Keep float32 products in float32 on the card (no TF32)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


class Precision:
    """How products round their operands: "fp32" or "fp8" (e4m3, per-tensor
    scale). One object is shared by every layer of a model."""

    def __init__(self, mode: str = "fp32"):
        if mode not in ("fp32", "fp8"):
            raise ValueError(f"unknown precision {mode!r}")
        self.mode = mode

    def __call__(self, t: torch.Tensor) -> torch.Tensor:
        if self.mode == "fp32" or t.device.type == "meta":
            return t
        scale = t.detach().abs().amax().clamp(min=1e-30) / FP8_MAX
        return (t / scale).to(torch.float8_e4m3fn).to(t.dtype) * scale


class Conv(nn.Module):
    """Conv1d weight (C_out, C_in, k) and bias, SAME padding unless given."""

    def __init__(self, cin: int, cout: int, k: int, prec: Precision, stride: int = 1,
                 padding: int | None = None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin, k))
        self.bias = nn.Parameter(torch.empty(cout))
        self.stride, self.padding, self.prec = stride, k // 2 if padding is None else padding, prec

    def forward(self, x):
        return F.conv1d(self.prec(x), self.prec(self.weight), self.bias,
                        stride=self.stride, padding=self.padding)


class Linear(nn.Module):
    def __init__(self, cin: int, cout: int, prec: Precision):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin))
        self.bias = nn.Parameter(torch.empty(cout))
        self.prec = prec

    def forward(self, x):
        return F.linear(self.prec(x), self.prec(self.weight), self.bias)


class GroupNorm(nn.Module):
    """GroupNorm over (B, C, L) with eps 1e-6 and the biased variance,
    optionally followed by SiLU."""

    def __init__(self, channels: int, groups: int, silu: bool):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(channels))
        self.bias = nn.Parameter(torch.empty(channels))
        self.groups, self.silu = groups, silu

    def forward(self, x):
        b, c, l = x.shape
        xg = x.reshape(b, self.groups, -1)
        mean = xg.mean(dim=-1, keepdim=True)
        var = (xg - mean).square().mean(dim=-1, keepdim=True)
        y = ((xg - mean) * torch.rsqrt(var + 1e-6)).reshape(b, c, l)
        y = y * self.weight[:, None] + self.bias[:, None]
        return y * torch.sigmoid(y) if self.silu else y


def attention(qkv: torch.Tensor, heads: int, prec: Precision) -> torch.Tensor:
    """Softmax attention over L: qkv (B, 3C, L), q, k and v stacked per head
    along the channels, each of q and k scaled by d^-1/4 -> (B, C, L)."""
    b, c3, l = qkv.shape
    d = c3 // (3 * heads)
    q, k, v = qkv.reshape(b * heads, 3 * d, l).split(d, dim=1)  # (B h, d, L)
    s = 1.0 / math.sqrt(math.sqrt(d))
    w = torch.bmm(prec((q * s).transpose(1, 2)), prec(k * s)).softmax(dim=-1)  # (B h, L, L)
    out = torch.bmm(prec(v), prec(w.transpose(1, 2)))  # (B h, d, L)
    return out.reshape(b, c3 // 3, l)


def timestep_embedding(t: torch.Tensor, dim: int, max_period: float = 10000.0) -> torch.Tensor:
    """[cos | sin] sinusoidal embedding of (B,) timesteps -> (B, dim)."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period) * torch.arange(half, dtype=torch.float32,
                                                             device=t.device) / half)
    args = t.float()[:, None] * freqs[None]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


class ResBlock(nn.Module):
    """GN -> SiLU -> conv3, plus the timestep embedding, GN -> SiLU -> conv3,
    with a 1x1 skip when the channels change; ``up``/``down`` resample h and
    x (nearest x2 / mean of pairs) after the first norm."""

    def __init__(self, cin, cout, emb, groups, prec, up=False, down=False):
        super().__init__()
        self.up, self.down = up, down
        self.in_layers = nn.ModuleDict({"0": GroupNorm(cin, groups, True),
                                        "2": Conv(cin, cout, 3, prec)})
        self.emb_layers = nn.ModuleDict({"1": Linear(emb, cout, prec)})
        self.out_layers = nn.ModuleDict({"0": GroupNorm(cout, groups, True),
                                         "3": Conv(cout, cout, 3, prec)})
        self.skip_connection = Conv(cin, cout, 1, prec) if cin != cout else None

    def forward(self, x, emb_act):
        h = self.in_layers["0"](x)
        if self.up:
            h, x = h.repeat_interleave(2, dim=-1), x.repeat_interleave(2, dim=-1)
        elif self.down:
            h, x = F.avg_pool1d(h, 2), F.avg_pool1d(x, 2)
        h = self.in_layers["2"](h)
        h = h + self.emb_layers["1"](emb_act)[:, :, None]
        h = self.out_layers["3"](self.out_layers["0"](h))
        if self.skip_connection is not None:
            x = self.skip_connection(x)
        return x + h


class AttnBlock(nn.Module):
    """x + proj_out(attention(qkv(GroupNorm(x))))."""

    def __init__(self, ch, heads, groups, prec):
        super().__init__()
        self.norm = GroupNorm(ch, groups, False)
        self.qkv = Conv(ch, 3 * ch, 1, prec)
        self.proj_out = Conv(ch, ch, 1, prec)
        self.heads, self.prec = heads, prec

    def forward(self, x):
        return x + self.proj_out(attention(self.qkv(self.norm(x)), self.heads, self.prec))


class UNet(nn.Module):
    """(B, C, L) noisy input and (B,) timesteps -> (B, C, L) prediction, for
    the reference's options: resblocks that resample, no scale-shift norm,
    no class labels."""

    def __init__(self, channels: int = 1, model_channels: int = 128,
                 channel_mult: Sequence[int] = (1, 2, 4), num_res_blocks: int = 2,
                 attention_resolutions: Sequence[int] = (8, 4), num_heads: int = 1,
                 groups: int = 32, prec: Precision | None = None):
        super().__init__()
        prec = prec or Precision()
        mc, emb = model_channels, 4 * model_channels
        self.mc, self.levels = mc, len(channel_mult)
        self.time_embed = nn.ModuleDict({"0": Linear(mc, emb, prec), "2": Linear(emb, emb, prec)})
        blocks = [nn.ModuleList([Conv(channels, mc, 3, prec)])]
        skips, ch, ds = [mc], mc, 1
        for level, mult in enumerate(channel_mult):
            for _ in range(num_res_blocks):
                layers = [ResBlock(ch, mult * mc, emb, groups, prec)]
                ch = mult * mc
                if ds in attention_resolutions:
                    layers.append(AttnBlock(ch, num_heads, groups, prec))
                blocks.append(nn.ModuleList(layers))
                skips.append(ch)
            if level != self.levels - 1:
                blocks.append(nn.ModuleList([ResBlock(ch, ch, emb, groups, prec, down=True)]))
                skips.append(ch)
                ds *= 2
        self.input_blocks = nn.ModuleList(blocks)
        self.middle_block = nn.ModuleList([ResBlock(ch, ch, emb, groups, prec),
                                           AttnBlock(ch, num_heads, groups, prec),
                                           ResBlock(ch, ch, emb, groups, prec)])
        blocks = []
        for level in reversed(range(self.levels)):
            mult = channel_mult[level]
            for i in range(num_res_blocks + 1):
                layers = [ResBlock(ch + skips.pop(), mult * mc, emb, groups, prec)]
                ch = mult * mc
                if ds in attention_resolutions:
                    layers.append(AttnBlock(ch, num_heads, groups, prec))
                if level > 0 and i == num_res_blocks:
                    layers.append(ResBlock(ch, ch, emb, groups, prec, up=True))
                    ds //= 2
                blocks.append(nn.ModuleList(layers))
        self.output_blocks = nn.ModuleList(blocks)
        self.out = nn.ModuleDict({"0": GroupNorm(ch, groups, True),
                                  "2": Conv(ch, channels, 3, prec)})

    @staticmethod
    def _run(layers, h, emb_act):
        for m in layers:
            h = m(h, emb_act) if isinstance(m, ResBlock) else m(h)
        return h

    def forward(self, x, t):
        emb = self.time_embed["2"](F.silu(self.time_embed["0"](timestep_embedding(t, self.mc))))
        emb_act = F.silu(emb)
        h = self.input_blocks[0][0](x)
        hs = [h]
        for layers in self.input_blocks[1:]:
            h = self._run(layers, h, emb_act)
            hs.append(h)
        h = self._run(self.middle_block, h, emb_act)
        for layers in self.output_blocks:
            h = self._run(layers, torch.cat([h, hs.pop()], dim=1), emb_act)
        return self.out["2"](self.out["0"](h))


class Convolution(nn.Module):
    """MONAI's Convolution block: the Conv1d held as ``conv``."""

    def __init__(self, cin, cout, k, prec, stride=1, padding=None):
        super().__init__()
        self.conv = Conv(cin, cout, k, prec, stride, padding)

    def forward(self, x):
        return self.conv(x)


class AEResBlock(nn.Module):
    def __init__(self, cin, cout, groups, prec):
        super().__init__()
        self.norm1 = GroupNorm(cin, groups, True)
        self.conv1 = Convolution(cin, cout, 3, prec)
        self.norm2 = GroupNorm(cout, groups, True)
        self.conv2 = Convolution(cout, cout, 3, prec)
        self.nin_shortcut = Convolution(cin, cout, 1, prec) if cin != cout else None

    def forward(self, x):
        h = self.conv2(self.norm2(self.conv1(self.norm1(x))))
        return (x if self.nin_shortcut is None else self.nin_shortcut(x)) + h


class Down(nn.Module):
    """Right-pad by one, then a stride-2 VALID k=3 convolution."""

    def __init__(self, ch, prec):
        super().__init__()
        self.conv = Convolution(ch, ch, 3, prec, stride=2, padding=0)

    def forward(self, x):
        return self.conv(F.pad(x, (0, 1)))


class Up(nn.Module):
    """Nearest x2, then a k=3 convolution."""

    def __init__(self, ch, prec):
        super().__init__()
        self.conv = Convolution(ch, ch, 3, prec)

    def forward(self, x):
        return self.conv(x.repeat_interleave(2, dim=-1))


def _column(first, chans, in_ch, nrb, groups, resample, last_out, prec):
    blocks, ch = [first], in_ch
    for level, out_ch in enumerate(chans):
        for _ in range(nrb):
            blocks.append(AEResBlock(ch, out_ch, groups, prec))
            ch = out_ch
        if level != len(chans) - 1:
            blocks.append(resample(ch, prec))
    blocks += [GroupNorm(ch, groups, False), Convolution(ch, last_out, 3, prec)]
    return nn.ModuleList(blocks)


class Encoder(nn.Module):
    def __init__(self, chans, latent, nrb, groups, prec):
        super().__init__()
        self.blocks = _column(Convolution(1, chans[0], 3, prec), chans, chans[0], nrb, groups,
                              Down, latent, prec)

    def forward(self, x):
        for b in self.blocks:
            x = b(x)
        return x


class Decoder(nn.Module):
    def __init__(self, chans, latent, nrb, groups, prec):
        super().__init__()
        rev = list(reversed(chans))
        self.blocks = _column(Convolution(latent, rev[0], 3, prec), rev, rev[0], nrb, groups,
                              Up, 1, prec)

    def forward(self, z):
        for b in self.blocks:
            z = b(z)
        return z


class AutoencoderKL(nn.Module):
    """(B, 1, L) windows <-> (B, latent, L / 4) latents, without attention."""

    def __init__(self, num_channels: Sequence[int] = (32, 32, 64), latent_channels: int = 1,
                 num_res_blocks: int = 2, groups: int = 1, prec: Precision | None = None):
        super().__init__()
        prec = prec or Precision()
        self.encoder = Encoder(num_channels, latent_channels, num_res_blocks, groups, prec)
        self.decoder = Decoder(num_channels, latent_channels, num_res_blocks, groups, prec)
        self.quant_conv_mu = Convolution(latent_channels, latent_channels, 1, prec)
        self.quant_conv_log_sigma = Convolution(latent_channels, latent_channels, 1, prec)
        self.post_quant_conv = Convolution(latent_channels, latent_channels, 1, prec)

    def posterior_sample(self, x, eps):
        """z_mu + eps * exp(log_var / 2), the log-variance clamped to [-30, 20]."""
        h = self.encoder(x)
        z_mu = self.quant_conv_mu(h)
        sigma = torch.exp(0.5 * self.quant_conv_log_sigma(h).clamp(-30.0, 20.0))
        return z_mu + eps * sigma

    def decode(self, z):
        return self.decoder(self.post_quant_conv(z))


def groupnorm_params(model: nn.Module) -> set:
    """Names of every GroupNorm parameter of ``model``."""
    return {f"{m_name}.{p}" for m_name, m in model.named_modules()
            if isinstance(m, GroupNorm) for p in ("weight", "bias")}
