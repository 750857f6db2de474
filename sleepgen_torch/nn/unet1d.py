"""1-D diffusion UNet in torch's (B, C, L) layout.

Counterpart of ``sleepgen/nn/unet1d.py`` (reference ``UNetModel``; the
LDM configuration is model_channels 128, channel_mult [1, 2, 4], two
resblocks per level, attention at ds 4 and in the middle, one head,
resblocks that resample, no scale-shift norm). Submodules carry the
reference UNetModel's names (``time_embed.0``, ``input_blocks.1.0.in_layers.2``,
...), so state dicts of ``sleepgen.utils.torch_export.export_unet1d`` load
with ``strict=True``.

Every option of the JAX UNet is built:

* ``use_scale_shift_norm``: ``emb_layers.1`` gives 2 x out channels, split
  scale first, then shift; chain 2 is GroupNorm without SiLU (K1,
  ``silu=False``), ``h * (1 + scale) + shift``, SiLU and the convolution.
* ``resblock_updown=False``: resampling leaves the resblocks. With
  ``conv_resample`` a level ends in a stride-2 k=3 convolution
  (``input_blocks.N.0.op``) padded as flax's SAME, (0, 1) on an even
  length, and the way up in a nearest upsample and a k=3 convolution
  (``output_blocks.N.M.conv``); without it, a parameter-free average pool
  and a nearest upsample alone.
* ``dropout`` is accepted and inert, as in the JAX package, whose train
  steps never pass ``deterministic=False`` or a dropout key to the UNet
  (``sleepgen/train/train_ldm.py``, ``train_dm.py``): no mask is drawn.
* ``fast_math``: the JAX package's ``fast_sampling_math`` /
  ``fast_train_math``, on the attention only (``layers.set_fast_math``).

When no gradient is needed (the sampler, evals), every resblock
GroupNorm -> SiLU -> Conv1d(k=3) chain runs as kernel K2: chain 1 when the
block does not resample (every block without ``resblock_updown``), chain
2 unless the norm scales and shifts. The up/down chain 1, a scale-shift
chain 2, the attention norms and the output norm run kernel K1. In
training the chains run ``GroupNorm32`` (K1 forward, K3 backward) and then
the convolution, as K2 has no backward.

``quantized`` builds the int8 sampling UNet (``nn/quant.py``): every
resblock convolution, ``conv_in``, ``conv_out`` and the attention
projections become ``QuantConv1d``, loaded from
``quant.quantize_unet_params`` of a trained state dict. Its resblock chains
then run GroupNorm32 (K1) and the int8 convolution, never K2.
``kv_block_size`` is the JAX package's long-window attention option: the
UNet refuses a block that does not divide each of its attention lengths
before it runs anything (``check_kv_block``), and its attention is one
``scaled_dot_product_attention`` call at lengths past K5's
(``kernels/attention.py``); without the option, a bf16 sampling UNet's
attention runs K5 on the card.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from sleepgen_torch.kernels.fused_resblock import gn_silu_conv3, needs_grad
from sleepgen_torch.nn.discriminator import SameConv1d
from sleepgen_torch.nn.layers import (AttentionBlock1d, GroupNorm32, cast_compute_dtype,
                                      check_kv_block, conv1d, set_fast_math,
                                      timestep_embedding)
from sleepgen_torch.nn.quant import QuantConv1d, quantize_unet_params
from sleepgen_torch.utils.profiling import span


def _chain(norm: GroupNorm32, conv: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """conv(SiLU(norm(x))): one K2 call when autograd needs no gradient,
    else (and always for an int8 ``QuantConv1d``) GroupNorm32 then the
    convolution. K2 takes contiguous inputs
    (cuDNN may hand back strided convolution outputs). Under autocast the
    weight is an fp32 master: it goes to K2 as the parameter itself, which
    keys K2's cache of its re-layout, and the bias is cast to x's dtype."""
    if isinstance(conv, QuantConv1d) or needs_grad(x, norm.weight, norm.bias, conv.weight,
                                                    conv.bias):
        return conv(norm(x))
    return gn_silu_conv3(x.contiguous(), norm.weight, norm.bias, conv.weight,
                         conv.bias.to(x.dtype), norm.num_groups, norm.eps)


class TimestepResBlock(nn.Module):
    """Resblock with an additive (or, with ``scale_shift``, a scale-shift)
    timestep embedding and optional built-in nearest-upsample (``up``) or
    average-pool (``down``) of both h and x after the first norm.
    ModuleDict keys keep the reference's Sequential indices (in_layers.0
    norm, in_layers.2 conv, emb_layers.1 linear, out_layers.0 norm,
    out_layers.3 conv)."""

    def __init__(self, in_channels: int, out_channels: int, emb_channels: int,
                 num_groups: int = 32, up: bool = False, down: bool = False, conv=conv1d,
                 scale_shift: bool = False):
        super().__init__()
        self.up, self.down, self.scale_shift = up, down, scale_shift
        self.in_layers = nn.ModuleDict({
            "0": GroupNorm32(in_channels, num_groups, fuse_silu=True),
            "2": conv(in_channels, out_channels, 3)})
        self.emb_layers = nn.ModuleDict({
            "1": nn.Linear(emb_channels, (2 if scale_shift else 1) * out_channels)})
        self.out_layers = nn.ModuleDict({
            "0": GroupNorm32(out_channels, num_groups, fuse_silu=not scale_shift),
            "3": conv(out_channels, out_channels, 3)})
        self.skip_connection = (conv(in_channels, out_channels, 1)
                                if in_channels != out_channels else None)

    def forward(self, x: torch.Tensor, emb_act: torch.Tensor) -> torch.Tensor:
        """x (B, C_in, L); emb_act = SiLU(emb), (B, emb_channels)."""
        norm1, conv1 = self.in_layers["0"], self.in_layers["2"]
        if self.up or self.down:
            h = norm1(x)
            if self.up:
                h, x = h.repeat_interleave(2, dim=-1), x.repeat_interleave(2, dim=-1)
            else:
                h, x = F.avg_pool1d(h, 2), F.avg_pool1d(x, 2)
            h = conv1(h)
        else:
            h = _chain(norm1, conv1, x)
        emb_out = self.emb_layers["1"](emb_act)[:, :, None]
        norm2, conv2 = self.out_layers["0"], self.out_layers["3"]
        if self.scale_shift:
            scale, shift = emb_out.chunk(2, dim=1)
            h = conv2(F.silu(norm2(h) * (1 + scale) + shift))
        else:
            h = _chain(norm2, conv2, h + emb_out)
        if self.skip_connection is not None:
            x = self.skip_connection(x)
        return x + h


class Downsample(nn.Module):
    """The reference UNet's Downsample: a stride-2 k=3 convolution ``op``
    with flax's SAME padding, or (``use_conv=False``) a 2-wide average
    pool without parameters."""

    def __init__(self, channels: int, use_conv: bool = True):
        super().__init__()
        self.op = SameConv1d(channels, channels, 3, stride=2) if use_conv else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.op(x) if self.op is not None else F.avg_pool1d(x, 2)


class Upsample(nn.Module):
    """The reference UNet's Upsample: nearest x2 along L, then (with
    ``use_conv``) a k=3 convolution ``conv``."""

    def __init__(self, channels: int, use_conv: bool = True):
        super().__init__()
        self.conv = conv1d(channels, channels, 3) if use_conv else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.repeat_interleave(2, dim=-1)
        return self.conv(x) if self.conv is not None else x


class UNet1d(nn.Module):
    """Diffusion UNet: (B, in_channels, L) noisy latent and (B,) timesteps
    (and (B,) labels when ``num_classes`` > 0; a label < 0 is the
    classifier-free-guidance null label) -> (B, out_channels, L) fp32.
    The options are the JAX UNet's (module docstring)."""

    def __init__(self, in_channels: int = 1, out_channels: int = 1,
                 model_channels: int = 128, channel_mult: Sequence[int] = (1, 2, 4),
                 num_res_blocks: int = 2, attention_resolutions: Sequence[int] = (8, 4),
                 num_heads: int = 1, num_groups: int = 32, num_classes: int = 0,
                 resblock_updown: bool = True, use_scale_shift_norm: bool = False,
                 conv_resample: bool = True, dropout: float = 0.0, kv_block_size: int = 0,
                 quantized: bool = False, fast_math: bool = True):
        super().__init__()
        self.config = dict(in_channels=in_channels, out_channels=out_channels,
                           model_channels=model_channels, channel_mult=tuple(channel_mult),
                           num_res_blocks=num_res_blocks,
                           attention_resolutions=tuple(attention_resolutions),
                           num_heads=num_heads, num_groups=num_groups, num_classes=num_classes,
                           resblock_updown=resblock_updown,
                           use_scale_shift_norm=use_scale_shift_norm,
                           conv_resample=conv_resample, dropout=dropout,
                           kv_block_size=kv_block_size, quantized=quantized,
                           fast_math=fast_math)
        if quantized and not resblock_updown:
            # the JAX package's int8 UNet cannot load this either: it keeps
            # the stride-2 downsample float while quantize_unet_params
            # converts its kernel
            raise NotImplementedError("int8 sampling needs resblock_updown=True: the "
                                      "stride-2 downsample has no int8 form")
        conv = QuantConv1d if quantized else conv1d
        mc = model_channels
        emb_ch = 4 * mc
        levels = len(channel_mult)
        self.model_channels = mc
        self.levels = levels
        self.num_classes = num_classes
        self.kv_block_size = kv_block_size
        self.attention_ds = []  # each attention block's downsampling, in forward order
        self.time_embed = nn.ModuleDict({"0": nn.Linear(mc, emb_ch),
                                         "2": nn.Linear(emb_ch, emb_ch)})
        if num_classes:
            self.label_emb = nn.Embedding(num_classes, emb_ch)

        def res(cin, cout, **kw):
            return TimestepResBlock(cin, cout, emb_ch, num_groups, conv=conv,
                                    scale_shift=use_scale_shift_norm, **kw)

        def attn(ch, ds):
            self.attention_ds.append(ds)
            return AttentionBlock1d(ch, num_heads, num_groups, conv=conv)

        blocks = [nn.ModuleList([conv(in_channels, mc, 3)])]
        skip_chans = [mc]
        ch, ds = mc, 1
        for level, mult in enumerate(channel_mult):
            for _ in range(num_res_blocks):
                layers = [res(ch, mult * mc)]
                ch = mult * mc
                if ds in attention_resolutions:
                    layers.append(attn(ch, ds))
                blocks.append(nn.ModuleList(layers))
                skip_chans.append(ch)
            if level != levels - 1:
                blocks.append(nn.ModuleList([res(ch, ch, down=True) if resblock_updown
                                             else Downsample(ch, conv_resample)]))
                skip_chans.append(ch)
                ds *= 2
        self.input_blocks = nn.ModuleList(blocks)
        self.middle_block = nn.ModuleList([res(ch, ch), attn(ch, ds), res(ch, ch)])
        blocks = []
        for level in reversed(range(levels)):
            mult = channel_mult[level]
            for i in range(num_res_blocks + 1):
                layers = [res(ch + skip_chans.pop(), mult * mc)]
                ch = mult * mc
                if ds in attention_resolutions:
                    layers.append(attn(ch, ds))
                if level > 0 and i == num_res_blocks:
                    layers.append(res(ch, ch, up=True) if resblock_updown
                                  else Upsample(ch, conv_resample))
                    ds //= 2
                blocks.append(nn.ModuleList(layers))
        self.output_blocks = nn.ModuleList(blocks)
        self.out = nn.ModuleDict({"0": GroupNorm32(ch, num_groups, fuse_silu=True),
                                  "2": conv(ch, out_channels, 3)})
        set_fast_math(self, fast_math)

    @staticmethod
    def _run(layers: nn.ModuleList, h: torch.Tensor, emb_act: torch.Tensor) -> torch.Tensor:
        for m in layers:
            h = m(h, emb_act) if isinstance(m, TimestepResBlock) else m(h)
        return h

    def forward(self, x: torch.Tensor, timesteps: torch.Tensor,
                y: torch.Tensor | None = None) -> torch.Tensor:
        with span("unet.forward"):
            return self._forward(x, timesteps, y)

    def _forward(self, x: torch.Tensor, timesteps: torch.Tensor,
                 y: torch.Tensor | None) -> torch.Tensor:
        if x.shape[-1] % 2 ** (self.levels - 1):
            raise ValueError(f"length {x.shape[-1]} must divide 2**{self.levels - 1}")
        for ds in self.attention_ds:
            check_kv_block(x.shape[-1] // ds, self.kv_block_size)
        conv_in = self.input_blocks[0][0]
        dtype = self.time_embed["0"].weight.dtype
        t_emb = timestep_embedding(timesteps, self.model_channels).to(dtype)
        emb = self.time_embed["2"](F.silu(self.time_embed["0"](t_emb)))
        if self.num_classes:
            if y is None:
                raise ValueError("class-conditional model needs labels y")
            l_emb = self.label_emb(y.clamp(min=0))
            emb = emb + torch.where((y >= 0)[:, None], l_emb, torch.zeros_like(l_emb))
        emb_act = F.silu(emb)

        h = conv_in(x.to(dtype))
        hs = [h]
        for layers in self.input_blocks[1:]:
            h = self._run(layers, h, emb_act)
            hs.append(h)
        h = self._run(self.middle_block, h, emb_act)
        for layers in self.output_blocks:
            h = self._run(layers, torch.cat([h, hs.pop()], dim=1), emb_act)
        return self.out["2"](self.out["0"](h)).float()


def quantize_unet(unet: UNet1d) -> UNet1d:
    """The int8 sampling copy of a trained ``unet`` (fp32 weights, as the
    JAX package quantizes its fp32 parameters), on the same device, in eval
    mode, its linear layers in ``unet``'s compute dtype, its attention on
    the strict path (the JAX package's int8 UNet never takes fast_math). A
    UNet that is already quantized is returned as it is; any other
    denoiser raises ValueError (the int8 path quantizes UNet convolutions
    only)."""
    if not isinstance(unet, UNet1d):
        raise ValueError(f"int8 sampling quantizes UNet1d convolutions only; "
                         f"a {type(unet).__name__} has no int8 path")
    if unet.config["quantized"]:
        return unet
    dtype = unet.time_embed["0"].weight.dtype
    state = quantize_unet_params({k: v.float() for k, v in unet.state_dict().items()})
    with torch.device(unet.time_embed["0"].weight.device):
        q = UNet1d(**{**unet.config, "quantized": True, "fast_math": False})
    q.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()}, strict=True)
    return cast_compute_dtype(q.eval(), dtype)
