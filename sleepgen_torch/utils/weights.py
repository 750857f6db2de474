"""Weights across the two packages, and seeded random weights.

``unet_state_from_jax`` and ``aekl_state_from_jax`` map a flax parameter
tree of numpy arrays (as the JAX package's ``UNet1d`` and
``AutoencoderKL`` hold them) to the port's ``state_dict`` names, which are
the reference UNetModel's and MONAI's; ``unet_state_to_jax`` and
``aekl_state_to_jax`` map them back, so the run dirs the port trains hold
the JAX package's keys. ``aekl_v1_state_from_jax`` and
``aekl_v1_state_to_jax`` do the same for the first-generation
``AutoencoderKLV1`` under the reference's own names (``encoder.blocks.N``,
which ``sleepgen.utils.torch_import.import_aekl_v1`` reads back; its
fused qkv convs become three, ``q``, ``k`` and ``v``).
``discriminator_state_from_jax`` maps a
``PatchDiscriminator``'s ``params`` and ``batch_stats``
(``discriminator_v1_state_from_jax`` a ``DiscriminatorV1``'s), and
``usleep_state_from_jax`` a ``USleep``'s to braindecode's names (those
of the reference's pretrained USleep). Conventions: conv
kernel (k, in, out) -> weight (out, in, k); Dense kernel (in, out) ->
weight (out, in); GroupNorm and BatchNorm scale/bias -> weight/bias;
BatchNorm mean/var -> running_mean/running_var; Embed embedding -> weight.
The tree's structure (levels, resblocks per level, attention) is read
from its keys, each model's layout by one walk that both directions use.

``chambon_state_from_jax``, ``chambon_sequence_state_from_jax`` and
``deepsleepnet_state_from_jax`` map the sleep stagers' flax variables
(``params`` and ``batch_stats``) to the port's decoders: braindecode's
names for the two Chambon models (which
``sleepgen.utils.torch_import.import_chambon`` and
``import_chambon_sequence`` read back), the JAX module's for DeepSleepNet,
whose four ``OptimizedLSTMCell``s become two bidirectional ``nn.LSTM``s.

``denoiser_state_to_tree`` and ``denoiser_state_from_tree`` choose by the
stage-2 denoiser: the UNet's JAX keys, or a DiT's own names as a tree.

``lecun_normal_state`` draws initial weights with numpy with the JAX
package's initialisers: the trainers call it for the AEKL, the
discriminator (BatchNorm buffers included) and, through
``init_unet_state`` (``train/train_ldm.py``), the UNet.
``flax_init_state`` adds flax's orthogonal recurrent kernels, for the
decoders.

A JAX run dir becomes a port run dir through a flat ``'/'``-keyed
``params.npz`` (``save_params_npz`` / ``load_params_npz``); the export
recipe is in the README.
"""
from __future__ import annotations

import math
import re
from pathlib import Path
from typing import Any, Callable, Dict, Iterator, Mapping, Sequence, Tuple

import numpy as np
import torch

Tree = Mapping[str, Any]
Layers = Iterator[Tuple[str, str, Tuple[str, ...]]]
# flax's lecun_normal: a normal truncated at two standard deviations,
# divided by the truncated normal's own standard deviation.
TRUNCATED_NORMAL_STD = 0.87962566103423978


def _params(tree: Tree) -> Tree:
    return tree["params"] if "params" in tree else tree


def _conv(sd: Dict[str, np.ndarray], prefix: str, node: Tree) -> None:
    sd[f"{prefix}.weight"] = np.ascontiguousarray(
        np.asarray(node["kernel"], np.float32).transpose(2, 1, 0))
    if "bias" in node:
        sd[f"{prefix}.bias"] = np.asarray(node["bias"], np.float32)


def _dense(sd, prefix, node) -> None:
    sd[f"{prefix}.weight"] = np.ascontiguousarray(np.asarray(node["kernel"], np.float32).T)
    sd[f"{prefix}.bias"] = np.asarray(node["bias"], np.float32)


def _gn(sd, prefix, node) -> None:
    sd[f"{prefix}.weight"] = np.asarray(node["GroupNorm_0"]["scale"], np.float32)
    sd[f"{prefix}.bias"] = np.asarray(node["GroupNorm_0"]["bias"], np.float32)


def _count(p: Tree, fmt: str) -> int:
    n = 0
    while fmt.format(n) in p:
        n += 1
    return n


def _unet_layers(levels: int, nrb: int, has: Callable[[str, str], bool]) -> Layers:
    """(kind, port prefix, flax path) of every layer of a UNet1d with
    ``levels`` levels and ``nrb`` resblocks per level, in order; kind is
    conv, dense, gn or embed. ``has(flax name, port prefix)`` says whether
    an optional layer (attention, a skip conv, the label embedding, a
    resampling resblock, or else a resampling conv) is there. Both
    directions of the bridge walk this one layout."""

    def res(port, name):
        yield "gn", f"{port}.in_layers.0", (name, "GroupNorm32_0")
        yield "conv", f"{port}.in_layers.2", (name, "in_conv")
        yield "dense", f"{port}.emb_layers.1", (name, "emb_proj")
        yield "gn", f"{port}.out_layers.0", (name, "GroupNorm32_1")
        yield "conv", f"{port}.out_layers.3", (name, "out_conv")
        if has(f"{name}/skip_conv", f"{port}.skip_connection"):
            yield "conv", f"{port}.skip_connection", (name, "skip_conv")

    def attn(port, name):
        yield "gn", f"{port}.norm", (name, "GroupNorm32_0")
        yield "conv", f"{port}.qkv", (name, "SelfAttention1d_0", "qkv")
        yield "conv", f"{port}.proj_out", (name, "SelfAttention1d_0", "proj_out")

    yield "dense", "time_embed.0", ("time_dense_1",)
    yield "dense", "time_embed.2", ("time_dense_2",)
    if has("label_emb", "label_emb"):
        yield "embed", "label_emb", ("label_emb",)
    yield "conv", "input_blocks.0.0", ("conv_in",)
    blk = 1
    for level in range(levels):
        for i in range(nrb):
            yield from res(f"input_blocks.{blk}.0", f"down_{level}_res_{i}")
            if has(f"down_{level}_attn_{i}", f"input_blocks.{blk}.1"):
                yield from attn(f"input_blocks.{blk}.1", f"down_{level}_attn_{i}")
            blk += 1
        if level != levels - 1:
            if has(f"down_{level}_downres", f"input_blocks.{blk}.0.in_layers.0"):
                yield from res(f"input_blocks.{blk}.0", f"down_{level}_downres")
            elif has(f"down_{level}_downconv", f"input_blocks.{blk}.0.op"):
                yield "conv", f"input_blocks.{blk}.0.op", (f"down_{level}_downconv",)
            blk += 1
    yield from res("middle_block.0", "mid_res_1")
    yield from attn("middle_block.1", "mid_attn")
    yield from res("middle_block.2", "mid_res_2")
    blk = 0
    for level in reversed(range(levels)):
        for i in range(nrb + 1):
            yield from res(f"output_blocks.{blk}.0", f"up_{level}_res_{i}")
            nxt = 1
            if has(f"up_{level}_attn_{i}", f"output_blocks.{blk}.1"):
                yield from attn(f"output_blocks.{blk}.1", f"up_{level}_attn_{i}")
                nxt = 2
            if level > 0 and i == nrb:
                if has(f"up_{level}_upres", f"output_blocks.{blk}.{nxt}.in_layers.0"):
                    yield from res(f"output_blocks.{blk}.{nxt}", f"up_{level}_upres")
                elif has(f"up_{level}_upconv", f"output_blocks.{blk}.{nxt}.conv"):
                    yield "conv", f"output_blocks.{blk}.{nxt}.conv", (f"up_{level}_upconv",)
            blk += 1
    yield "gn", "out.0", ("GroupNorm32_0",)
    yield "conv", "out.2", ("conv_out",)


def _node(tree: Tree, path) -> Any:
    for part in path:
        tree = tree[part]
    return tree


def _numpy_state(state: Mapping[str, Any]) -> Dict[str, np.ndarray]:
    return {k: (v.detach().cpu().numpy() if torch.is_tensor(v) else np.asarray(v))
            for k, v in state.items()}


def _has_node(p: Tree) -> Callable[[str, str], bool]:
    def has(name, _port):
        try:
            _node(p, name.split("/"))
            return True
        except KeyError:
            return False
    return has


def _split_qkv(sd, prefix, node) -> None:
    """A fused 1x1 qkv conv (1, C, 3C) -> three convs ``q``, ``k``, ``v``."""
    kernel, bias = np.asarray(node["kernel"], np.float32), np.asarray(node["bias"], np.float32)
    c = kernel.shape[-1] // 3
    for i, name in enumerate("qkv"):
        _conv(sd, f"{prefix}.{name}", {"kernel": kernel[..., i * c:(i + 1) * c],
                                       "bias": bias[i * c:(i + 1) * c]})


def _linear1x1(sd, prefix, node) -> None:
    """A 1x1 conv (1, C_in, C_out) -> a linear weight (C_out, C_in)."""
    sd[f"{prefix}.weight"] = np.ascontiguousarray(np.asarray(node["kernel"], np.float32)[0].T)
    sd[f"{prefix}.bias"] = np.asarray(node["bias"], np.float32)


def _split_qkv_linear(sd, prefix, node) -> None:
    """A fused 1x1 qkv conv (1, C, 3C) -> MONAI's three linear layers
    ``to_q``, ``to_k``, ``to_v``."""
    kernel, bias = np.asarray(node["kernel"], np.float32), np.asarray(node["bias"], np.float32)
    c = kernel.shape[-1] // 3
    for i, name in enumerate(("to_q", "to_k", "to_v")):
        _linear1x1(sd, f"{prefix}.{name}", {"kernel": kernel[..., i * c:(i + 1) * c],
                                            "bias": bias[i * c:(i + 1) * c]})


def _state_from_tree(p: Tree, layers: Layers) -> Dict[str, np.ndarray]:
    sd: Dict[str, np.ndarray] = {}
    convert = {"conv": _conv, "dense": _dense, "gn": _gn, "qkv": _split_qkv,
               "qkv_linear": _split_qkv_linear, "linear1x1": _linear1x1}
    for kind, port, path in layers:
        if kind == "embed":
            sd[f"{port}.weight"] = np.asarray(_node(p, path)["embedding"], np.float32)
        else:
            convert[kind](sd, port, _node(p, path))
    return sd


def _as_conv_weight(w: np.ndarray) -> np.ndarray:
    """A conv weight (C_out, C_in, k), or a linear weight (C_out, C_in) as
    a 1x1 conv's, in fp32."""
    w = np.asarray(w, np.float32)
    return w[:, :, None] if w.ndim == 2 else w


def _tree_from_state(sd: Mapping[str, np.ndarray], layers: Layers) -> Dict[str, Any]:
    tree: Dict[str, Any] = {}
    for kind, port, path in layers:
        node = tree
        for part in path:
            node = node.setdefault(part, {})
        if kind in ("qkv", "qkv_linear"):  # three convs or linears -> one fused qkv
            names = tuple("qkv") if kind == "qkv" else ("to_q", "to_k", "to_v")
            node["kernel"] = np.concatenate(
                [_as_conv_weight(sd[f"{port}.{n}.weight"]).transpose(2, 1, 0) for n in names],
                axis=-1)
            node["bias"] = np.concatenate([sd[f"{port}.{n}.bias"].astype(np.float32)
                                           for n in names])
            continue
        w = sd[f"{port}.weight"].astype(np.float32)
        if kind == "linear1x1":
            node["kernel"] = np.ascontiguousarray(_as_conv_weight(w).transpose(2, 1, 0))
            node["bias"] = sd[f"{port}.bias"].astype(np.float32)
            continue
        if kind == "embed":
            node["embedding"] = w
            continue
        b = sd[f"{port}.bias"].astype(np.float32)
        if kind == "gn":
            node["GroupNorm_0"] = {"scale": w, "bias": b}
        else:
            node["kernel"] = np.ascontiguousarray(w.transpose(2, 1, 0) if kind == "conv" else w.T)
            node["bias"] = b
    return tree


def unet_state_from_jax(tree: Tree) -> Dict[str, np.ndarray]:
    """JAX ``UNet1d`` params -> the port's ``UNet1d`` state_dict (numpy)."""
    p = _params(tree)
    return _state_from_tree(p, _unet_layers(_count(p, "down_{}_res_0"),
                                            _count(p, "down_0_res_{}"), _has_node(p)))


def unet_state_to_jax(state: Mapping[str, Any]) -> Dict[str, Any]:
    """The port's ``UNet1d`` state_dict (numpy arrays or tensors) -> the JAX
    ``UNet1d`` params tree (nested dicts of fp32 numpy arrays), the inverse
    of ``unet_state_from_jax``: a run dir the port trains samples with
    either package."""
    sd = _numpy_state(state)

    def blocks(pattern):
        return {k.split(".")[1] for k in sd if re.fullmatch(pattern, k)}

    # resblocks that resample (one per level boundary), or else resampling
    # layers outside the resblocks: then the input column has one resblock
    # fewer than the output column per level
    ups = blocks(r"output_blocks\.\d+\.[12]\.in_layers\.0\.weight")
    n_out = len(blocks(r"output_blocks\.\d+\..*"))
    n_in_res = len(blocks(r"input_blocks\.\d+\.0\.in_layers\.0\.weight"))
    levels = len(ups) + 1 if ups else n_out - n_in_res
    nrb = n_out // levels - 1

    def has(_name, port):
        return f"{port}.weight" in sd or f"{port}.qkv.weight" in sd

    return _tree_from_state(sd, _unet_layers(levels, nrb, has))


def denoiser_state_to_tree(denoiser: str, state: Mapping[str, Any]) -> Dict[str, Any]:
    """A stage-2 denoiser's state dict -> the parameter tree of its run dir:
    a UNet's in the JAX package's keys (``unet_state_to_jax``); a DiT, which
    the JAX package lacks, under its own names split at the dots
    (``blocks/0/attn/qkv/weight``)."""
    if denoiser != "dit":
        return unet_state_to_jax(state)
    tree: Dict[str, Any] = {}
    for name, v in _numpy_state(state).items():
        *parents, leaf = name.split(".")
        node = tree
        for part in parents:
            node = node.setdefault(part, {})
        node[leaf] = v
    return tree


def denoiser_state_from_tree(denoiser: str, tree: Tree) -> Dict[str, np.ndarray]:
    """The inverse of ``denoiser_state_to_tree``."""
    if denoiser != "dit":
        return unet_state_from_jax(tree)
    sd: Dict[str, np.ndarray] = {}

    def walk(node: Tree, prefix: str) -> None:
        for k, v in node.items():
            if isinstance(v, Mapping):
                walk(v, f"{prefix}{k}.")
            else:
                sd[prefix + k] = np.asarray(v)

    walk(_params(tree), "")
    return sd


def _aekl_layers(shape: Callable[[str, str], Tuple[int, int]],
                 has: Callable[[str, str], bool]) -> Layers:
    """(kind, port prefix, flax path) of every layer of an AutoencoderKL, in
    order; kind is conv, gn, qkv_linear or linear1x1. ``shape(side, tag)``
    gives a column's (levels, resblocks per level); ``has(flax name, port
    prefix)`` says whether a resblock has its 1x1 shortcut and whether an
    attention block is there (an attention level's, or the non-local
    ``mid_attn``). MONAI's block list: conv_in, [mid], the resblocks, each
    followed by its attention on an attention level, with a resampling conv
    between levels, [mid], norm_out, conv_out; the mid block (resblock,
    attention, resblock) comes first in the decoder, last in the
    encoder."""
    def res(side, name, port):
        yield "gn", f"{port}.norm1", (side, name, "GroupNorm32_0")
        yield "conv", f"{port}.conv1.conv", (side, name, "conv1")
        yield "gn", f"{port}.norm2", (side, name, "GroupNorm32_1")
        yield "conv", f"{port}.conv2.conv", (side, name, "conv2")
        if has(f"{side}/{name}/nin_shortcut", f"{port}.nin_shortcut.conv"):
            yield "conv", f"{port}.nin_shortcut.conv", (side, name, "nin_shortcut")

    def attn(side, name, port):
        yield "gn", f"{port}.norm", (side, name, "GroupNorm32_0")
        yield "qkv_linear", port, (side, name, "SelfAttention1d_0", "qkv")
        yield "linear1x1", f"{port}.proj_attn", (side, name, "SelfAttention1d_0", "proj_out")

    def mid(side, pre, b):
        yield from res(side, "mid_res_1", f"{pre}.{b}")
        yield from attn(side, "mid_attn", f"{pre}.{b + 1}")
        yield from res(side, "mid_res_2", f"{pre}.{b + 2}")

    for side, tag, resample in (("encoder", "down", "downsample"),
                                ("decoder", "up", "upsample")):
        levels, nrb = shape(side, tag)
        pre = f"{side}.blocks"
        has_mid = has(f"{side}/mid_attn", side)
        yield "conv", f"{pre}.0.conv", (side, "conv_in")
        b = 1
        if has_mid and side == "decoder":
            yield from mid(side, pre, b)
            b += 3
        for i in range(levels):
            for j in range(nrb):
                yield from res(side, f"{tag}_{i}_res_{j}", f"{pre}.{b}")
                b += 1
                if has(f"{side}/{tag}_{i}_attn_{j}", f"{pre}.{b}.norm"):
                    yield from attn(side, f"{tag}_{i}_attn_{j}", f"{pre}.{b}")
                    b += 1
            if i != levels - 1:
                yield "conv", f"{pre}.{b}.conv.conv", (side, f"{tag}_{i}_{resample}", "conv")
                b += 1
        if has_mid and side == "encoder":
            yield from mid(side, pre, b)
            b += 3
        yield "gn", f"{pre}.{b}", (side, "norm_out")
        yield "conv", f"{pre}.{b + 1}.conv", (side, "conv_out")
    for name in ("quant_conv_mu", "quant_conv_log_sigma", "post_quant_conv"):
        yield "conv", f"{name}.conv", (name,)


def aekl_state_from_jax(tree: Tree) -> Dict[str, np.ndarray]:
    """JAX ``AutoencoderKL`` params -> the port's state_dict (numpy)."""
    p = _params(tree)

    def shape(side, tag):
        return _count(p[side], tag + "_{}_res_0"), _count(p[side], tag + "_0_res_{}")

    return _state_from_tree(p, _aekl_layers(shape, _has_node(p)))


def aekl_state_to_jax(state: Mapping[str, Any]) -> Dict[str, Any]:
    """The port's ``AutoencoderKL`` state_dict (numpy arrays or tensors) ->
    the JAX ``AutoencoderKL`` params tree, the inverse of
    ``aekl_state_from_jax``: a stage-1 run dir the port trains is what
    ``train-ldm --best_model_path`` and ``sample`` read."""
    sd = _numpy_state(state)

    def kinds(side):
        """Each block's kind, in order."""
        out = []
        while True:
            p = f"{side}.blocks.{len(out)}"
            for kind, key in (("res", "norm1.weight"), ("attn", "norm.weight"),
                              ("resample", "conv.conv.weight"), ("conv", "conv.weight"),
                              ("norm", "weight")):
                if f"{p}.{key}" in sd:
                    out.append(kind)
                    break
            else:
                return out

    enc, dec = kinds("encoder"), kinds("decoder")
    levels = enc.count("resample") + 1  # a resampling conv between levels
    # the encoder's non-local block is the last resblock, attention,
    # resblock; an encoder level with attention ends in an attention block
    mid = {"encoder": enc[-5:-2] == ["res", "attn", "res"]}
    nrb = (enc.count("res") - 2 * mid["encoder"]) // levels
    mid["decoder"] = dec.count("res") > levels * nrb

    def has(name, port):
        if name.endswith("/mid_attn"):
            return mid[port]
        return f"{port}.weight" in sd

    return _tree_from_state(sd, _aekl_layers(lambda side, tag: (levels, nrb), has))


def _aekl_v1_layers(levels: int, nrb: int, has: Callable[[str, str], bool]) -> Layers:
    """(kind, port prefix, flax path) of every layer of an AutoencoderKLV1
    with ``levels`` levels and ``nrb`` resblocks per level, in the
    reference's flat block order (the walk of
    ``sleepgen.utils.torch_import.import_aekl_v1``); kind is conv, gn or
    qkv (a fused qkv conv, three convs in the port). ``has(flax name, port
    prefix)`` says whether an optional layer (a per-resolution attention
    block, a 1x1 shortcut) is there."""

    def column(side: str):
        pre, b = f"{side}.blocks", 0

        def block():
            nonlocal b
            b += 1
            return f"{pre}.{b - 1}"

        def res(name):
            port = block()
            yield "gn", f"{port}.norm1", (side, name, "GroupNorm32_0")
            yield "conv", f"{port}.conv1", (side, name, "conv1")
            yield "gn", f"{port}.norm2", (side, name, "GroupNorm32_1")
            yield "conv", f"{port}.conv2", (side, name, "conv2")
            if has(f"{side}/{name}/nin_shortcut", f"{port}.nin_shortcut"):
                yield "conv", f"{port}.nin_shortcut", (side, name, "nin_shortcut")

        def attn(name, optional=True):
            if optional and not has(f"{side}/{name}", f"{pre}.{b}.q"):
                return
            port = block()
            yield "gn", f"{port}.norm", (side, name, "GroupNorm32_0")
            yield "qkv", port, (side, name, "SelfAttention1d_0", "qkv")
            yield "conv", f"{port}.proj_out", (side, name, "SelfAttention1d_0", "proj_out")

        def middle():
            yield from res("mid_res_1")
            yield from attn("mid_attn", optional=False)
            yield from res("mid_res_2")

        yield "conv", block(), (side, "conv_in")
        if side == "decoder":
            yield from middle()
        tag, resample = ("down", "downsample") if side == "encoder" else ("up", "upsample")
        order = range(levels) if side == "encoder" else reversed(range(levels))
        for i in order:
            for j in range(nrb):
                yield from res(f"{tag}_{i}_res_{j}")
                yield from attn(f"{tag}_{i}_attn_{j}")
            if i != (levels - 1 if side == "encoder" else 0):
                yield "conv", f"{block()}.conv", (side, f"{tag}_{i}_{resample}", "conv")
        if side == "encoder":
            yield from middle()
        yield "gn", block(), (side, "norm_out")
        yield "conv", block(), (side, "conv_out")

    yield from column("encoder")
    yield from column("decoder")
    for name in ("quant_conv_mu", "quant_conv_log_sigma", "post_quant_conv"):
        yield "conv", name, (name,)


def aekl_v1_state_from_jax(tree: Tree) -> Dict[str, np.ndarray]:
    """JAX ``AutoencoderKLV1`` params -> the port's state_dict (numpy), in
    the reference's names."""
    p = _params(tree)
    enc = p["encoder"]
    return _state_from_tree(p, _aekl_v1_layers(_count(enc, "down_{}_res_0"),
                                               _count(enc, "down_0_res_{}"), _has_node(p)))


def aekl_v1_state_to_jax(state: Mapping[str, Any]) -> Dict[str, Any]:
    """The port's ``AutoencoderKLV1`` state_dict (numpy arrays or tensors)
    -> the JAX ``AutoencoderKLV1`` params tree, the inverse of
    ``aekl_v1_state_from_jax``."""
    sd = _numpy_state(state)

    def n(pattern):
        return sum(bool(re.fullmatch(rf"encoder\.blocks\.\d+\.{pattern}\.weight", k)) for k in sd)

    levels = n("conv") + 1  # a downsampling conv between levels
    nrb = (n("norm1") - 2) // levels  # the middle's two resblocks besides

    def has(_name, port):
        return f"{port}.weight" in sd

    return _tree_from_state(sd, _aekl_v1_layers(levels, nrb, has))


def _batch_norm(sd, prefix, node, stats) -> None:
    for port, v in (("weight", node["scale"]), ("bias", node["bias"]),
                    ("running_mean", stats["mean"]), ("running_var", stats["var"])):
        sd[f"{prefix}.{port}"] = np.asarray(v, np.float32)


def discriminator_state_from_jax(variables: Tree) -> Dict[str, np.ndarray]:
    """JAX ``PatchDiscriminator`` variables (``params`` and ``batch_stats``)
    -> the port's ``PatchDiscriminator`` state_dict (numpy), the BatchNorm
    running mean and (biased) variance included."""
    p, stats = variables["params"], variables["batch_stats"]
    sd: Dict[str, np.ndarray] = {}
    _conv(sd, "initial_conv", p["initial_conv"])
    for l in range(_count(p, "layer_{}_conv")):
        _conv(sd, f"layer_{l}_conv", p[f"layer_{l}_conv"])
        _batch_norm(sd, f"layer_{l}_bn", p[f"layer_{l}_bn"], stats[f"layer_{l}_bn"])
    _conv(sd, "final_conv", p["final_conv"])
    return sd


def discriminator_v1_state_from_jax(variables: Tree) -> Dict[str, np.ndarray]:
    """JAX ``DiscriminatorV1`` variables (``params`` and ``batch_stats``,
    flax's automatic names ``Conv_i`` and ``BatchNorm_i``) -> the port's
    ``DiscriminatorV1`` state_dict (numpy), BatchNorm statistics included."""
    p, stats = variables["params"], variables["batch_stats"]
    sd: Dict[str, np.ndarray] = {}
    for i in range(_count(p, "Conv_{}")):
        _conv(sd, f"conv_{i}", p[f"Conv_{i}"])
    for i in range(_count(p, "BatchNorm_{}")):
        _batch_norm(sd, f"bn_{i}", p[f"BatchNorm_{i}"], stats[f"BatchNorm_{i}"])
    return sd


def usleep_state_from_jax(variables: Tree) -> Dict[str, np.ndarray]:
    """JAX ``USleep`` variables (``params`` and ``batch_stats``) -> the
    port's ``USleep`` state_dict (numpy) in braindecode's ``nn.Sequential``
    names, each BatchNorm's running statistics and a zero
    ``num_batches_tracked`` included; the depth is read from the keys. The
    inverse of ``sleepgen.utils.torch_import.import_usleep``."""
    p, stats = variables["params"], variables["batch_stats"]
    sd: Dict[str, np.ndarray] = {}

    def block(conv_port, conv_name, bn_port, bn_name):
        _conv(sd, conv_port, p[conv_name])
        _batch_norm(sd, bn_port, p[bn_name], stats[bn_name])
        sd[f"{bn_port}.num_batches_tracked"] = np.asarray(0, np.int64)

    depth = _count(p, "enc_{}_conv")
    for i in range(depth):
        block(f"encoder.{i}.block_prepool.0", f"enc_{i}_conv",
              f"encoder.{i}.block_prepool.2", f"enc_{i}_bn")
    block("bottom.0", "bottom_conv", "bottom.2", "bottom_bn")
    for i in range(depth):
        block(f"decoder.{i}.block_preskip.1", f"dec_{i}_preskip_conv",
              f"decoder.{i}.block_preskip.3", f"dec_{i}_preskip_bn")
        block(f"decoder.{i}.block_postskip.0", f"dec_{i}_postskip_conv",
              f"decoder.{i}.block_postskip.2", f"dec_{i}_postskip_bn")
    for port, name in (("clf.0", "clf_conv_1"), ("clf.3", "clf_conv_2"), ("clf.5", "clf_conv_3")):
        _conv(sd, port, p[name])
    return sd


def _bn_counted(sd, prefix, node, stats) -> None:
    _batch_norm(sd, prefix, node, stats)
    sd[f"{prefix}.num_batches_tracked"] = np.asarray(0, np.int64)


def _chambon_features(sd, prefix: str, p: Tree, stats: Tree) -> None:
    """A ``ChambonFeatureExtractor``'s flax params under braindecode's
    names: the spatial Dense (C, V) -> Conv2d (V, 1, C, 1), the temporal
    convs (k, in, F) -> Conv2d (F, in, 1, k), the BatchNorms (if any)."""
    if "spatial" in p:
        sd[f"{prefix}spatial_conv.weight"] = np.ascontiguousarray(
            np.asarray(p["spatial"]["kernel"], np.float32).T[:, None, :, None])
        sd[f"{prefix}spatial_conv.bias"] = np.asarray(p["spatial"]["bias"], np.float32)
    for i, name in ((0, "conv1"), (4, "conv2")):
        k = np.asarray(p[name]["kernel"], np.float32)
        sd[f"{prefix}feature_extractor.{i}.weight"] = np.ascontiguousarray(
            k.transpose(2, 1, 0)[:, :, None, :])
        sd[f"{prefix}feature_extractor.{i}.bias"] = np.asarray(p[name]["bias"], np.float32)
    for i, name in ((1, "bn1"), (5, "bn2")):
        if name in p:
            _bn_counted(sd, f"{prefix}feature_extractor.{i}", p[name], stats[name])


def chambon_state_from_jax(variables: Tree) -> Dict[str, np.ndarray]:
    """JAX ``SleepStagerChambon2018`` variables -> the port's state_dict
    (numpy) in braindecode's names, head at ``final_layer.1``."""
    p, stats = variables["params"], variables.get("batch_stats", {})
    sd: Dict[str, np.ndarray] = {}
    _chambon_features(sd, "", p["feature_extractor"], stats.get("feature_extractor", {}))
    _dense(sd, "final_layer.1", p["fc"])
    return sd


def chambon_sequence_state_from_jax(variables: Tree) -> Dict[str, np.ndarray]:
    """JAX ``TimeDistributedStager`` variables -> the port's state_dict in
    braindecode's names: the features under ``0.module.``, the head at
    ``1.2``."""
    p, stats = variables["params"], variables["batch_stats"]
    sd: Dict[str, np.ndarray] = {}
    _chambon_features(sd, "0.module.", p["feature_extractor"], stats["feature_extractor"])
    _dense(sd, "1.2", p["head"])
    return sd


LSTM_GATES = ("i", "f", "g", "o")  # torch's gate order, flax's ii/hi, if/hf, ...


def _lstm_direction(sd, prefix: str, suffix: str, cell: Tree) -> None:
    sd[f"{prefix}.weight_ih_l0{suffix}"] = np.ascontiguousarray(np.concatenate(
        [np.asarray(cell[f"i{g}"]["kernel"], np.float32).T for g in LSTM_GATES]))
    sd[f"{prefix}.weight_hh_l0{suffix}"] = np.ascontiguousarray(np.concatenate(
        [np.asarray(cell[f"h{g}"]["kernel"], np.float32).T for g in LSTM_GATES]))
    sd[f"{prefix}.bias_hh_l0{suffix}"] = np.concatenate(
        [np.asarray(cell[f"h{g}"]["bias"], np.float32) for g in LSTM_GATES])
    sd[f"{prefix}.bias_ih_l0{suffix}"] = np.zeros_like(sd[f"{prefix}.bias_hh_l0{suffix}"])


def deepsleepnet_state_from_jax(variables: Tree) -> Dict[str, np.ndarray]:
    """JAX ``DeepSleepNet`` variables -> the port's state_dict (numpy). The
    JAX module's cells are ``OptimizedLSTMCell_{0..3}`` in creation order:
    layer 0 forward, layer 0 backward, layer 1 forward, layer 1 backward."""
    p, stats = variables["params"], variables["batch_stats"]
    sd: Dict[str, np.ndarray] = {}
    for branch in ("branch_small", "branch_large"):
        bp, bs = p[branch], stats[branch]
        _conv(sd, f"{branch}.conv1", bp["conv1"])
        _batch_norm(sd, f"{branch}.bn1", bp["bn1"], bs["bn1"])
        for i in range(3):
            _conv(sd, f"{branch}.conv2_{i}", bp[f"conv2_{i}"])
            _batch_norm(sd, f"{branch}.bn2_{i}", bp[f"bn2_{i}"], bs[f"bn2_{i}"])
    if "shortcut" in p:
        _dense(sd, "shortcut", p["shortcut"])
        for layer in range(2):
            for direction, suffix in enumerate(("", "_reverse")):
                _lstm_direction(sd, f"lstm_{layer}", suffix,
                                p[f"OptimizedLSTMCell_{2 * layer + direction}"])
        _dense(sd, "fc", p["fc"])
    return sd


def save_params_npz(path: str | Path, tree: Tree) -> Path:
    """Write a nested parameter tree as a flat '/'-keyed ``.npz``."""
    flat: Dict[str, np.ndarray] = {}

    def walk(node: Tree, prefix: str) -> None:
        for k, v in node.items():
            if isinstance(v, Mapping):
                walk(v, f"{prefix}{k}/")
            else:
                flat[prefix + k] = np.asarray(v)

    walk(_params(tree), "")
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    np.savez(path, **flat)
    return path


def load_params_npz(path: str | Path) -> Dict[str, Any]:
    """Read a flat '/'-keyed ``.npz`` back into a nested parameter tree."""
    tree: Dict[str, Any] = {}
    with np.load(path) as data:
        for key in data.files:
            node = tree
            *parents, leaf = key.split("/")
            for part in parents:
                node = node.setdefault(part, {})
            node[leaf] = data[key]
    return tree


def seeded_state_dict(module: torch.nn.Module, seed: int) -> Dict[str, np.ndarray]:
    """Random weights for every parameter of ``module`` (which may live on
    the meta device), drawn with numpy from ``seed`` in state_dict order:
    matrices and kernels N(0, 1/fan_in), GroupNorm weights 1 + N(0, 0.1^2),
    biases N(0, 0.1^2). No parameter is left at zero, so a parity or smoke
    run exercises every layer."""
    rng = np.random.default_rng(seed)
    sd = {}
    for name, p in module.state_dict().items():
        shape = tuple(p.shape)
        if len(shape) >= 2:
            v = rng.standard_normal(shape) / np.sqrt(np.prod(shape[1:]))
        elif name.endswith("weight"):
            v = 1.0 + 0.1 * rng.standard_normal(shape)
        else:
            v = 0.1 * rng.standard_normal(shape)
        sd[name] = v.astype(np.float32)
    return sd


def lecun_normal_state(module: torch.nn.Module, seed: int | Sequence[int],
                       zero_suffixes: Tuple[str, ...] = ()) -> Dict[str, np.ndarray]:
    """Initial weights of every entry of ``module``'s state_dict, drawn with
    numpy from ``seed`` in state_dict order, as the JAX package initialises
    them: kernels lecun-normal (fan_in = every axis but the output one),
    zero for names ending in ``zero_suffixes``; 1-D weights (GroupNorm and
    BatchNorm scales) and BatchNorm running variances one; biases and
    running means zero."""
    rng = np.random.default_rng(seed)
    sd = {}
    for name, p in module.state_dict().items():
        shape = tuple(p.shape)
        if len(shape) < 2:
            v = np.full(shape, 1.0 if name.endswith(("weight", "running_var")) else 0.0)
        elif name.endswith(zero_suffixes):
            v = np.zeros(shape)
        else:
            v = rng.standard_normal(shape)
            while (out := np.abs(v) > 2.0).any():
                v[out] = rng.standard_normal(int(out.sum()))
            v *= math.sqrt(1.0 / np.prod(shape[1:])) / TRUNCATED_NORMAL_STD
        sd[name] = v.astype(np.float32)
    return sd


def _orthogonal(rng: np.random.Generator, n: int) -> np.ndarray:
    """flax's ``orthogonal()`` for an (n, n) kernel: Q of a normal matrix's
    QR, its columns' signs fixed by R's diagonal."""
    q, r = np.linalg.qr(rng.standard_normal((n, n)))
    return q * np.sign(np.diag(r))


def flax_init_state(module: torch.nn.Module, seed: int) -> Dict[str, np.ndarray]:
    """flax's default initial weights for a decoder, drawn with numpy from
    ``seed`` (``lecun_normal_state``: lecun-normal kernels, zero biases,
    BatchNorm scale and running variance 1), with each LSTM's recurrent
    kernel (``weight_hh``) orthogonal per gate, as ``OptimizedLSTMCell``'s.
    The values are the port's own: JAX draws from a threefry key that
    numpy cannot reproduce."""
    sd = lecun_normal_state(module, seed)
    rng = np.random.default_rng([seed, 2])
    for name, v in sd.items():
        if ".weight_hh_" in name:
            h = v.shape[1]
            sd[name] = np.concatenate([_orthogonal(rng, h).T for _ in range(v.shape[0] // h)]
                                      ).astype(np.float32)
    return sd


def load_numpy_state(module: torch.nn.Module, state: Mapping[str, np.ndarray]) -> torch.nn.Module:
    """``module.load_state_dict`` from numpy arrays (or tensors), strict."""
    module.load_state_dict({k: v if torch.is_tensor(v) else torch.from_numpy(np.asarray(v))
                            for k, v in state.items()}, strict=True)
    return module
