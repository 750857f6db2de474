"""Weights across the two packages, and seeded random weights.

``unet_state_from_jax`` and ``aekl_state_from_jax`` map a flax parameter
tree of numpy arrays (as the JAX package's ``UNet1d`` and
``AutoencoderKL`` hold them) to the port's ``state_dict`` names, which are
the reference UNetModel's and MONAI's. Conventions: conv kernel
(k, in, out) -> weight (out, in, k); Dense kernel (in, out) -> weight
(out, in); GroupNorm scale/bias -> weight/bias; Embed embedding -> weight.
The tree's structure (levels, resblocks per level, attention) is read
from its keys.

A JAX run dir becomes a port run dir through a flat ``'/'``-keyed
``params.npz`` (``save_params_npz`` / ``load_params_npz``); the export
recipe is in the README.
"""
from __future__ import annotations

from pathlib import Path
from typing import Any, Dict, Mapping

import numpy as np
import torch

Tree = Mapping[str, Any]


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


def _unet_res(sd, prefix, node) -> None:
    _gn(sd, f"{prefix}.in_layers.0", node["GroupNorm32_0"])
    _conv(sd, f"{prefix}.in_layers.2", node["in_conv"])
    _dense(sd, f"{prefix}.emb_layers.1", node["emb_proj"])
    _gn(sd, f"{prefix}.out_layers.0", node["GroupNorm32_1"])
    _conv(sd, f"{prefix}.out_layers.3", node["out_conv"])
    if "skip_conv" in node:
        _conv(sd, f"{prefix}.skip_connection", node["skip_conv"])


def _unet_attn(sd, prefix, node) -> None:
    _gn(sd, f"{prefix}.norm", node["GroupNorm32_0"])
    _conv(sd, f"{prefix}.qkv", node["SelfAttention1d_0"]["qkv"])
    _conv(sd, f"{prefix}.proj_out", node["SelfAttention1d_0"]["proj_out"])


def unet_state_from_jax(tree: Tree) -> Dict[str, np.ndarray]:
    """JAX ``UNet1d`` params -> the port's ``UNet1d`` state_dict (numpy)."""
    p = _params(tree)
    levels = _count(p, "down_{}_res_0")
    nrb = _count(p, "down_0_res_{}")
    sd: Dict[str, np.ndarray] = {}
    _dense(sd, "time_embed.0", p["time_dense_1"])
    _dense(sd, "time_embed.2", p["time_dense_2"])
    if "label_emb" in p:
        sd["label_emb.weight"] = np.asarray(p["label_emb"]["embedding"], np.float32)
    _conv(sd, "input_blocks.0.0", p["conv_in"])
    blk = 1
    for level in range(levels):
        for i in range(nrb):
            _unet_res(sd, f"input_blocks.{blk}.0", p[f"down_{level}_res_{i}"])
            if f"down_{level}_attn_{i}" in p:
                _unet_attn(sd, f"input_blocks.{blk}.1", p[f"down_{level}_attn_{i}"])
            blk += 1
        if level != levels - 1:
            _unet_res(sd, f"input_blocks.{blk}.0", p[f"down_{level}_downres"])
            blk += 1
    _unet_res(sd, "middle_block.0", p["mid_res_1"])
    _unet_attn(sd, "middle_block.1", p["mid_attn"])
    _unet_res(sd, "middle_block.2", p["mid_res_2"])
    blk = 0
    for level in reversed(range(levels)):
        for i in range(nrb + 1):
            _unet_res(sd, f"output_blocks.{blk}.0", p[f"up_{level}_res_{i}"])
            nxt = 1
            if f"up_{level}_attn_{i}" in p:
                _unet_attn(sd, f"output_blocks.{blk}.1", p[f"up_{level}_attn_{i}"])
                nxt = 2
            if level > 0 and i == nrb:
                _unet_res(sd, f"output_blocks.{blk}.{nxt}", p[f"up_{level}_upres"])
            blk += 1
    _gn(sd, "out.0", p["GroupNorm32_0"])
    _conv(sd, "out.2", p["conv_out"])
    return sd


def _aekl_res(sd, prefix, node) -> None:
    _gn(sd, f"{prefix}.norm1", node["GroupNorm32_0"])
    _conv(sd, f"{prefix}.conv1.conv", node["conv1"])
    _gn(sd, f"{prefix}.norm2", node["GroupNorm32_1"])
    _conv(sd, f"{prefix}.conv2.conv", node["conv2"])
    if "nin_shortcut" in node:
        _conv(sd, f"{prefix}.nin_shortcut.conv", node["nin_shortcut"])


def aekl_state_from_jax(tree: Tree) -> Dict[str, np.ndarray]:
    """JAX ``AutoencoderKL`` params -> the port's state_dict (numpy)."""
    p = _params(tree)
    sd: Dict[str, np.ndarray] = {}
    for side, tag, resample in (("encoder", "down", "downsample"),
                                ("decoder", "up", "upsample")):
        col = p[side]
        levels = _count(col, tag + "_{}_res_0")
        nrb = _count(col, tag + "_0_res_{}")
        pre = f"{side}.blocks"
        _conv(sd, f"{pre}.0.conv", col["conv_in"])
        b = 1
        for i in range(levels):
            for j in range(nrb):
                _aekl_res(sd, f"{pre}.{b}", col[f"{tag}_{i}_res_{j}"])
                b += 1
            if i != levels - 1:
                _conv(sd, f"{pre}.{b}.conv.conv", col[f"{tag}_{i}_{resample}"]["conv"])
                b += 1
        _gn(sd, f"{pre}.{b}", col["norm_out"])
        _conv(sd, f"{pre}.{b + 1}.conv", col["conv_out"])
    for name in ("quant_conv_mu", "quant_conv_log_sigma", "post_quant_conv"):
        _conv(sd, f"{name}.conv", p[name])
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


def load_numpy_state(module: torch.nn.Module, state: Mapping[str, np.ndarray]) -> torch.nn.Module:
    """``module.load_state_dict`` from numpy arrays, strict."""
    module.load_state_dict({k: torch.from_numpy(np.asarray(v)) for k, v in state.items()},
                           strict=True)
    return module
