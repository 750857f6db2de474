"""Weights across the two packages, and seeded random weights.

``unet_state_from_jax`` and ``aekl_state_from_jax`` map a flax parameter
tree of numpy arrays (as the JAX package's ``UNet1d`` and
``AutoencoderKL`` hold them) to the port's ``state_dict`` names, which are
the reference UNetModel's and MONAI's; ``unet_state_to_jax`` maps a UNet
back. Conventions: conv kernel
(k, in, out) -> weight (out, in, k); Dense kernel (in, out) -> weight
(out, in); GroupNorm scale/bias -> weight/bias; Embed embedding -> weight.
The tree's structure (levels, resblocks per level, attention) is read
from its keys.

A JAX run dir becomes a port run dir through a flat ``'/'``-keyed
``params.npz`` (``save_params_npz`` / ``load_params_npz``); the export
recipe is in the README.
"""
from __future__ import annotations

import re
from pathlib import Path
from typing import Any, Callable, Dict, Iterator, Mapping, Tuple

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


def _unet_layers(levels: int, nrb: int, has: Callable[[str, str], bool]
                 ) -> Iterator[Tuple[str, str, Tuple[str, ...]]]:
    """(kind, port prefix, flax path) of every layer of a UNet1d with
    ``levels`` levels and ``nrb`` resblocks per level, in order; kind is
    conv, dense, gn or embed. ``has(flax name, port prefix)`` says whether
    an optional layer (attention, a skip conv, the label embedding) is
    there. Both directions of the bridge walk this one layout."""

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
            yield from res(f"input_blocks.{blk}.0", f"down_{level}_downres")
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
                yield from res(f"output_blocks.{blk}.{nxt}", f"up_{level}_upres")
            blk += 1
    yield "gn", "out.0", ("GroupNorm32_0",)
    yield "conv", "out.2", ("conv_out",)


def _node(tree: Tree, path) -> Any:
    for part in path:
        tree = tree[part]
    return tree


def unet_state_from_jax(tree: Tree) -> Dict[str, np.ndarray]:
    """JAX ``UNet1d`` params -> the port's ``UNet1d`` state_dict (numpy)."""
    p = _params(tree)

    def has(name, _port):
        try:
            _node(p, name.split("/"))
            return True
        except KeyError:
            return False

    sd: Dict[str, np.ndarray] = {}
    convert = {"conv": _conv, "dense": _dense, "gn": _gn}
    for kind, port, path in _unet_layers(_count(p, "down_{}_res_0"),
                                         _count(p, "down_0_res_{}"), has):
        if kind == "embed":
            sd[f"{port}.weight"] = np.asarray(p["label_emb"]["embedding"], np.float32)
        else:
            convert[kind](sd, port, _node(p, path))
    return sd


def unet_state_to_jax(state: Mapping[str, Any]) -> Dict[str, Any]:
    """The port's ``UNet1d`` state_dict (numpy arrays or tensors) -> the JAX
    ``UNet1d`` params tree (nested dicts of fp32 numpy arrays), the inverse
    of ``unet_state_from_jax``: a run dir the port trains samples with
    either package."""
    sd = {k: (v.detach().cpu().numpy() if torch.is_tensor(v) else np.asarray(v))
          for k, v in state.items()}
    ups = {k.split(".")[1] for k in sd
           if re.fullmatch(r"output_blocks\.\d+\.[12]\.in_layers\.0\.weight", k)}
    levels = len(ups) + 1
    nrb = len({k.split(".")[1] for k in sd if k.startswith("output_blocks.")}) // levels - 1

    def has(_name, port):
        return f"{port}.weight" in sd or f"{port}.qkv.weight" in sd

    tree: Dict[str, Any] = {}
    for kind, port, path in _unet_layers(levels, nrb, has):
        node = tree
        for part in path:
            node = node.setdefault(part, {})
        w = sd[f"{port}.weight"].astype(np.float32)
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
