"""Seeded inputs and weights, made on the device in a few large calls.

Every random number of a run comes from ``generator(seed, device, *purpose)``:
a ``torch.Generator`` on the device, seeded from the run's ``--seed`` and a
purpose through numpy's ``SeedSequence``, so any whole number is a valid
seed and two purposes never share a stream.

Weights: one standard normal draw for all of a model's parameters, cut
into its leaves in state-dict order. Matrices and kernels are scaled to
N(0, 1 / fan_in); GroupNorm weights are 1 + N(0, 0.1^2); every other
vector (biases, GroupNorm shifts) is N(0, 0.1^2). No leaf is zero, so every
layer takes part in the comparison. Leaves that the program serves in
bf16 hold values that bf16 represents exactly, so the program and the
float32 reference start from the same numbers.
"""
from __future__ import annotations

from typing import Dict, Iterable

import numpy as np
import torch

# Purposes of the random streams
WEIGHTS_UNET, WEIGHTS_AEKL, WINDOWS, STEP_INPUTS, SCALE_EPS, CHECK_SAMPLE, TRAFFIC = range(7)


def sub_seed(seed: int, *purpose: int) -> int:
    """A 63-bit seed for (seed, *purpose); ``seed`` is any whole number >= 0."""
    return int(np.random.SeedSequence([int(seed), *purpose]).generate_state(1, np.uint64)[0]
               >> np.uint64(1))


def generator(seed: int, device, *purpose: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(sub_seed(seed, *purpose))


def make_state(shapes: Dict[str, tuple], groupnorm: Iterable[str], seed: int, device,
               purpose: int, served: bool = True) -> Dict[str, torch.Tensor]:
    """fp32 leaves by name for ``shapes`` (name -> shape, in state-dict
    order); ``groupnorm`` names the GroupNorm parameters, which stay fp32;
    with ``served`` (weights the program holds in bf16) all others are
    rounded to bf16 values, else (fp32 master weights) none is."""
    groupnorm = set(groupnorm)
    names = list(shapes)
    numel = [int(np.prod(shapes[n])) for n in names]
    flat = torch.randn(sum(numel), generator=generator(seed, device, purpose), device=device)
    scale, shift, rounded = [], [], []
    for n in names:
        shape = shapes[n]
        if len(shape) >= 2:
            scale.append(float(np.prod(shape[1:])) ** -0.5)
            shift.append(0.0)
        else:
            scale.append(0.1)
            shift.append(1.0 if n in groupnorm and n.endswith("weight") else 0.0)
        rounded.append(served and n not in groupnorm)
    per = torch.tensor(numel, device=device)
    flat = (flat * torch.tensor(scale, device=device).repeat_interleave(per)
            + torch.tensor(shift, device=device).repeat_interleave(per))
    to_bf16 = torch.tensor(rounded, device=device).repeat_interleave(per)
    flat = torch.where(to_bf16, flat.bfloat16().float(), flat)
    return {n: t.view(shapes[n]) for n, t in zip(names, flat.split(numel))}


def shapes_of(model: torch.nn.Module) -> Dict[str, tuple]:
    return {k: tuple(v.shape) for k, v in model.state_dict().items()}
