"""What the drivers share: the program's configuration read from the frozen
YAML copies, the seeded weights of both networks, the reference models
built from a configuration file, the back-to-back batch loop of the
sampling cells and the comparison of windows.
"""
from __future__ import annotations

import time
from typing import Callable, Dict, List, Sequence

import numpy as np
import torch

from portbench import harness, weights
from portbench.reference import models as ref


def program_configs(cfg: dict):
    """The program's ``Config`` of each YAML copy the configuration lists
    (the diffusion model's, then the AEKL's if any), read by the program's
    own loader."""
    from sleepgen_torch.config import Config

    return [Config.from_yaml(harness.ROOT / path) for path in cfg["yaml"]]


def reference_unet(cfg: dict, prec: ref.Precision | None = None) -> ref.UNet:
    u = cfg["unet"]
    return ref.UNet(u["in_channels"], u["model_channels"], u["channel_mult"],
                    u["num_res_blocks"], u["attention_resolutions"], u["num_heads"],
                    u["norm_num_groups"], prec)


def reference_aekl(cfg: dict, prec: ref.Precision | None = None) -> ref.AutoencoderKL:
    a = cfg["aekl"]
    return ref.AutoencoderKL(a["num_channels"], a["latent_channels"], a["num_res_blocks"],
                             a["norm_num_groups"], prec)


def seeded_weights(model_fn: Callable[[], torch.nn.Module], seed: int, device,
                   purpose: int, served: bool = True) -> Dict[str, torch.Tensor]:
    with torch.device("meta"):
        model = model_fn()
    return weights.make_state(weights.shapes_of(model), ref.groupnorm_params(model), seed,
                              device, purpose, served)


def unet_weights(cfg: dict, seed: int, device, served: bool = True) -> Dict[str, torch.Tensor]:
    """The UNet's weights from the seed: as served (bf16 values), or as
    fp32 training masters (``served`` False)."""
    return seeded_weights(lambda: reference_unet(cfg), seed, device, weights.WEIGHTS_UNET,
                          served)


def aekl_weights(cfg: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    return seeded_weights(lambda: reference_aekl(cfg), seed, device, weights.WEIGHTS_AEKL)


def to_numpy(state: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    return {k: v.cpu().numpy() for k, v in state.items()}


def loaded(model: torch.nn.Module, state: Dict[str, torch.Tensor]) -> torch.nn.Module:
    model.load_state_dict(state, strict=True)
    return model.eval().requires_grad_(False)


def batch_loop(ctx, sample: Callable[[List[int]], torch.Tensor], batch: int, steps: int) -> dict:
    """Batches of ``batch`` consecutive seeds from the run's seed, back to
    back, each read back to the host, until the window closes. A batch that
    would, at the last batch's pace, end past the window is not started.
    Returns the window's record: the rate over the whole batches that
    finished inside it, and their windows and seeds for the check."""
    ends, sizes, enqueue, outs, seeds_done = [], [], [], [], []
    last, i = 0.0, 0
    t0 = time.perf_counter()
    while True:
        now = time.perf_counter() - t0
        if now >= ctx.seconds or (i and now + last > ctx.seconds):
            break
        seeds = list(range(ctx.seed + batch * i, ctx.seed + batch * (i + 1)))
        start = time.perf_counter()
        with harness.span("sample.batch"):
            out = sample(seeds)
        queued = time.perf_counter()
        with harness.span("sample.readback"):
            host = out.cpu().numpy()
        end = time.perf_counter()
        last = end - start
        ends.append(end)
        sizes.append(batch)
        enqueue.append(queued - start)
        outs.append(host)
        seeds_done.append(seeds)
        i += 1
    rate, counted = harness.whole_batch_rate(t0, ends, sizes, ctx.seconds)
    if rate is None:
        raise RuntimeError(f"no batch finished inside the {ctx.seconds} s window")
    windows = np.concatenate(outs[:counted])
    seeds = [s for chunk in seeds_done[:counted] for s in chunk]
    bad = int((~np.isfinite(windows.reshape(len(windows), -1)).all(axis=1)).sum())
    return {"metrics": {ctx.spec["rate_metric"]: rate}, "rate": rate,
            "attempted": len(windows), "failed": bad,
            "windows": windows, "seeds": seeds, "batch": batch, "steps": steps,
            "enqueue_s": enqueue[:counted], "next_seed": ctx.seed + batch * i}


def check_sample(ctx, record: dict, n: int) -> List[int]:
    """Indices of ``n`` windows of the record, drawn from the run's seed."""
    rng = np.random.default_rng(weights.sub_seed(ctx.seed, weights.CHECK_SAMPLE))
    return sorted(rng.choice(len(record["windows"]), size=min(n, len(record["windows"])),
                             replace=False).tolist())


def check_windows(ctx, record: dict, reference_windows) -> list:
    """``window_rel_l2``, the worst window's ||p - r|| / ||r||, of a sample
    of the record's windows, drawn from the seed, against the float32
    reference of their seeds."""
    (name, limit), = ctx.spec["limits"].items()
    if not len(record["windows"]):
        return [(name, float("inf"), limit)]
    idx = check_sample(ctx, record, ctx.spec["check_windows"])
    seeds = [record["seeds"][i] for i in idx]
    ctx.reference = (seeds, reference_windows(ctx.cfg, ctx.spec, ctx.seed, seeds, ctx.device))
    return [(name, window_number(ctx, "program", record["windows"][idx]), limit)]


def window_number(ctx, who: str, got: np.ndarray) -> float:
    """The worst window's ||p - r|| / ||r|| of windows ``got`` against the
    last check's reference; per-window readings kept under ``ctx.detail[who]``."""
    err, norm = window_gaps(got, ctx.reference[1])
    ctx.detail[who] = (err, norm)
    return max(e / n for e, n in zip(err, norm))


def control_windows(ctx, reference_windows) -> list:
    """The number for the reference in fp8 in the program's place, on the
    seeds of the last check."""
    (name, _), = ctx.spec["limits"].items()
    seeds = ctx.reference[0]
    got = reference_windows(ctx.cfg, ctx.spec, ctx.seed, seeds, ctx.device, ref.Precision("fp8"))
    return [(name, window_number(ctx, "fp8_reference", got))]


def window_gaps(program: np.ndarray, reference: np.ndarray):
    """Per window, (||program - reference||, ||reference||)."""
    p = program.reshape(len(program), -1).astype(np.float64)
    r = reference.reshape(len(reference), -1).astype(np.float64)
    return np.linalg.norm(p - r, axis=1).tolist(), np.linalg.norm(r, axis=1).tolist()


def in_blocks(fn: Callable[[Sequence[int]], np.ndarray], seeds: Sequence[int],
              block: int) -> np.ndarray:
    return np.concatenate([fn(seeds[i:i + block]) for i in range(0, len(seeds), block)])
