"""A tiny configuration of each cell for tests on the CPU: the cells' own
drivers, parameters and checks, at widths a test can hold."""
from __future__ import annotations

import copy
from pathlib import Path

from portbench import harness

TINY_UNET = {"model_channels": 32, "channel_mult": [1, 2], "num_res_blocks": 1,
             "attention_resolutions": [2], "norm_num_groups": 8}
TINY_AEKL = {"num_channels": [4, 4, 8]}


def tiny(cell: str, tmp: Path, dtype: str = "bfloat16"):
    """(spec, cfg) of ``cell`` at tiny widths; its YAML copies, cut alike,
    are written under ``tmp``."""
    import yaml

    spec = copy.deepcopy(harness.workload(cell))
    cfg = copy.deepcopy(harness.config(spec["config"]))
    scale = 4 if "aekl" in cfg else 1  # the AEKL's two downsamplings
    cfg["dtype"] = dtype
    cfg["unet"].update(TINY_UNET, image_size=256 // scale)
    cfg["window"] = 256
    if "aekl" in cfg:
        cfg["aekl"].update(TINY_AEKL)
    yamls = []
    for i, path in enumerate(cfg["yaml"]):
        raw = yaml.safe_load((harness.ROOT / path).read_text())
        raw["dtype"] = dtype
        if "unet" in raw:
            raw["unet"].update(TINY_UNET, image_size=cfg["unet"]["image_size"])
        if "aekl" in raw:
            raw["aekl"].update(TINY_AEKL)
        out = tmp / f"tiny{i}.yaml"
        out.write_text(yaml.safe_dump(raw))
        yamls.append(str(out))
    cfg["yaml"] = yamls
    spec.update(batch=4, check_windows=16, check_block=2, pool=4, profile_steps=1)
    if "steps" in spec:
        spec["steps"] = 3
    return spec, cfg


def context(cell: str, tmp: Path, seed: int = 2**31 + 7, seconds: float = 1.0,
            dtype: str = "bfloat16") -> harness.Context:
    spec, cfg = tiny(cell, tmp, dtype)
    return harness.Context(cell, seed, seconds, False, "cpu", spec, cfg)
