"""LDM sampling with the reference's artifact contract.

Counterpart of ``sleepgen/sample/sample_ldm.py`` (unconditional). Per batch
of seeds: per-seed x_T -> DDIM or DPM-Solver++(2M) over the UNet -> AEKL
decode of z / scale_factor -> crop of the border pad. Artifacts:

  * ``sample_{i}.npy``   (1, 1, 3000) cropped signal, reference layout;
  * ``psd_list_{i}.npy`` [psds (1, F), freqs (F,), psds_mean (F,)], the dB
    DPSS multitaper PSD up to 18 Hz;
  * ``psd_list.npy``     the per-seed PSD entries stacked.

Models run in torch's (B, C, L) layout; the sampler returns (B, 3000, C)
as the JAX package's does.
"""
from __future__ import annotations

from pathlib import Path
from typing import Callable, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from sleepgen_torch.config import Config
from sleepgen_torch.data.transforms import BORDER_PAD, to_bcl
from sleepgen_torch.diffusion.dpm_solver import dpm_solver_pp_2m_sample_loop
from sleepgen_torch.diffusion.schedules import NoiseSchedule
from sleepgen_torch.nn.aekl import AutoencoderKL
from sleepgen_torch.nn.layers import cast_compute_dtype
from sleepgen_torch.nn.unet1d import UNet1d
from sleepgen_torch.sample.samplers import ddim_sample_loop, seed_noise
from sleepgen_torch.utils.device import resolve_device
from sleepgen_torch.utils.weights import load_numpy_state

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
SAMPLERS = {"ddim": ddim_sample_loop, "dpm++2m": dpm_solver_pp_2m_sample_loop}


def sampling_schedule(cfg: Config, device: torch.device | str = "cpu") -> NoiseSchedule:
    d = cfg.diffusion
    return NoiseSchedule.create(d.sample_schedule, d.timesteps, d.sample_beta_start,
                                d.sample_beta_end, prediction_type=d.sample_prediction_type,
                                device=device)


def build_unet(cfg: Config, in_channels: int, out_channels: int) -> UNet1d:
    u = cfg.unet
    return UNet1d(in_channels=in_channels, out_channels=out_channels,
                  model_channels=u.model_channels, channel_mult=tuple(u.channel_mult),
                  num_res_blocks=u.num_res_blocks,
                  attention_resolutions=tuple(u.attention_resolutions),
                  num_heads=u.num_heads, num_groups=u.norm_num_groups,
                  num_classes=u.num_classes, resblock_updown=u.resblock_updown,
                  use_scale_shift_norm=u.use_scale_shift_norm, dropout=u.dropout)


def build_aekl(cfg: Config) -> AutoencoderKL:
    a = cfg.aekl
    return AutoencoderKL(num_channels=tuple(a.num_channels),
                         latent_channels=a.latent_channels, in_channels=a.in_channels,
                         out_channels=a.out_channels, num_res_blocks=a.num_res_blocks,
                         norm_num_groups=a.norm_num_groups,
                         attention_levels=tuple(a.attention_levels),
                         with_encoder_nonlocal_attn=a.with_encoder_nonlocal_attn,
                         with_decoder_nonlocal_attn=a.with_decoder_nonlocal_attn)


def build_models(cfg: Config, unet_state: Mapping[str, np.ndarray],
                 ae_state: Mapping[str, np.ndarray], device: torch.device,
                 aekl_cfg: Optional[Config] = None) -> Tuple[UNet1d, AutoencoderKL]:
    """The UNet and the AEKL on ``device`` with the given state dicts, in
    eval mode and cast to ``cfg.dtype``."""
    aekl_cfg = aekl_cfg or cfg
    lc = aekl_cfg.aekl.latent_channels
    dtype = DTYPES[cfg.dtype]
    with torch.device(device):
        unet = load_numpy_state(build_unet(cfg, lc, lc), unet_state)
        ae = load_numpy_state(build_aekl(aekl_cfg), ae_state)
    cast_compute_dtype(unet.eval(), dtype)
    cast_compute_dtype(ae.eval(), dtype)
    return unet, ae


def make_ldm_sampler(unet: UNet1d, ae: AutoencoderKL, sched: NoiseSchedule,
                     latent_len: int = 768, latent_channels: int = 1,
                     num_inference_steps: int = 200, border_pad: int = BORDER_PAD,
                     sampler: str = "ddim", device: torch.device | str = "cuda"
                     ) -> Callable[[float, Sequence[int]], torch.Tensor]:
    """Returns ``sample(scale_factor, seeds) -> (B, L - 2 * border_pad, C)``
    fp32 on ``device``. ``unet``, ``ae`` and ``sched`` must already live on
    ``device``. ``sampler``: "ddim" (the reference's) or "dpm++2m"
    (DPM-Solver++(2M), about DDIM-200's quality in 20 steps); either makes
    ``num_inference_steps`` UNet calls."""
    if sampler not in SAMPLERS:
        raise ValueError(f"unknown sampler '{sampler}'; one of {sorted(SAMPLERS)}")
    loop = SAMPLERS[sampler]
    dev = resolve_device(device)

    def sample(scale_factor: float, seeds: Sequence[int]) -> torch.Tensor:
        with torch.inference_mode():
            x_T = seed_noise(seeds, (latent_len, latent_channels), dev)
            z = loop(unet, sched, x_T.transpose(1, 2), num_inference_steps)
            signal = ae.decode_stage_2_outputs(z / scale_factor).float()
            return signal[:, :, border_pad:-border_pad].transpose(1, 2)

    return sample


def write_sample_artifacts(output_dir: str | Path, seeds: Sequence[int],
                           signals_blc: np.ndarray, compute_psd: bool = True) -> None:
    """Write per-seed ``.npy`` artifacts in the reference layout."""
    from sleepgen_torch.eval.psd import multitaper_psd_db

    output_dir = Path(output_dir)
    output_dir.mkdir(parents=True, exist_ok=True)
    signals_bcl = to_bcl(signals_blc)  # (B, 1, 3000)
    psd_list = []
    if compute_psd:
        psds_all, freqs = multitaper_psd_db(signals_bcl, fmax=18.0)  # (B, 1, F)
    for i, seed in enumerate(seeds):
        np.save(output_dir / f"sample_{seed}.npy", signals_bcl[i:i + 1])
        if compute_psd:
            psds = psds_all[i]
            entry = [psds, freqs, psds.mean(axis=0)]
            np.save(output_dir / f"psd_list_{seed}.npy", np.asarray(entry, dtype=object),
                    allow_pickle=True)
            psd_list.append(entry)
    if psd_list:
        np.save(output_dir / "psd_list.npy", np.asarray(psd_list, dtype=object),
                allow_pickle=True)


def sample_ldm_trials(cfg: Config, unet_state: Mapping[str, np.ndarray],
                      ae_state: Mapping[str, np.ndarray], scale_factor: float,
                      output_dir: str | Path, start_seed: int = 0, stop_seed: int = 1000,
                      batch_size: int = 64, aekl_cfg: Optional[Config] = None,
                      compute_psd: bool = True, border_pad: int = BORDER_PAD,
                      device: torch.device | str = "cuda") -> np.ndarray:
    """Sample seeds [start_seed, stop_seed) in batches of ``batch_size`` and
    write their artifacts. ``unet_state``/``ae_state`` are the port's state
    dicts (``utils.weights``); the models run in ``cfg.dtype``. Returns all
    cropped signals, (N, 3000, 1) fp32."""
    dev = resolve_device(device)
    if cfg.unet.num_classes:
        raise NotImplementedError("conditional sampling is not ported yet")
    unet, ae = build_models(cfg, unet_state, ae_state, dev, aekl_cfg)
    sampler = make_ldm_sampler(unet, ae, sampling_schedule(cfg, dev),
                               latent_len=cfg.unet.image_size,
                               latent_channels=(aekl_cfg or cfg).aekl.latent_channels,
                               num_inference_steps=cfg.diffusion.num_inference_steps,
                               border_pad=border_pad, sampler=cfg.diffusion.sampler,
                               device=dev)
    all_seeds = list(range(start_seed, stop_seed))
    outs = []
    for i in range(0, len(all_seeds), batch_size):
        seeds = all_seeds[i:i + batch_size]
        sig = sampler(scale_factor, seeds).cpu().numpy()
        write_sample_artifacts(output_dir, seeds, sig, compute_psd)
        outs.append(sig)
    return np.concatenate(outs, axis=0)
