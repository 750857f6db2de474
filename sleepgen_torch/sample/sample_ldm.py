"""LDM and signal-space DM sampling with the reference's artifact contract.

Counterpart of ``sleepgen/sample/sample_ldm.py`` and of the DM half of
``sleepgen/cli/sample_trials_ddpm.py``. Per batch of seeds: per-seed x_T
-> DDIM or DPM-Solver++(2M) over the UNet (plain, stage conditional, or
with classifier-free guidance) -> AEKL decode of z / scale_factor -> crop
of the border pad; the DM skips the decode (``sample_dm_trials``, and
``make_dm_sampler``'s ancestral DDPM). Artifacts:

  * ``sample_{i}.npy``   (1, 1, 3000) cropped signal, reference layout;
  * ``psd_list_{i}.npy`` [psds (1, F), freqs (F,), psds_mean (F,)], the dB
    DPSS multitaper PSD up to 18 Hz;
  * ``psd_list.npy``     the per-seed PSD entries stacked.

Models run in torch's (B, C, L) layout; the sampler returns (B, 3000, C)
as the JAX package's does.

Data parallelism (``mesh``): each batch of seeds splits into one
contiguous share per rank (the batch must divide over the ranks, as the
JAX sampler asserts); each seed keeps its own generator, and the windows
are gathered in seed order on every rank, so a seed's window does not
depend on the world size. Only rank 0 writes artifacts.
"""
from __future__ import annotations

from pathlib import Path
from typing import Callable, Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from sleepgen_torch.config import Config
from sleepgen_torch.data.transforms import BORDER_PAD, to_bcl
from sleepgen_torch.diffusion.dpm_solver import dpm_solver_pp_2m_sample_loop
from sleepgen_torch.diffusion.schedules import Noise, NoiseSchedule
from sleepgen_torch.nn.aekl import AutoencoderKL
from sleepgen_torch.nn.dit import DiT1d
from sleepgen_torch.nn.layers import cast_compute_dtype
from sleepgen_torch.nn.unet1d import UNet1d, quantize_unet
from sleepgen_torch.parallel.mesh import Mesh, split_seeds
from sleepgen_torch.sample.samplers import (cond_model_fn, ddim_sample_loop, ddpm_sample_loop,
                                             sample_dm_conditional, seed_noise, validate_stage)
from sleepgen_torch.utils.device import resolve_device
from sleepgen_torch.utils.profiling import span
from sleepgen_torch.utils.weights import (aekl_state_from_jax, denoiser_state_from_tree,
                                          load_numpy_state, load_params_npz)

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
# A stage-2 denoiser: (B, C, L) latents, (B,) timesteps, optional (B,) labels
# -> (B, C, L) fp32
Denoiser = Union[UNet1d, DiT1d]
SAMPLERS = {"ddim": ddim_sample_loop, "dpm++2m": dpm_solver_pp_2m_sample_loop}


def sampling_schedule(cfg: Config, device: torch.device | str = "cpu") -> NoiseSchedule:
    d = cfg.diffusion
    return NoiseSchedule.create(d.sample_schedule, d.timesteps, d.sample_beta_start,
                                d.sample_beta_end, prediction_type=d.sample_prediction_type,
                                device=device)


def dm_sampling_schedule(cfg: Config, num_train_timesteps: int,
                         device: torch.device | str = "cpu") -> NoiseSchedule:
    """The DM's sampling schedule: the LDM sampler's scaled-linear betas and
    v-prediction, with a table of ``num_train_timesteps`` entries. The
    reference's ``sample_trials_ddpm.py`` passes its
    ``--num_inference_steps`` as this table length, not as the loop's."""
    d = cfg.diffusion
    return NoiseSchedule.create(d.sample_schedule, num_train_timesteps, d.sample_beta_start,
                                d.sample_beta_end, prediction_type=d.sample_prediction_type,
                                device=device)


def build_unet(cfg: Config, in_channels: int, out_channels: int,
               fast_math: bool = True) -> Denoiser:
    """The denoiser ``cfg.denoiser`` names: the UNet of ``cfg.unet``, whose
    attention takes ``fast_math``, the precision switch of the path that
    runs it (``cfg.fast_sampling_math`` or ``cfg.fast_train_math``), or the
    DiT of ``cfg.dit``, which predicts its ``in_channels`` (DiT-MoE where
    ``cfg.dit.num_experts`` > 0)."""
    if cfg.denoiser == "dit":
        d = cfg.dit
        return DiT1d(in_channels=in_channels, input_size=d.input_size,
                     patch_size=d.patch_size, hidden_size=d.hidden_size, depth=d.depth,
                     num_heads=d.num_heads, mlp_ratio=d.mlp_ratio, num_classes=d.num_classes,
                     num_experts=d.num_experts, num_experts_per_tok=d.num_experts_per_tok,
                     n_shared_experts=d.n_shared_experts, aux_loss_alpha=d.aux_loss_alpha)
    if cfg.denoiser != "unet":
        raise ValueError(f"unknown denoiser {cfg.denoiser!r}; 'unet' or 'dit'")
    u = cfg.unet
    return UNet1d(in_channels=in_channels, out_channels=out_channels,
                  model_channels=u.model_channels, channel_mult=tuple(u.channel_mult),
                  num_res_blocks=u.num_res_blocks,
                  attention_resolutions=tuple(u.attention_resolutions),
                  num_heads=u.num_heads, num_groups=u.norm_num_groups,
                  num_classes=u.num_classes, resblock_updown=u.resblock_updown,
                  use_scale_shift_norm=u.use_scale_shift_norm,
                  conv_resample=u.conv_resample, dropout=u.dropout,
                  kv_block_size=u.kv_block_size, fast_math=fast_math)


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
                 aekl_cfg: Optional[Config] = None,
                 quantized: bool = False) -> Tuple[Denoiser, AutoencoderKL]:
    """The denoiser ``cfg.denoiser`` names (``build_unet``: the UNet, DiT-XL/2
    or, with ``cfg.dit.num_experts`` > 0, DiT-MoE) and the AEKL on
    ``device`` with the given state dicts (numpy arrays or tensors, by
    name), in eval mode and cast to ``cfg.dtype``, a UNet's attention on
    ``cfg.fast_sampling_math``'s path; ``quantized``: the int8 UNet, its
    convolutions quantized from the fp32 ``unet_state`` (a DiT, dense or
    sparse, has no int8 path and raises)."""
    aekl_cfg = aekl_cfg or cfg
    lc = aekl_cfg.aekl.latent_channels
    dtype = DTYPES[cfg.dtype]
    with torch.device(device):
        unet = load_numpy_state(build_unet(cfg, lc, lc, cfg.fast_sampling_math), unet_state)
        ae = load_numpy_state(build_aekl(aekl_cfg), ae_state)
    if quantized:
        unet = quantize_unet(unet)
    cast_compute_dtype(unet.eval(), dtype)
    cast_compute_dtype(ae.eval(), dtype)
    return unet, ae


def make_ldm_sampler(unet: Denoiser, ae: AutoencoderKL, sched: NoiseSchedule,
                     latent_len: int = 768, latent_channels: int = 1,
                     num_inference_steps: int = 200, border_pad: int = BORDER_PAD,
                     sampler: str = "ddim", device: torch.device | str = "cuda",
                     conditional: bool = False, guided: bool = False,
                     quantized: bool = False,
                     mesh: Optional[Mesh] = None) -> Callable[..., torch.Tensor]:
    """Returns ``sample(scale_factor, seeds, labels=None, guidance_scale=None)
    -> (B, L - 2 * border_pad, C)`` fp32 on ``device``. ``unet``, the
    denoiser (a ``UNet1d`` or a ``DiT1d``), ``ae`` and ``sched`` must
    already live on ``device``. ``sampler``: "ddim" (the reference's) or
    "dpm++2m" (DPM-Solver++(2M), about DDIM-200's quality in 20 steps);
    either makes ``num_inference_steps`` denoiser calls.

    ``conditional``: each call takes ``labels``, (B,) int64 class labels on
    ``device``, for the denoiser's class embedding (``num_classes`` > 0).
    ``guided``: classifier-free guidance, with the null branch in the same
    2B-batch denoiser forward per step (``samplers.cond_model_fn``); each
    call takes its ``guidance_scale``, so one sampler serves every scale.
    ``quantized``: the UNet runs int8 (``quantize_unet`` of ``unet``, which
    should hold fp32 weights, unless it is quantized already), with the
    strict fp32 GroupNorm numerics. The call returns once the work is
    queued on the card; it reads nothing back (with a ``mesh``, the ranks'
    windows are gathered: each call samples this rank's share of the seeds
    and of the labels, and returns the whole batch). A call is a
    ``sampler.call`` span, holding ``sampler.noise``, the loop's
    ``sampler.step`` spans, ``sampler.decode`` (decode and crop) and, with
    a mesh, ``sampler.gather``."""
    if sampler not in SAMPLERS:
        raise ValueError(f"unknown sampler '{sampler}'; one of {sorted(SAMPLERS)}")
    if guided and not conditional:
        raise ValueError("guided sampling requires a conditional sampler")
    loop = SAMPLERS[sampler]
    dev = resolve_device(device)
    if quantized:
        unet = quantize_unet(unet)

    def sample(scale_factor: float, seeds: Sequence[int], labels: torch.Tensor | None = None,
               guidance_scale: float | None = None) -> torch.Tensor:
        if conditional and labels is None:
            raise ValueError("a conditional sampler needs labels")
        if guided and guidance_scale is None:
            raise ValueError("a guided sampler needs guidance_scale")
        if mesh is not None and labels is not None:
            labels = mesh.shard(labels)
        with span("sampler.call"), torch.inference_mode():
            x_T = seed_noise(split_seeds(mesh, seeds), (latent_len, latent_channels), dev)
            model_fn = cond_model_fn(unet, labels if conditional else None, guidance_scale,
                                     guided=guided)
            z = loop(model_fn, sched, x_T.transpose(1, 2), num_inference_steps)
            with span("sampler.decode"):
                signal = ae.decode_stage_2_outputs(z / scale_factor).float()
                out = signal[:, :, border_pad:-border_pad].transpose(1, 2)
            if mesh is None:
                return out
            with span("sampler.gather"):
                return mesh.gather(out.contiguous())

    return sample


def build_dm(cfg: Config, unet_state: Mapping[str, np.ndarray],
             device: torch.device) -> UNet1d:
    """The signal-space DM's UNet (one channel in and out) on ``device`` with
    the given state dict, in eval mode and cast to ``cfg.dtype``, its
    attention on ``cfg.fast_sampling_math``'s path."""
    with torch.device(device):
        unet = load_numpy_state(build_unet(cfg, 1, 1, cfg.fast_sampling_math), unet_state)
    return cast_compute_dtype(unet.eval(), DTYPES[cfg.dtype])


def make_dm_sampler(unet: UNet1d, sched: NoiseSchedule, signal_len: int = 3072,
                    device: torch.device | str = "cuda") -> Callable[..., torch.Tensor]:
    """Returns ``sample(seeds, noise) -> (B, signal_len - 2 * BORDER_PAD, 1)``
    fp32: per-seed x_T (``seed_noise``), then the ancestral DDPM loop over
    every timestep of ``sched`` with ``clip_sample=True``, its step noise
    drawn from ``noise`` (a ``schedules.Noise``). ``unet`` and ``sched`` must
    already live on ``device``."""
    dev = resolve_device(device)

    def sample(seeds: Sequence[int], noise: Noise) -> torch.Tensor:
        with span("sampler.call"), torch.inference_mode():
            x_T = seed_noise(seeds, (signal_len, 1), dev).transpose(1, 2)
            x = ddpm_sample_loop(unet, sched, x_T, noise, clip_sample=True)
            return x[:, :, BORDER_PAD:-BORDER_PAD].transpose(1, 2)

    return sample


def sample_dm_trials(cfg: Config, unet_state: Mapping[str, np.ndarray],
                     output_dir: str | Path, start_seed: int = 0, stop_seed: int = 1000,
                     batch_size: int = 64, num_train_timesteps: int = 1000,
                     num_ddim_steps: int = 200, compute_psd: bool = True,
                     device: torch.device | str = "cuda", stage: Optional[int] = None,
                     guidance_scale: float = 1.0) -> np.ndarray:
    """Sample the signal-space DM for seeds [start_seed, stop_seed) in
    batches of ``batch_size`` and write their artifacts: per-seed x_T of
    ``cfg.unet.image_size`` samples, DDIM over ``min(num_ddim_steps,
    num_train_timesteps)`` steps of ``dm_sampling_schedule``'s table of
    ``num_train_timesteps`` entries, crop of the border pad. ``stage`` and
    ``guidance_scale`` as in ``sample_ldm_trials``. Returns all cropped
    signals, (N, 3000, 1) fp32."""
    validate_stage(cfg.unet.num_classes, stage, guidance_scale)
    dev = resolve_device(device)
    steps = min(num_ddim_steps, num_train_timesteps)
    window = cfg.unet.image_size
    unet = build_dm(cfg, unet_state, dev)
    sched = dm_sampling_schedule(cfg, num_train_timesteps, dev)
    labels = stage_labels(stage, batch_size, dev) if cfg.unet.num_classes > 0 else None
    outs = []
    for seeds, n in padded_chunks(range(start_seed, stop_seed), batch_size):
        with torch.inference_mode():
            if labels is None:
                x_T = seed_noise(seeds, (window, 1), dev).transpose(1, 2)
                x = ddim_sample_loop(unet, sched, x_T, steps)
            else:
                x = sample_dm_conditional(unet, sched, labels, seeds, window, steps,
                                          guidance_scale)
        sig = x[:, :, BORDER_PAD:-BORDER_PAD].transpose(1, 2).cpu().numpy()[:n]
        write_sample_artifacts(output_dir, seeds[:n], sig, compute_psd)
        outs.append(sig)
    return np.concatenate(outs, axis=0)


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


def stage_labels(stage: int, batch: int, device: torch.device) -> torch.Tensor:
    """(batch,) int64 labels of one stage, made on ``device`` (no copy)."""
    return torch.full((batch,), int(stage), dtype=torch.int64, device=device)


def padded_chunks(seeds: Sequence[int], batch_size: int):
    """``seeds`` in chunks of ``batch_size``, a last partial chunk padded
    with copies of its last seed: yields (padded chunk, real length). Every
    chunk then runs the kernels at the shapes a full batch gives them."""
    seeds = list(seeds)
    for i in range(0, len(seeds), batch_size):
        chunk = seeds[i:i + batch_size]
        yield chunk + [chunk[-1]] * (batch_size - len(chunk)), len(chunk)


def sample_ldm_trials(cfg: Config, unet_state: Mapping[str, np.ndarray],
                      ae_state: Mapping[str, np.ndarray], scale_factor: float,
                      output_dir: str | Path, start_seed: int = 0, stop_seed: int = 1000,
                      batch_size: int = 64, aekl_cfg: Optional[Config] = None,
                      compute_psd: bool = True, border_pad: int = BORDER_PAD,
                      device: torch.device | str = "cuda", stage: Optional[int] = None,
                      guidance_scale: float = 1.0, quantized: bool = False,
                      mesh: Optional[Mesh] = None) -> np.ndarray:
    """Sample seeds [start_seed, stop_seed) in batches of ``batch_size`` and
    write their artifacts. ``unet_state``/``ae_state`` are the port's state
    dicts of the denoiser ``cfg.denoiser`` names and of the AEKL
    (``utils.weights``); the models run in ``cfg.dtype``.
    ``quantized``: the UNet's convolutions run int8 (``nn/quant.py``),
    quantized from ``unet_state``, as the JAX package's
    ``sample_ldm_trials(quantized=True)``. ``stage``:
    the class label of a conditional checkpoint (``cfg.num_classes`` > 0);
    ``guidance_scale`` other than 1 adds classifier-free guidance. A
    last partial batch is padded to ``batch_size`` and trimmed. ``mesh``:
    each batch's seeds split over its ranks (``batch_size`` must divide
    over them), on its device; only rank 0 writes. Returns all cropped
    signals, (N, 3000, 1) fp32."""
    validate_stage(cfg.num_classes, stage, guidance_scale)
    if mesh is not None:
        assert batch_size % mesh.n_data == 0, (batch_size, mesh.n_data)
    dev = mesh.device if mesh is not None else resolve_device(device)
    conditional = cfg.num_classes > 0
    guided = conditional and guidance_scale != 1.0
    unet, ae = build_models(cfg, unet_state, ae_state, dev, aekl_cfg, quantized)
    sampler = make_ldm_sampler(unet, ae, sampling_schedule(cfg, dev),
                               latent_len=cfg.image_size,
                               latent_channels=(aekl_cfg or cfg).aekl.latent_channels,
                               num_inference_steps=cfg.diffusion.num_inference_steps,
                               border_pad=border_pad, sampler=cfg.diffusion.sampler,
                               device=dev, conditional=conditional, guided=guided, mesh=mesh)
    labels = stage_labels(stage, batch_size, dev) if conditional else None
    outs = []
    for seeds, n in padded_chunks(range(start_seed, stop_seed), batch_size):
        sig = sampler(scale_factor, seeds, labels, guidance_scale).cpu().numpy()[:n]
        if mesh is None or mesh.is_main:
            write_sample_artifacts(output_dir, seeds[:n], sig, compute_psd)
        outs.append(sig)
    return np.concatenate(outs, axis=0)


def read_run_dirs(aekl_run_dir: str | Path, ldm_run_dir: str | Path):
    """A port AEKL run dir (``config.yaml``, ``params.npz``) and LDM run dir
    (the same plus ``scale_factor.txt``) -> (LDM config, AEKL config,
    denoiser state dict, AEKL state dict, scale factor). ``params.npz`` is a
    flat '/'-keyed parameter tree; the README shows how to export one from a
    JAX run dir."""
    ae_dir, ldm_dir = Path(aekl_run_dir), Path(ldm_run_dir)
    aekl_cfg = Config.from_yaml(ae_dir / "config.yaml")
    cfg = Config.from_yaml(ldm_dir / "config.yaml")
    ae_state = aekl_state_from_jax(load_params_npz(ae_dir / "params.npz"))
    unet_state = denoiser_state_from_tree(cfg.denoiser, load_params_npz(ldm_dir / "params.npz"))
    scale_factor = float((ldm_dir / "scale_factor.txt").read_text())
    return cfg, aekl_cfg, unet_state, ae_state, scale_factor


def model_dir(path: str | Path, name: str) -> Path:
    """``path`` if it is a port run dir (it holds ``params.npz``), else a
    training run dir's ``name/`` subdirectory (``best_model`` or
    ``final_model``)."""
    d = Path(path)
    return d if (d / "params.npz").exists() else d / name


def read_model_dir(path: str | Path, name: str):
    """(config, denoiser state dict) of ``model_dir(path, name)``."""
    d = model_dir(path, name)
    cfg = Config.from_yaml(d / "config.yaml")
    return cfg, denoiser_state_from_tree(cfg.denoiser, load_params_npz(d / "params.npz"))
