"""Stage-2 latent diffusion training.

Counterpart of ``sleepgen/train/train_ldm.py`` (the reference's
``train_ldm.py`` and ``training.py``): a frozen AEKL encodes each batch
and draws a posterior sample; ``scale_factor = 1 / std(z)`` of the first
training batch; t ~ U[0, T), z_t = add_noise(z * scale_factor, eps, t),
and the denoiser is fitted to eps (or to v) by MSE with Adam. Eval comes
first, then every ``val_interval`` epochs, with an in-training DDPM
sample every ``2 * val_interval`` (its arrays, and the JAX trainer's
waveform and PSD figures, which never stop training); the best model is
chosen before the periodic checkpoint is written; a run dir with
checkpoints resumes; a non-finite epoch loss stops training and the
final model comes from the last finite checkpoint.

The denoiser is the one ``cfg.denoiser`` names: the UNet, or DiT-XL/2's
transformer (``nn/dit.py``), with its published initialisation. A DiT with
experts (DiT-MoE) adds its routers' auxiliary loss to the diffusion loss.

Conditional training (``cfg.num_classes`` > 0): the loader is a
``data.staging.LabeledEpochDataset`` of ``(x, y)`` batches; each label is
dropped to the null label -1 with probability ``train.cond_dropout_prob``
(classifier-free guidance), the eval feeds the labels, and the in-training
sample draws one window per class (``sample_conditional_{epoch}.npy``). A
conditional denoiser refuses windows without labels (the ``train-ldm``
CLI's), which would train its null class alone.

Precision: the denoiser keeps fp32 master weights and fp32 Adam state, as
the JAX state does, and computes in ``cfg.dtype`` under
``torch.autocast`` (bf16 convolutions and matmuls; GroupNorm statistics,
softmax and the loss in fp32). The frozen AEKL is cast to ``cfg.dtype``
and runs without autograd.

Random draws come from ``train/common.py``'s streams 0-3 (a training
step, with the label dropout drawn last; an eval batch; the in-training
sample; the scale factor). Crop
offsets come from ``numpy.random.default_rng(cfg.train.seed)`` in the JAX
package's order, so both packages train on the same windows.

Data parallelism (``mesh``, ``sleepgen_torch.parallel``): every rank
reads the same global batch, padded to a multiple of the ranks as the JAX
loader pads it, draws the step's inputs for the whole of it from the same
generator and keeps its shard; gradients are averaged over the ranks, the
loss, the eval losses and the scale factor's std are the global batch's,
and only rank 0 writes the run dir's files.
"""
from __future__ import annotations

import math
import time
from dataclasses import dataclass
from typing import Dict, List, Mapping, Optional

import numpy as np
import torch

from sleepgen_torch.config import Config
from sleepgen_torch.data.staging import LabeledEpochDataset
from sleepgen_torch.diffusion.schedules import NoiseSchedule
from sleepgen_torch.nn import dit
from sleepgen_torch.nn.aekl import AutoencoderKL
from sleepgen_torch.nn.layers import cast_compute_dtype
from sleepgen_torch.parallel.mesh import Mesh, make_mesh
from sleepgen_torch.sample.sample_ldm import DTYPES, Denoiser, build_aekl, build_unet
from sleepgen_torch.sample.samplers import cond_model_fn, ddpm_sample_loop
from sleepgen_torch.train.common import (EVAL_STREAM, SAMPLE_STREAM, SCALE_STREAM,
                                         TRAIN_STREAM, batch_to_device, draw_label_drop,
                                         latent_length, make_generator)
from sleepgen_torch.train.evals import masked_epoch_mean
from sleepgen_torch.utils.checkpoint import CheckpointManager
from sleepgen_torch.utils.logging import setup_run_dir, split_loggers
from sleepgen_torch.utils.profiling import span
from sleepgen_torch.utils.weights import (denoiser_state_to_tree, lecun_normal_state,
                                          load_numpy_state)

# Layers the reference zero-initialises: each resblock's last conv, each
# attention output projection and the UNet's output conv.
ZERO_INIT_SUFFIXES = (".out_layers.3.weight", ".proj_out.weight", "out.2.weight")


def make_schedule(cfg: Config, device: torch.device | str = "cpu") -> NoiseSchedule:
    """The training schedule (linear betas, epsilon target by default),
    apart from the sampler's (``sample_ldm.sampling_schedule``)."""
    d = cfg.diffusion
    return NoiseSchedule.create(d.beta_schedule, d.timesteps, d.linear_start, d.linear_end,
                                prediction_type=d.prediction_type, device=device)


def init_unet_state(unet: Denoiser, seed: int) -> Dict[str, np.ndarray]:
    """Initial denoiser weights drawn with numpy from ``seed``: a UNet's as
    the JAX package initialises them (kernels lecun-normal, the reference's
    zero-init convs zero, biases zero, GroupNorm weights one), a DiT's as
    the published DiT does (``dit.init_state``)."""
    if isinstance(unet, dit.DiT1d):
        return dit.init_state(unet, seed)
    return lecun_normal_state(unet, seed, ZERO_INIT_SUFFIXES)


def posterior_sample(ae: AutoencoderKL, x: torch.Tensor, enc_eps: torch.Tensor) -> torch.Tensor:
    """z = z_mu + eps * z_sigma of x (B, C, L) under the frozen AEKL, in fp32."""
    with torch.no_grad():
        z_mu, z_sigma = ae.encode(x)
        return (z_mu + enc_eps.to(z_sigma.dtype) * z_sigma).float()


def compute_scale_factor(ae: AutoencoderKL, x: torch.Tensor, enc_eps: torch.Tensor,
                         mesh: Optional[Mesh] = None) -> float:
    """1 / std(z) of a posterior sample of the first training batch
    (population std, as ``jnp.std``); with a ``mesh``, x and enc_eps are
    this rank's shard and the std is the global batch's."""
    z = posterior_sample(ae, x, enc_eps)
    if mesh is not None:
        z = mesh.gather(z)
    return float(1.0 / z.std(correction=0))


def ldm_losses(unet: Denoiser, ae: AutoencoderKL, sched: NoiseSchedule, scale_factor: float,
               x: torch.Tensor, t: torch.Tensor, noise: torch.Tensor, enc_eps: torch.Tensor,
               compute_dtype: torch.dtype = torch.float32,
               y: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per-sample diffusion losses (B,) of windows x (B, C, L) at timesteps
    t (B,), with the latent noise and the encoder's eps given (the tests
    inject them; ``draw_step_inputs`` draws them in training); ``y`` (B,)
    the labels of a conditional denoiser. The frozen encode is a
    ``trainer.encode`` span, the rest a ``trainer.forward`` span."""
    with span("trainer.encode"):
        z = posterior_sample(ae, x, enc_eps)
    with span("trainer.forward"):
        z = z * scale_factor
        noisy = sched.add_noise(z, noise, t)
        target = (sched.velocity(z, noise, t) if sched.prediction_type == "v_prediction"
                  else noise)
        with torch.autocast(x.device.type, dtype=compute_dtype,
                            enabled=compute_dtype != torch.float32):
            pred = unet(noisy, t, y)
        return (pred.float() - target).square().mean(dim=(1, 2))


def draw_step_inputs(gen: torch.Generator, batch: int, latent_shape, num_timesteps: int):
    """(t, noise, enc_eps) of one step, in that order of use but drawn as
    enc_eps, t, noise; ``latent_shape`` is (channels, length)."""
    dev = gen.device
    enc_eps = torch.randn((batch, *latent_shape), generator=gen, device=dev)
    t = torch.randint(0, num_timesteps, (batch,), generator=gen, device=dev)
    noise = torch.randn((batch, *latent_shape), generator=gen, device=dev)
    return t, noise, enc_eps


def make_ldm_train_step(unet: Denoiser, ae: AutoencoderKL, sched: NoiseSchedule,
                        opt: torch.optim.Optimizer, scale_factor: float,
                        compute_dtype: torch.dtype = torch.float32,
                        ema: Optional[Dict[str, torch.Tensor]] = None, ema_decay: float = 0.0,
                        mesh: Optional[Mesh] = None):
    """``step(x, t, noise, enc_eps, y=None, drop=None) -> loss``: one Adam
    step on the mean loss, then the EMA update ``e = decay * e + (1 -
    decay) * p`` when ``ema`` (fp32 copies of the parameters, by name) is
    given. ``unet`` is the denoiser (a ``UNet1d`` or a ``DiT1d``; the loss
    of a DiT with experts includes its routers' auxiliary loss). ``y``
    (B,) labels of a conditional denoiser; where ``drop`` (B,)
    bool is set, the label becomes the null label -1. With a ``mesh`` the
    inputs are this rank's equal shard of the global batch's, the gradient
    is averaged over the ranks before Adam and the loss returned is the
    global mean. A step is a ``trainer.step`` span over ``trainer.encode``,
    ``trainer.forward``, ``trainer.backward``, ``trainer.allreduce`` (with
    a mesh), ``trainer.optimizer`` and ``trainer.ema`` (with ``ema``)."""
    named = dict(unet.named_parameters())

    def train_step(x, t, noise, enc_eps, y=None, drop=None) -> torch.Tensor:
        with span("trainer.step"):
            if drop is not None:
                y = torch.where(drop, torch.full_like(y, -1), y)
            opt.zero_grad(set_to_none=True)
            loss = ldm_losses(unet, ae, sched, scale_factor, x, t, noise, enc_eps,
                              compute_dtype, y).mean()
            aux = getattr(unet, "aux_loss", None)  # DiT-MoE's routers', from this forward
            if aux is not None:
                loss = loss + aux
            with span("trainer.backward"):
                loss.backward()
            if mesh is not None:
                with span("trainer.allreduce"):
                    mesh.average_gradients(unet.parameters())
                    loss = mesh.mean(loss)
            with span("trainer.optimizer"):
                opt.step()
            if ema is not None:
                with span("trainer.ema"), torch.no_grad():
                    for name, e in ema.items():
                        e.mul_(ema_decay).add_(named[name], alpha=1.0 - ema_decay)
            return loss.detach()

    return train_step


def make_ldm_eval_step(unet: Denoiser, ae: AutoencoderKL, sched: NoiseSchedule,
                       compute_dtype: torch.dtype = torch.float32):
    """``eval_step(x, scale_factor, t, noise, enc_eps, y=None) -> (B,)``
    per-sample losses, without autograd (the UNet's chains then run K2)."""

    def eval_step(x, scale_factor, t, noise, enc_eps, y=None) -> torch.Tensor:
        with torch.no_grad():
            return ldm_losses(unet, ae, sched, scale_factor, x, t, noise, enc_eps,
                              compute_dtype, y)

    return eval_step


def build_trainer(cfg: Config, ae_state: Mapping[str, np.ndarray], aekl_cfg: Config,
                  dev: torch.device | str):
    """(unet, ae, sched, opt) on ``dev``: the denoiser ``cfg.denoiser`` names
    (``build_unet``; a UNet's attention on ``cfg.fast_train_math``'s path)
    with fp32 master weights initialised from ``cfg.train.seed``
    (``init_unet_state``), the frozen AEKL cast to ``cfg.dtype`` without
    autograd, the training schedule, and Adam."""
    lc = aekl_cfg.aekl.latent_channels
    with torch.device(dev):
        ae = load_numpy_state(build_aekl(aekl_cfg), ae_state)
        unet = build_unet(cfg, lc, lc, cfg.fast_train_math)
    cast_compute_dtype(ae.eval(), DTYPES[cfg.dtype]).requires_grad_(False)
    load_numpy_state(unet, init_unet_state(unet, cfg.train.seed))
    opt = torch.optim.Adam(unet.parameters(), lr=cfg.train.base_lr)
    return unet, ae, make_schedule(cfg, dev), opt


@dataclass
class DiffusionTrainResult:
    run_dir: str
    best_loss: float
    last_epoch: int
    scale_factor: float
    stopped_on_nan: bool = False


def train_ldm(cfg: Config, train_ds, valid_ds, ae_state: Mapping[str, np.ndarray],
              aekl_cfg: Optional[Config] = None, run_name: Optional[str] = None,
              device: torch.device | str = "cuda",
              mesh: Optional[Mesh] = None) -> DiffusionTrainResult:
    """Train the LDM's denoiser on ``train_ds`` (a ``WindowDataset``, or a
    ``LabeledEpochDataset`` when ``cfg.num_classes`` > 0) against the
    frozen AEKL whose port state dict is ``ae_state``; writes the run dir
    under ``cfg.train.output_dir`` (config.yaml, metrics_*.jsonl,
    checkpoints/, best_model/, final_model/, in-training samples).
    ``mesh``: data-parallel over its ranks, on its device (default: the
    world of one on ``device``)."""
    mesh = mesh or make_mesh(device=device)
    dev, main, n_dev = mesh.device, mesh.is_main, mesh.n_data
    dtype = DTYPES[cfg.dtype]
    aekl_cfg = aekl_cfg or cfg
    lc = aekl_cfg.aekl.latent_channels
    seed = cfg.train.seed
    conditional = cfg.num_classes > 0
    if conditional and not all(isinstance(ds, LabeledEpochDataset) for ds in (train_ds, valid_ds)):
        raise ValueError(f"a conditional denoiser (num_classes={cfg.num_classes}) trains on "
                         "labelled windows (LabeledEpochDataset); these have no labels")
    drop_prob = cfg.train.cond_dropout_prob if conditional else 0.0

    spe = "spectral" if cfg.spectral else "no-spectral"
    run_name = run_name or f"ldm_eeg_{spe}_{cfg.dataset}"
    run_dir, resume = setup_run_dir(cfg.train.output_dir, run_name)
    if main:
        cfg.to_yaml(run_dir / "config.yaml")
    logger_t, logger_v = split_loggers(run_dir, main)
    ckpt = CheckpointManager(run_dir)

    unet, ae, sched, opt = build_trainer(cfg, ae_state, aekl_cfg, dev)

    def batches(ds, rng, **kw):
        """This rank's shards of the loader's global batches, on ``dev``."""
        for batch in ds.epoch_batches(cfg.train.batch_size, rng, pad_multiple=n_dev, **kw):
            x, y = batch if isinstance(batch, tuple) else (batch, None)
            yield batch_to_device(mesh.shard(x) if y is None
                                  else (mesh.shard(x), mesh.shard(y)), dev), x.shape[0]

    def shard(*tensors):
        return tuple(None if v is None else mesh.shard(v) for v in tensors)

    np_rng = np.random.default_rng(seed)
    (first, _), n_first = next(batches(train_ds, np_rng))
    latent_shape = (lc, latent_length(aekl_cfg, first.shape[-1]))
    scale_eps = torch.randn((n_first, *latent_shape),
                            generator=make_generator(seed, dev, SCALE_STREAM), device=dev)
    scale_factor = compute_scale_factor(ae, first, mesh.shard(scale_eps), mesh)

    ema_decay = cfg.diffusion.ema_decay
    ema = ({k: v.detach().clone() for k, v in unet.named_parameters()}
           if ema_decay > 0.0 else None)
    step, best_loss = 0, math.inf
    if resume and (restored := ckpt.restore_latest()) is not None:
        unet.load_state_dict(restored["params"])
        opt.load_state_dict(restored["opt"])
        if ema is not None and restored["ema"] is not None:
            for k, v in restored["ema"].items():
                ema[k].copy_(v)
        step, best_loss = restored["step"], restored["best_loss"]
        scale_factor = restored["scale_factor"]

    train_step = make_ldm_train_step(unet, ae, sched, opt, scale_factor, dtype, ema, ema_decay,
                                     mesh)
    eval_step = make_ldm_eval_step(unet, ae, sched, dtype)

    def state() -> dict:
        return dict(step=step, params=unet.state_dict(), opt=opt.state_dict(), ema=ema,
                    best_loss=best_loss, scale_factor=scale_factor)

    def model_params(st: dict):
        return st["ema"] if ema_decay > 0.0 else st["params"]

    def run_eval(epoch: int, sample: bool = False) -> float:
        def losses(bi, batch):
            (x, y), n = batch
            gen = make_generator(seed, dev, EVAL_STREAM, epoch, bi)
            inputs = shard(*draw_step_inputs(gen, n, latent_shape, sched.num_timesteps))
            return mesh.gather(eval_step(x, scale_factor, *inputs, y))

        val = masked_epoch_mean(len(valid_ds), batches(valid_ds, np_rng, shuffle=True), losses)
        logger_v.log(epoch, {"loss": val})
        if sample and main:
            log_sample(epoch)
        return val

    def log_sample(epoch: int) -> None:
        """One DDPM sample per class (conditional) or one, decoded with and
        without the scale factor, saved in the (B, C, L) layout."""
        n = cfg.num_classes if conditional else 1
        y = torch.arange(n, device=dev) if conditional else None
        tag = "conditional" if conditional else "unconditioned"
        gen = make_generator(seed, dev, SAMPLE_STREAM, epoch)
        with torch.inference_mode(), torch.autocast(dev.type, dtype=dtype,
                                                    enabled=dtype != torch.float32):
            z_T = torch.randn((n, *latent_shape), generator=gen, device=dev)
            z = ddpm_sample_loop(cond_model_fn(unet, y, 1.0), sched, z_T, gen,
                                 clip_sample=False)
            x_scaled, x_raw = (ae.decode(zz).float().cpu().numpy()
                               for zz in (z / scale_factor, z))
        np.save(run_dir / f"sample_{tag}_{epoch}.npy", x_scaled)
        np.save(run_dir / f"sample_noscale_{tag}_{epoch}.npy", x_raw)
        # the figures of the reference's in-training sampler (util.py:226-258):
        # the waveforms, and the PSD of the decode with against without the
        # scale factor; a failure is printed, never raised
        try:
            from sleepgen_torch.eval.reports import save_sample_figure, save_spectral_figure

            save_sample_figure(run_dir, epoch, x_scaled)
            save_spectral_figure(run_dir, epoch, x_scaled, x_raw, name="SAMPLE_VS_NOSCALE")
        except Exception as e:
            print(f"sample figure logging failed at epoch {epoch}: {e}", flush=True)

    steps_per_epoch = max(1, math.ceil(len(train_ds) / cfg.train.batch_size))
    start_epoch = step // steps_per_epoch
    last_epoch, stopped_on_nan = start_epoch, False
    run_eval(start_epoch)  # eval first
    for epoch in range(start_epoch, cfg.train.n_epochs):
        last_epoch = epoch
        t0 = time.perf_counter()
        losses: List[torch.Tensor] = []
        for (x, y), n in batches(train_ds, np_rng):
            gen = make_generator(seed, dev, TRAIN_STREAM, step)
            inputs = draw_step_inputs(gen, n, latent_shape, sched.num_timesteps)
            drop = draw_label_drop(gen, n, drop_prob)
            losses.append(train_step(x, *shard(*inputs), y, *shard(drop)))
            step += 1
        mean_loss = float(torch.stack(losses).mean())
        logger_t.log(epoch, {"loss": mean_loss, "seconds": time.perf_counter() - t0})
        if not math.isfinite(mean_loss):
            stopped_on_nan = True
            break
        if (epoch + 1) % cfg.train.val_interval == 0:
            val_loss = run_eval(epoch, sample=(epoch + 1) % (2 * cfg.train.val_interval) == 0)
            improved = val_loss <= best_loss  # best before save
            if improved:
                best_loss = val_loss
            if main:
                st = state()
                ckpt.save(step, st)
                if improved:
                    ckpt.save_best(denoiser_state_to_tree(cfg.denoiser, model_params(st)),
                                   cfg, scale_factor=scale_factor)

    if stopped_on_nan:  # the final model is the last finite checkpoint, if any
        final = ckpt.restore_latest()
    else:
        final = state()
        if main:
            ckpt.save(step, final)
    if final is not None and main:
        ckpt.save_best(denoiser_state_to_tree(cfg.denoiser, model_params(final)), cfg,
                       "final_model", final["scale_factor"])
    logger_t.close()
    logger_v.close()
    return DiffusionTrainResult(str(run_dir), best_loss, last_epoch, scale_factor,
                                stopped_on_nan)
