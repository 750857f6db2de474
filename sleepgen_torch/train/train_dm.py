"""Signal-space diffusion training (the pure DM, no autoencoder).

Counterpart of ``sleepgen/train/train_dm.py`` (the reference's
``train_pure_ldm.py`` and ``training_diffusion.py``): the LDM's UNet
family runs directly on (B, 1, 3072) windows. t ~ U[0, T), x_t =
add_noise(x, eps, t) on the training schedule (``train_ldm.make_schedule``:
linear betas, epsilon target by default; sampling uses the scaled-linear
v-prediction table on purpose), and the UNet is fitted by MSE with Adam,
plus ``DM_SPECTRAL_WEIGHT`` x the Jukebox loss between the prediction and
the target along the length axis when ``cfg.spectral``. With labels
(``unet.num_classes`` > 0, batches of ``(x, y)`` from
``data.staging.LabeledEpochDataset``) each label is dropped to the null
label -1 with probability ``train.cond_dropout_prob``, so one network
learns the conditional and the unconditional score (classifier-free
guidance).

The run dir is the JAX trainer's: config.yaml, metrics_*.jsonl,
checkpoints/, best_model/ whenever the validation loss improves (every
``val_interval`` epochs; no eval before the first epoch, as in JAX),
final_model/ (after a non-finite loss, the latest finite checkpoint), and
every ``2 * val_interval`` epochs an ancestral DDPM sample with
``clip_sample=True``, one per class when conditional, saved as
``sample_{conditional|unconditioned}_{epoch}.npy`` in (B, C, L).

Precision: fp32 master weights and Adam state; the UNet computes in
``cfg.dtype`` under ``torch.autocast``. Windows are rounded to
``cfg.dtype`` and back to fp32 before the step, as the JAX trainer feeds
them. Random draws come from ``train/common.py``'s streams: 0 a training
step (t, the noise, then the label dropout), 1 an eval batch (t, the
noise), 2 the in-training sample (x_T, then one noise per step).
"""
from __future__ import annotations

import math
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from sleepgen_torch.config import Config
from sleepgen_torch.diffusion.schedules import NoiseSchedule
from sleepgen_torch.losses.spectral import jukebox_loss
from sleepgen_torch.nn.unet1d import UNet1d
from sleepgen_torch.parallel.mesh import Mesh, make_mesh
from sleepgen_torch.sample.sample_ldm import DTYPES, build_unet
from sleepgen_torch.sample.samplers import cond_model_fn, ddpm_sample_loop
from sleepgen_torch.train.common import (EVAL_STREAM, SAMPLE_STREAM, TRAIN_STREAM,
                                         batch_to_device, draw_label_drop, make_generator)
from sleepgen_torch.train.evals import masked_epoch_mean
from sleepgen_torch.train.train_ldm import DiffusionTrainResult, init_unet_state, make_schedule
from sleepgen_torch.utils.checkpoint import CheckpointManager
from sleepgen_torch.utils.logging import setup_run_dir, split_loggers
from sleepgen_torch.utils.weights import load_numpy_state, unet_state_to_jax

DM_SPECTRAL_WEIGHT = 1e-6  # the reference's train_pure_ldm.py:158
METRICS = ("loss", "mse", "spec_loss")  # what a training step returns


def dm_prediction(unet: UNet1d, sched: NoiseSchedule, x: torch.Tensor, t: torch.Tensor,
                  noise: torch.Tensor, y: Optional[torch.Tensor],
                  compute_dtype: torch.dtype = torch.float32):
    """(prediction, target), both fp32 (B, C, L), of windows x at timesteps
    t with the noise given; the target is the noise, or the velocity under
    v-prediction."""
    noisy = sched.add_noise(x, noise, t)
    target = sched.velocity(x, noise, t) if sched.prediction_type == "v_prediction" else noise
    with torch.autocast(x.device.type, dtype=compute_dtype,
                        enabled=compute_dtype != torch.float32):
        pred = unet(noisy, t, y)
    return pred.float(), target


def draw_dm_step_inputs(gen: torch.Generator, batch: int, shape, num_timesteps: int,
                        drop_prob: float = 0.0):
    """(t, noise, drop) of one step, drawn in that order; ``shape`` is
    (channels, length); ``drop`` is None unless ``drop_prob`` > 0."""
    dev = gen.device
    t = torch.randint(0, num_timesteps, (batch,), generator=gen, device=dev)
    noise = torch.randn((batch, *shape), generator=gen, device=dev)
    return t, noise, draw_label_drop(gen, batch, drop_prob)


def make_dm_train_step(unet: UNet1d, sched: NoiseSchedule, opt: torch.optim.Optimizer,
                       spectral: bool, compute_dtype: torch.dtype = torch.float32,
                       mesh: Optional[Mesh] = None):
    """``step(x, t, noise, y=None, drop=None) -> {"loss", "mse",
    "spec_loss"}``: one Adam step on the mean loss. ``y`` (B,) labels of a
    conditional UNet; where ``drop`` (B,) bool is set, the label becomes
    the null label -1. ``spec_loss`` is reported whether or not it is in the
    loss. With a ``mesh`` the inputs are this rank's equal shard of the
    global batch's, the gradient is averaged over the ranks and the
    metrics are the global batch's (the spectral sum over every rank's
    rows)."""
    world = mesh.n_data if mesh is not None else 1

    def train_step(x, t, noise, y=None, drop=None) -> Dict[str, torch.Tensor]:
        if drop is not None:
            y = torch.where(drop, torch.full_like(y, -1), y)
        opt.zero_grad(set_to_none=True)
        pred, target = dm_prediction(unet, sched, x, t, noise, y, compute_dtype)
        mse = (pred - target).square().mean()
        spec = jukebox_loss(pred, target, reduction="sum")
        # a sum over the global batch: each rank's share, times the ranks
        # the gradient's mean divides by
        loss = mse + DM_SPECTRAL_WEIGHT * world * spec if spectral else mse
        loss.backward()
        if mesh is not None:
            mesh.average_gradients(unet.parameters())
            mse, spec = mesh.mean(mse), mesh.sum(spec)
            loss = mse + DM_SPECTRAL_WEIGHT * spec if spectral else mse
        opt.step()
        return {"loss": loss.detach(), "mse": mse.detach(), "spec_loss": spec.detach()}

    return train_step


def make_dm_eval_step(unet: UNet1d, sched: NoiseSchedule,
                      compute_dtype: torch.dtype = torch.float32):
    """``eval_step(x, t, noise, y=None) -> (B,)`` per-sample MSE, without
    autograd (the UNet's chains then run K2)."""

    def eval_step(x, t, noise, y=None) -> torch.Tensor:
        with torch.no_grad():
            pred, target = dm_prediction(unet, sched, x, t, noise, y, compute_dtype)
            return (pred - target).square().mean(dim=(1, 2))

    return eval_step


def build_dm_trainer(cfg: Config, dev: torch.device | str):
    """(unet, sched, opt) on ``dev``: the UNet on one channel with fp32
    master weights initialised from ``cfg.train.seed``, the training
    schedule and Adam."""
    with torch.device(dev):
        unet = build_unet(cfg, 1, 1, cfg.fast_train_math)
    load_numpy_state(unet, init_unet_state(unet, cfg.train.seed))
    opt = torch.optim.Adam(unet.parameters(), lr=cfg.train.base_lr)
    return unet, make_schedule(cfg, dev), opt


def train_dm(cfg: Config, train_ds, valid_ds, run_name: Optional[str] = None,
             device: torch.device | str = "cuda",
             mesh: Optional[Mesh] = None) -> DiffusionTrainResult:
    """Train the signal-space DM on ``train_ds`` (a ``WindowDataset``, or a
    ``LabeledEpochDataset`` when ``cfg.unet.num_classes`` > 0); writes the
    run dir under ``cfg.train.output_dir``. ``mesh``: data-parallel over its
    ranks as ``train_ldm``'s (default: the world of one on ``device``)."""
    mesh = mesh or make_mesh(device=device)
    dev, main, n_dev = mesh.device, mesh.is_main, mesh.n_data
    dtype = DTYPES[cfg.dtype]
    seed = cfg.train.seed
    conditional = cfg.unet.num_classes > 0
    drop_prob = cfg.train.cond_dropout_prob if conditional else 0.0

    spe = "spectral" if cfg.spectral else "no-spectral"
    run_name = run_name or f"dm_eeg_{spe}_{cfg.dataset}"
    run_dir, resume = setup_run_dir(cfg.train.output_dir, run_name)
    if main:
        cfg.to_yaml(run_dir / "config.yaml")
    logger_t, logger_v = split_loggers(run_dir, main)
    ckpt = CheckpointManager(run_dir)

    unet, sched, opt = build_dm_trainer(cfg, dev)
    shape = (1, train_ds.padded_window)
    step, best_loss = 0, math.inf
    if resume and (restored := ckpt.restore_latest()) is not None:
        unet.load_state_dict(restored["params"])
        opt.load_state_dict(restored["opt"])
        step, best_loss = restored["step"], restored["best_loss"]
    train_step = make_dm_train_step(unet, sched, opt, cfg.spectral, dtype, mesh)
    eval_step = make_dm_eval_step(unet, sched, dtype)

    def batches(ds, rng, **kw):
        """This rank's shards of the loader's global batches on ``dev``,
        rounded through ``dtype``, with the global batch size."""
        for batch in ds.epoch_batches(cfg.train.batch_size, rng, pad_multiple=n_dev, **kw):
            x, y = batch if isinstance(batch, tuple) else (batch, None)
            x, y = batch_to_device(mesh.shard(x) if y is None
                                   else (mesh.shard(x), mesh.shard(y)), dev)
            yield x.to(dtype).float(), y, x.shape[0] * n_dev

    def shard(*tensors):
        return tuple(None if v is None else mesh.shard(v) for v in tensors)

    def state() -> dict:
        return dict(step=step, params=unet.state_dict(), opt=opt.state_dict(),
                    best_loss=best_loss)

    def log_sample(epoch: int) -> None:
        """One DDPM sample per class (conditional) or one, clipped."""
        n = cfg.unet.num_classes if conditional else 1
        y = torch.arange(n, device=dev) if conditional else None
        gen = make_generator(seed, dev, SAMPLE_STREAM, epoch)
        with torch.inference_mode(), torch.autocast(dev.type, dtype=dtype,
                                                    enabled=dtype != torch.float32):
            x_T = torch.randn((n, *shape), generator=gen, device=dev)
            x = ddpm_sample_loop(cond_model_fn(unet, y, 1.0), sched, x_T, gen,
                                 clip_sample=True)
        tag = "conditional" if conditional else "unconditioned"
        np.save(run_dir / f"sample_{tag}_{epoch}.npy", x.float().cpu().numpy())

    def run_eval(epoch: int) -> float:
        def losses(bi, batch):
            x, y, n = batch
            gen = make_generator(seed, dev, EVAL_STREAM, epoch, bi)
            t, noise, _ = draw_dm_step_inputs(gen, n, shape, sched.num_timesteps)
            return mesh.gather(eval_step(x, *shard(t, noise), y))

        val = masked_epoch_mean(len(valid_ds), batches(valid_ds, np_rng, shuffle=True), losses)
        logger_v.log(epoch, {"loss": val})
        return val

    np_rng = np.random.default_rng(seed)
    steps_per_epoch = max(1, math.ceil(len(train_ds) / cfg.train.batch_size))
    start_epoch = step // steps_per_epoch
    last_epoch, stopped_on_nan = start_epoch, False
    for epoch in range(start_epoch, cfg.train.n_epochs):
        last_epoch = epoch
        t0 = time.perf_counter()
        losses: List[torch.Tensor] = []
        for x, y, n in batches(train_ds, np_rng):
            gen = make_generator(seed, dev, TRAIN_STREAM, step)
            inputs = draw_dm_step_inputs(gen, n, shape, sched.num_timesteps, drop_prob)
            losses.append(train_step(x, *shard(*inputs[:2]), y, *shard(inputs[2]))["loss"])
            step += 1
        mean_loss = float(torch.stack(losses).mean())
        logger_t.log(epoch, {"loss": mean_loss, "seconds": time.perf_counter() - t0})
        if not math.isfinite(mean_loss):
            stopped_on_nan = True
            break
        if (epoch + 1) % cfg.train.val_interval == 0:
            if (epoch + 1) % (2 * cfg.train.val_interval) == 0 and main:
                log_sample(epoch)
            val_loss = run_eval(epoch)
            improved = val_loss <= best_loss  # best before save
            if improved:
                best_loss = val_loss
            if main:
                st = state()
                ckpt.save(step, st)
                if improved:
                    ckpt.save_best(unet_state_to_jax(st["params"]), cfg)

    if stopped_on_nan:  # the final model is the last finite checkpoint, if any
        final = ckpt.restore_latest()
    else:
        final = state()
        if main:
            ckpt.save(step, final)
    if final is not None and main:
        ckpt.save_best(unet_state_to_jax(final["params"]), cfg, "final_model")
    logger_t.close()
    logger_v.close()
    return DiffusionTrainResult(str(run_dir), best_loss, last_epoch, 1.0, stopped_on_nan)
