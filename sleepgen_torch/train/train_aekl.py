"""Stage-1 training: the AutoencoderKL against a PatchDiscriminator.

Counterpart of ``sleepgen/train/train_aekl.py`` (the reference's
``train_autoencoderkl.py``). One step is the G step, then the D step:

  G: L1(recon, x) + kl_weight * KL + adv_weight * LSGAN(D(recon) -> real)
     [+ spectral_weight * Jukebox, only when ``cfg.spectral``]; Adam (5e-3)
  D: adv_weight * 0.5 * (LSGAN(D(recon) -> fake) + LSGAN(D(x) -> real));
     Adam (5e-4), on the G step's recon (made before the G update), detached

as the JAX step does it: the G step applies the discriminator with its
batch's BatchNorm statistics, keeps no update of the running ones, and
gives its parameters no gradient (they are frozen for the G step, which
also skips their weight-gradient convolutions); the D step's fake pass
moves the running statistics and its real pass moves them again from
there. The spectral loss is logged whether or not it is trained on.

``train_aekl`` runs the epochs: an eval every ``val_interval`` epochs (the
per-sample L1 of the reconstruction through the posterior mean), the best
model chosen before the periodic checkpoint is written, resume from
``checkpoints/``, and a stop at the first non-finite epoch loss with the
final model taken from the last finite checkpoint. ``best_model/`` and
``final_model/`` are port AEKL run dirs (``config.yaml``, ``params.npz``
in the JAX package's keys) that ``train-ldm --best_model_path`` and
``sample`` read. Every eval also writes the JAX trainer's figures of the
first validation batch's sample 0 (``_log_val_figures``: the waveforms and
the PSD overlay, with their arrays); a figure that fails (matplotlib
missing) is printed and training goes on.

Precision: fp32 master weights and fp32 Adam state, compute in
``cfg.dtype`` under ``torch.autocast``; the batch is cast to that dtype
first, as the JAX trainer casts it. L1, KL, the FFT, the adversarial
MSEs and BatchNorm run in fp32. On the card every AEKL GroupNorm runs K1
forward and K3 backward.

Random draws: the encoder's eps of step ``s`` comes from
``common.make_generator(seed, device, AEKL_STREAM, s)``, a stream of its
own; crop offsets come from ``numpy.random.default_rng(seed)`` in the
JAX package's order (training crops unshuffled, validation shuffled).

Data parallelism (``mesh``): each rank takes its shard of the global
batch and of its eps; the discriminator's BatchNorm computes the global
batch's statistics (``Mesh.bind``), both gradients are averaged over the
ranks, the metrics are the global batch's, and only rank 0 writes files.
"""
from __future__ import annotations

import math
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from sleepgen_torch.config import Config
from sleepgen_torch.data.dataset import WindowDataset
from sleepgen_torch.losses import (discriminator_adv_loss, generator_adv_loss, jukebox_loss,
                                   kl_gaussian)
from sleepgen_torch.nn.aekl import AutoencoderKL
from sleepgen_torch.nn.discriminator import PatchDiscriminator
from sleepgen_torch.parallel.mesh import Mesh, make_mesh
from sleepgen_torch.sample.sample_ldm import DTYPES, build_aekl
from sleepgen_torch.train.common import (AEKL_STREAM, latent_length, make_generator,
                                         windows_to_device)
from sleepgen_torch.train.evals import masked_epoch_mean
from sleepgen_torch.utils.checkpoint import CheckpointManager
from sleepgen_torch.utils.logging import setup_run_dir, split_loggers
from sleepgen_torch.utils.weights import aekl_state_to_jax, lecun_normal_state, load_numpy_state

METRICS = ("g_loss", "disc_loss", "recons_loss", "kl_loss", "gen_loss", "spec_loss")
# Layers the JAX AEKL zero-initialises: each attention's output projection.
ZERO_INIT_SUFFIXES = (".proj_attn.weight",)


def build_models(cfg: Config) -> Tuple[AutoencoderKL, PatchDiscriminator]:
    d = cfg.discriminator
    return build_aekl(cfg), PatchDiscriminator(d.num_layers_d, d.num_channels, d.in_channels,
                                               d.out_channels, d.kernel_size)


def build_trainer(cfg: Config, dev: torch.device | str):
    """(ae, disc, opt_g, opt_d) on ``dev``: fp32 master weights drawn from
    ``cfg.train.seed`` with the JAX package's initialisers, and Adam at
    ``cfg.losses``' rates."""
    with torch.device(dev):
        ae, disc = build_models(cfg)
    load_numpy_state(ae, lecun_normal_state(ae, cfg.train.seed, ZERO_INIT_SUFFIXES))
    load_numpy_state(disc, lecun_normal_state(disc, [cfg.train.seed, 1]))
    opt_g = torch.optim.Adam(ae.parameters(), lr=cfg.losses.optimizer_g_lr)
    opt_d = torch.optim.Adam(disc.parameters(), lr=cfg.losses.optimizer_d_lr)
    return ae, disc, opt_g, opt_d


def _autocast(x: torch.Tensor, dtype: torch.dtype):
    return torch.autocast(x.device.type, dtype=dtype, enabled=dtype != torch.float32)


def generator_losses(ae: AutoencoderKL, disc: PatchDiscriminator, x: torch.Tensor,
                     eps: torch.Tensor, spectral: bool,
                     compute_dtype: torch.dtype = torch.float32):
    """(recon, terms) of the G step on windows x (B, C, L) with the
    encoder's eps (B, latent_channels, L'): the L1, KL, generator LSGAN and
    spectral terms in fp32, the last with a gradient only when
    ``spectral``."""
    with _autocast(x, compute_dtype):
        recon, z_mu, z_sigma = ae(x, eps)
        logits_fake = disc(recon)[-1]
    x32, r32 = x.float(), recon.float()
    with torch.set_grad_enabled(spectral and torch.is_grad_enabled()):
        spec = jukebox_loss(r32, x32)
    return recon, dict(recons_loss=(r32 - x32).abs().mean(), kl_loss=kl_gaussian(z_mu, z_sigma),
                       gen_loss=generator_adv_loss(logits_fake), spec_loss=spec)


def make_train_step(ae: AutoencoderKL, disc: PatchDiscriminator, opt_g: torch.optim.Optimizer,
                    opt_d: torch.optim.Optimizer, cfg: Config,
                    compute_dtype: torch.dtype = torch.float32, mesh: Optional[Mesh] = None):
    """``step(x, eps) -> metrics``: the G step, then the D step, on windows
    x (B, C, L) with the encoder's eps given. The metrics (``METRICS``) are
    detached 0-d tensors on x's device. With a ``mesh``, x and eps are this
    rank's equal shard of the global batch's: the discriminator's
    BatchNorm is bound to the mesh, each gradient is averaged over the
    ranks and the metrics are the global batch's (the spectral term, a sum
    over windows, summed over the ranks)."""
    adv_w, kl_w, spec_w = cfg.losses.adv_weight, cfg.losses.kl_weight, cfg.losses.spectral_weight
    world = mesh.n_data if mesh is not None else 1
    if mesh is not None:
        mesh.bind(disc)

    def train_step(x: torch.Tensor, eps: torch.Tensor) -> Dict[str, torch.Tensor]:
        disc.requires_grad_(False)
        try:
            opt_g.zero_grad(set_to_none=True)
            recon, terms = generator_losses(ae, disc, x, eps, cfg.spectral, compute_dtype)
            g_loss = terms["recons_loss"] + kl_w * terms["kl_loss"] + adv_w * terms["gen_loss"]
            if cfg.spectral:  # a sum over the global batch: this rank's share, times the
                # ranks the gradient's mean divides by
                g_loss = g_loss + spec_w * world * terms["spec_loss"]
            g_loss.backward()
        finally:
            disc.requires_grad_(True)
        if mesh is not None:
            mesh.average_gradients(ae.parameters())
        opt_g.step()

        opt_d.zero_grad(set_to_none=True)
        with _autocast(x, compute_dtype):
            logits_fake = disc(recon.detach(), update_stats=True)[-1]
            logits_real = disc(x, update_stats=True)[-1]
        d_adv = discriminator_adv_loss(logits_fake, logits_real)
        (adv_w * d_adv).backward()
        if mesh is not None:
            mesh.average_gradients(disc.parameters())
        opt_d.step()
        metrics = dict(disc_loss=d_adv, **terms)
        if mesh is not None:
            metrics = {k: (mesh.sum if k == "spec_loss" else mesh.mean)(v)
                       for k, v in metrics.items()}
        g_loss = (metrics["recons_loss"] + kl_w * metrics["kl_loss"]
                  + adv_w * metrics["gen_loss"]
                  + (spec_w * metrics["spec_loss"] if cfg.spectral else 0.0))
        return {k: v.detach() for k, v in dict(g_loss=g_loss, **metrics).items()}

    return train_step


def make_eval_step(ae: AutoencoderKL, compute_dtype: torch.dtype = torch.float32):
    """``eval_step(x) -> (l1, recon)``: the reconstruction through the
    posterior mean, without autograd, and its per-sample L1 (B,) in fp32."""

    def eval_step(x: torch.Tensor):
        with torch.no_grad(), _autocast(x, compute_dtype):
            recon = ae.reconstruct(x)
        return (recon.float() - x.float()).abs().mean(dim=(1, 2)), recon

    return eval_step


def _log_val_figures(run_dir, epoch: int, pair: dict) -> None:
    """The reconstruction and PSD-overlay figures of one validation window
    (the reference's cadence: every val interval,
    train_autoencoderkl.py:262-283). A failure is printed, never raised:
    figures must not stop a training run."""
    if not pair:
        return
    try:
        from sleepgen_torch.eval.reports import save_reconstruction_figure, save_spectral_figure

        save_reconstruction_figure(run_dir, epoch, pair["orig"], pair["recon"])
        save_spectral_figure(run_dir, epoch, pair["orig"], pair["recon"])
    except Exception as e:
        print(f"figure logging failed at epoch {epoch}: {e}", flush=True)


@dataclass
class AEKLTrainResult:
    run_dir: str
    best_loss: float
    last_epoch: int
    stopped_on_nan: bool = False


def train_aekl(cfg: Config, train_ds: WindowDataset, valid_ds: WindowDataset,
               run_name: Optional[str] = None, device: torch.device | str = "cuda",
               mesh: Optional[Mesh] = None) -> AEKLTrainResult:
    """Train the AEKL on ``train_ds``; writes the run dir under
    ``cfg.train.output_dir`` (config.yaml, metrics_*.jsonl, checkpoints/,
    best_model/, final_model/). ``mesh``: data-parallel over its ranks
    (default: the world of one on ``device``)."""
    mesh = mesh or make_mesh(device=device)
    dev, main, n_dev = mesh.device, mesh.is_main, mesh.n_data
    dtype = DTYPES[cfg.dtype]
    seed, bs = cfg.train.seed, cfg.train.batch_size

    spe = "spectral" if cfg.spectral else "no-spectral"
    run_name = run_name or f"aekl_eeg_{spe}_{cfg.dataset}"
    run_dir, resume = setup_run_dir(cfg.train.output_dir, run_name)
    if main:
        cfg.to_yaml(run_dir / "config.yaml")
    logger_t, logger_v = split_loggers(run_dir, main)
    ckpt = CheckpointManager(run_dir)

    ae, disc, opt_g, opt_d = build_trainer(cfg, dev)
    step, best_loss = 0, math.inf
    if resume and (restored := ckpt.restore_latest()) is not None:
        ae.load_state_dict(restored["params_g"])
        opt_g.load_state_dict(restored["opt_g"])
        disc.load_state_dict(restored["params_d"])
        opt_d.load_state_dict(restored["opt_d"])
        step, best_loss = restored["step"], restored["best_loss"]

    train_step = make_train_step(ae, disc, opt_g, opt_d, cfg, dtype, mesh)
    eval_step = make_eval_step(ae, dtype)

    def state() -> dict:
        return dict(step=step, params_g=ae.state_dict(), opt_g=opt_g.state_dict(),
                    params_d=disc.state_dict(), opt_d=opt_d.state_dict(), best_loss=best_loss)

    def batches(ds, rng, **kw):
        """(this rank's shard of each global batch on ``dev`` in ``dtype``,
        the global batch size)."""
        for batch in ds.epoch_batches(bs, rng, pad_multiple=n_dev, **kw):
            yield windows_to_device(mesh.shard(batch), dev).to(dtype), batch.shape[0]

    np_rng = np.random.default_rng(seed)
    latent_shape = (cfg.aekl.latent_channels, latent_length(cfg, train_ds.padded_window))
    steps_per_epoch = max(1, math.ceil(len(train_ds) / bs))
    start_epoch = step // steps_per_epoch
    last_epoch, stopped_on_nan = start_epoch, False
    for epoch in range(start_epoch, cfg.train.n_epochs):
        last_epoch = epoch
        t0 = time.perf_counter()
        metrics: List[Dict[str, torch.Tensor]] = []
        for x, n in batches(train_ds, np_rng):
            eps = torch.randn((n, *latent_shape), device=dev,
                              generator=make_generator(seed, dev, AEKL_STREAM, step))
            metrics.append(train_step(x, mesh.shard(eps)))
            step += 1
        m = {k: float(torch.stack([s[k] for s in metrics]).mean()) for k in METRICS}
        logger_t.log(epoch, {**m, "seconds": time.perf_counter() - t0})
        if not math.isfinite(m["g_loss"]):
            stopped_on_nan = True
            break
        if (epoch + 1) % cfg.train.val_interval == 0:
            first_pair = {}

            def losses(bi, batch):
                x, _ = batch
                l1, recon = eval_step(x)
                if bi == 0 and main:  # the figures plot sample 0 only
                    first_pair.update(orig=x[:1].float().cpu().numpy(),
                                      recon=recon[:1].float().cpu().numpy())
                return mesh.gather(l1)

            val_loss = masked_epoch_mean(len(valid_ds), batches(valid_ds, np_rng, shuffle=True),
                                         losses)
            logger_v.log(epoch, {"recons_loss": val_loss})
            improved = val_loss <= best_loss  # best before save
            if improved:
                best_loss = val_loss
            if main:
                _log_val_figures(run_dir, epoch, first_pair)
                st = state()
                ckpt.save(step, st)
                if improved:
                    ckpt.save_best(aekl_state_to_jax(st["params_g"]), cfg)

    if stopped_on_nan:  # the final model is the last finite checkpoint, if any
        final = ckpt.restore_latest()
    else:
        final = state()
        if main:
            ckpt.save(step, final)
    if final is not None and main:
        ckpt.save_best(aekl_state_to_jax(final["params_g"]), cfg, "final_model")
    logger_t.close()
    logger_v.close()
    return AEKLTrainResult(str(run_dir), best_loss, last_epoch, stopped_on_nan)
