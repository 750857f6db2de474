"""First-generation training: the v1 VAE against the v1 PatchGAN, then a
DDPM over its frozen latents.

Counterpart of ``sleepgen/train/train_v1.py`` (the reference's
``src/first_version/train_encoder.py`` and ``train_ddpm.py``). One encoder
step is the G step, then the D step, as the JAX step makes them:

  G: L1(recon, x) + kl_weight * KL + gan_weight * mean((D(recon) - 1)^2),
     the discriminator on the batch's BatchNorm statistics with no update
     of the running ones kept, and no gradient for its parameters;
  D: gan_weight * 0.5 * (mean(D(recon)^2) + mean((D(x) - 1)^2)) on the G
     step's recon (made before the G update), detached; the fake pass
     moves the running statistics and the real pass moves them again.

Each optimiser is optax's ``chain(clip_by_global_norm(1.0), adam(lr))``:
the gradients are scaled by min(1, c / ||g||) over all of the model's
leaves (optax's formula, without the 1e-6 that
``torch.nn.utils.clip_grad_norm_`` adds to the norm), then Adam, 1e-4 for
G and 5e-4 for D. The DDPM step encodes the batch with sampling under the
frozen VAE in fp32, draws t uniform in [0, T) and runs ``ddpm_v1.p_losses``
on ``UNet1d``; Adam at 2.5e-5, no clip.

Everything runs in fp32, as the JAX v1 models do. On the card every
GroupNorm runs K1 forward and K3 backward; the frozen encode and the
evaluation run K1 alone.

Random draws: every step takes its draws as arguments (the tests feed the
JAX package's: ``fold_in(rng, step)`` for the encoder's eps, then
``split(., 3)`` for the DDPM step's eps, t and noise). The trainers draw
them from ``common.make_generator`` on the training device, streams
``V1_ENCODER_STREAM``, ``V1_EVAL_STREAM`` and ``V1_DDPM_STREAM``, and
the crops from ``numpy.random.default_rng(seed)`` in the JAX trainers'
order.

Data parallelism (``mesh``): each rank takes its shard of the global
batch and of its draws; both discriminator BatchNorms compute the global
batch's statistics, gradients are averaged over the ranks before the clip
(so its norm is the global gradient's, as optax's over the sharded batch),
the metrics are the global batch's, and only rank 0 writes files. JAX's
v1 pipeline has no command line, so the port adds none.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from sleepgen_torch.data.dataset import WindowDataset
from sleepgen_torch.diffusion.ddpm_v1 import DDPMTables, p_losses
from sleepgen_torch.losses import kl_gaussian
from sleepgen_torch.nn.aekl_v1 import AutoencoderKLV1
from sleepgen_torch.nn.discriminator import DiscriminatorV1
from sleepgen_torch.nn.unet1d import UNet1d
from sleepgen_torch.parallel.mesh import Mesh, make_mesh
from sleepgen_torch.train.common import (V1_DDPM_STREAM, V1_ENCODER_STREAM, V1_EVAL_STREAM,
                                         make_generator, windows_to_device)
from sleepgen_torch.train.train_ldm import init_unet_state
from sleepgen_torch.utils.checkpoint import CheckpointManager
from sleepgen_torch.utils.device import resolve_device
from sleepgen_torch.utils.logging import split_loggers
from sleepgen_torch.utils.weights import (aekl_v1_state_to_jax, lecun_normal_state,
                                          load_numpy_state, unet_state_to_jax)

ENCODER_METRICS = ("loss", "loss_d", "loss_l1", "loss_kl", "loss_g")
DDPM_METRICS = ("loss", "loss_simple", "loss_vlb")
# the JAX v1 AEKL's zero-initialised layers: each attention's output projection
AEKL_V1_ZERO_INIT = ("proj_out.weight",)


@dataclass
class V1EncoderState:
    ae: AutoencoderKLV1
    disc: DiscriminatorV1
    opt_g: torch.optim.Optimizer
    opt_d: torch.optim.Optimizer
    clip_norm: float = 1.0
    step: int = 0


def clip_by_global_norm_(params: Sequence[torch.nn.Parameter],
                         max_norm: float) -> torch.Tensor:
    """optax's ``clip_by_global_norm``, in place on the gradients of
    ``params``: g * min(1, max_norm / ||g||) with ||g|| over every leaf.
    Returns the norm before the clip, a 0-d tensor on the device (nothing
    is read back)."""
    grads = [p.grad for p in params if p.grad is not None]
    norm = torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(g) for g in grads]))
    scale = torch.where(norm < max_norm, torch.ones_like(norm), max_norm / norm)
    torch._foreach_mul_(grads, scale)
    return norm


def init_v1_encoder_state(ae: AutoencoderKLV1, disc: DiscriminatorV1, seed: int,
                          lr_g: float = 1e-4, lr_d: float = 5e-4, clip_norm: float = 1.0,
                          device: torch.device | str = "cuda") -> V1EncoderState:
    """The models on ``device`` with weights drawn with numpy from ``seed``
    by the JAX package's initialisers (lecun-normal kernels, zero biases,
    GroupNorm and BatchNorm scales one, each attention's output projection
    zero), and their Adams; the clip sits in the step, as it sits in the
    JAX optimisers' chain."""
    dev = resolve_device(device)
    ae, disc = ae.to(dev), disc.to(dev)
    load_numpy_state(ae, lecun_normal_state(ae, [seed, 0], AEKL_V1_ZERO_INIT))
    load_numpy_state(disc, lecun_normal_state(disc, [seed, 1]))
    return V1EncoderState(ae, disc, torch.optim.Adam(ae.parameters(), lr=lr_g),
                          torch.optim.Adam(disc.parameters(), lr=lr_d), clip_norm)


def make_v1_encoder_train_step(state: V1EncoderState, kl_weight: float = 1e-6,
                               gan_weight: float = 0.01, mesh: Optional[Mesh] = None):
    """``step(x, eps) -> metrics``: the G step, then the D step, on windows
    x (B, 1, L) with the encoder's eps (B, embed_dim, L'), updating
    ``state`` in place. Metrics (``ENCODER_METRICS``, plus each model's
    gradient norm before the clip, ``grad_norm_g`` and ``grad_norm_d``)
    are detached 0-d tensors on x's device. With a ``mesh``, x and eps are
    this rank's equal shard of the global batch's (module docstring)."""
    ae, disc = state.ae, state.disc
    if mesh is not None:
        mesh.bind(disc)

    def average(model):
        if mesh is not None:
            mesh.average_gradients(model.parameters())

    def train_step(x: torch.Tensor, eps: torch.Tensor) -> Dict[str, torch.Tensor]:
        ae.train()
        disc.train()
        disc.requires_grad_(False)
        try:
            state.opt_g.zero_grad(set_to_none=True)
            recon, z_mu, z_sigma = ae(x, eps)
            l1 = (recon.float() - x.float()).abs().mean()
            kl = kl_gaussian(z_mu, z_sigma)
            g_adv = (disc(recon).float() - 1.0).square().mean()
            loss = l1 + kl_weight * kl + gan_weight * g_adv
            loss.backward()
        finally:
            disc.requires_grad_(True)
        average(ae)
        norm_g = clip_by_global_norm_(list(ae.parameters()), state.clip_norm)
        state.opt_g.step()

        state.opt_d.zero_grad(set_to_none=True)
        fake = disc(recon.detach(), update_stats=True).float()
        real = disc(x, update_stats=True).float()
        loss_d = gan_weight * 0.5 * (fake.square().mean() + (real - 1.0).square().mean())
        loss_d.backward()
        average(disc)
        norm_d = clip_by_global_norm_(list(disc.parameters()), state.clip_norm)
        state.opt_d.step()
        state.step += 1
        out = dict(loss=loss, loss_d=loss_d, loss_l1=l1, loss_kl=kl, loss_g=g_adv)
        if mesh is not None:
            out = {k: mesh.mean(v) for k, v in out.items()}
        out.update(grad_norm_g=norm_g, grad_norm_d=norm_d)
        return {k: v.detach() for k, v in out.items()}

    return train_step


def draw_v1_ddpm_inputs(gen: torch.Generator, batch: int, latent_shape: Tuple[int, int],
                        timesteps: int):
    """One DDPM step's draws from ``gen``, in the JAX step's split order:
    the encoder's eps (B, embed_dim, L'), t (B,) in [0, T), the noise."""
    dev = gen.device
    eps = torch.randn((batch, *latent_shape), generator=gen, device=dev)
    t = torch.randint(0, timesteps, (batch,), generator=gen, device=dev)
    noise = torch.randn((batch, *latent_shape), generator=gen, device=dev)
    return eps, t, noise


def make_v1_ddpm_train_step(tbl: DDPMTables, unet: UNet1d, ae: AutoencoderKLV1,
                            opt: torch.optim.Optimizer, mesh: Optional[Mesh] = None):
    """``step(x, eps, t, noise) -> metrics``: a posterior sample z of x
    (B, 1, L) under the frozen ``ae`` (eps (B, embed_dim, L')) in fp32,
    then ``p_losses`` of the UNet at t with the noise, and one step of
    ``opt``. Metrics (``DDPM_METRICS``) are detached 0-d tensors. With a
    ``mesh`` the inputs are this rank's equal shard of the global batch's,
    the gradient is averaged over the ranks and the metrics are the global
    means."""

    def train_step(x, eps, t, noise) -> Dict[str, torch.Tensor]:
        with torch.no_grad():
            z = ae.get_ldm_inputs(x, eps).float()
        unet.train()
        opt.zero_grad(set_to_none=True)
        loss, aux = p_losses(tbl, unet, z, t, noise)
        loss.backward()
        if mesh is not None:
            mesh.average_gradients(unet.parameters())
            aux = {k: mesh.mean(v) for k, v in aux.items()}
        opt.step()
        return {k: v.detach() for k, v in aux.items()}

    return train_step


def _epoch_metrics(metrics: Optional[Dict[str, torch.Tensor]]) -> Dict[str, float]:
    return {k: float(v) for k, v in (metrics or {}).items()}


def train_v1_encoder(train_ds: WindowDataset, valid_ds: WindowDataset, run_dir: str | Path,
                     n_epochs: int = 10, batch_size: int = 16, val_interval: int = 5,
                     lr_g: float = 1e-4, lr_d: float = 5e-4, kl_weight: float = 1e-6,
                     gan_weight: float = 0.01, n_channels: int = 64, embed_dim: int = 3,
                     z_channels: int = 3, ch_mult: Sequence[int] = (1, 2, 4),
                     num_groups: int = 32, seed: int = 2, device: torch.device | str = "cuda",
                     mesh: Optional[Mesh] = None) -> Tuple[float, V1EncoderState]:
    """Train the v1 VAE against ``DiscriminatorV1`` on ``train_ds``; every
    ``val_interval`` epochs the L1 of the reconstruction through a sampled
    z on ``valid_ds``, a checkpoint and, when it is no worse than the best
    so far, ``best_model/``; ``final_model/`` at the end. Both are port run
    dirs of ``params.npz`` in the JAX ``AutoencoderKLV1``'s keys, without
    a config. Returns (best validation L1, the state). ``mesh``:
    data-parallel over its ranks (default: the world of one on
    ``device``)."""
    mesh = mesh or make_mesh(device=device)
    dev, main = mesh.device, mesh.is_main
    window = train_ds.padded_window
    ae = AutoencoderKLV1(embed_dim=embed_dim, n_channels=n_channels, z_channels=z_channels,
                         ch_mult=tuple(ch_mult), resolution=window, num_groups=num_groups)
    state = init_v1_encoder_state(ae, DiscriminatorV1(), seed, lr_g, lr_d, device=dev)
    step = make_v1_encoder_train_step(state, kl_weight, gan_weight, mesh)
    latent_shape = (embed_dim, window // 2 ** (len(ch_mult) - 1))
    logger, _ = split_loggers(run_dir, main)
    ckpt = CheckpointManager(run_dir)
    np_rng = np.random.default_rng(seed)
    best = math.inf
    for epoch in range(n_epochs):
        metrics = None
        for batch in train_ds.epoch_batches(batch_size, np_rng, pad_multiple=mesh.n_data):
            x = windows_to_device(mesh.shard(batch), dev)
            gen = make_generator(seed, dev, V1_ENCODER_STREAM, state.step)
            eps = torch.randn((batch.shape[0], *latent_shape), generator=gen, device=dev)
            metrics = step(x, mesh.shard(eps))
        logger.log(epoch, _epoch_metrics(metrics))
        if (epoch + 1) % val_interval == 0:
            total, n = torch.zeros((), device=dev), 0
            with torch.no_grad():
                for bi, batch in enumerate(valid_ds.epoch_batches(
                        batch_size, np_rng, pad_multiple=mesh.n_data)):
                    x = windows_to_device(mesh.shard(batch), dev)
                    z_mu, z_sigma = state.ae.encode(x)
                    eps = torch.randn((batch.shape[0], *z_mu.shape[1:]), device=dev,
                                      dtype=z_sigma.dtype,
                                      generator=make_generator(seed, dev, V1_EVAL_STREAM,
                                                               epoch, bi))
                    recon = state.ae.decode(state.ae.sampling(z_mu, z_sigma, mesh.shard(eps)))
                    total += mesh.mean((recon - x).abs().mean())
                    n += 1
            val = float(total) / max(n, 1)
            if main:
                ckpt.save(epoch + 1, dict(step=state.step, params_g=state.ae.state_dict(),
                                          opt_g=state.opt_g.state_dict(),
                                          params_d=state.disc.state_dict(),
                                          opt_d=state.opt_d.state_dict(), best_loss=best))
            if val <= best:
                best = val
                if main:
                    ckpt.save_best(aekl_v1_state_to_jax(state.ae.state_dict()), None)
    if main:
        ckpt.save_best(aekl_v1_state_to_jax(state.ae.state_dict()), None, "final_model")
    logger.close()
    return best, state


def train_v1_ddpm(train_ds: WindowDataset, stage1_state, run_dir: str | Path,
                  ae: AutoencoderKLV1, n_epochs: int = 10, batch_size: int = 16,
                  base_lr: float = 2.5e-5, timesteps: int = 1000, unet: UNet1d | None = None,
                  seed: int = 2, device: torch.device | str = "cuda",
                  mesh: Optional[Mesh] = None) -> UNet1d:
    """Train a DDPM (``UNet1d`` mc 64, channel_mult (1, 2), attention at ds
    2, unless ``unet`` is given) over the latents of the frozen ``ae``,
    loaded with ``stage1_state`` (its state dict), with the tables
    ``("linear", timesteps, 0.0015, 0.0195)``; writes ``final_model/`` (a
    port run dir of ``params.npz`` in the JAX ``UNet1d``'s keys, without a
    config). Returns the trained UNet. ``mesh``: data-parallel over its
    ranks (default: the world of one on ``device``)."""
    mesh = mesh or make_mesh(device=device)
    dev, main = mesh.device, mesh.is_main
    window = train_ds.padded_window
    latent_shape = (ae.embed_dim, window // 2 ** (len(ae.ch_mult) - 1))
    unet = unet or UNet1d(in_channels=ae.embed_dim, out_channels=ae.embed_dim,
                          model_channels=64, channel_mult=(1, 2), attention_resolutions=(2,))
    unet = load_numpy_state(unet.to(dev), init_unet_state(unet, seed))
    ae = load_numpy_state(ae.to(dev), stage1_state).eval().requires_grad_(False)
    opt = torch.optim.Adam(unet.parameters(), lr=base_lr)
    tbl = DDPMTables.create("linear", timesteps, 0.0015, 0.0195, device=dev)
    step = make_v1_ddpm_train_step(tbl, unet, ae, opt, mesh)
    logger, _ = split_loggers(run_dir, main)
    np_rng = np.random.default_rng(seed)
    i = 0
    for epoch in range(n_epochs):
        metrics = None
        for batch in train_ds.epoch_batches(batch_size, np_rng, pad_multiple=mesh.n_data):
            x = windows_to_device(mesh.shard(batch), dev)
            gen = make_generator(seed, dev, V1_DDPM_STREAM, i)
            draws = draw_v1_ddpm_inputs(gen, batch.shape[0], latent_shape, timesteps)
            metrics = step(x, *(mesh.shard(v) for v in draws))
            i += 1
        logger.log(epoch, _epoch_metrics(metrics))
    if main:
        CheckpointManager(run_dir).save_best(unet_state_to_jax(unet.state_dict()), None,
                                             "final_model")
    logger.close()
    return unet
