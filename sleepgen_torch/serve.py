"""Serving: a process-resident LDM sampling service.

Counterpart of ``sleepgen/serve.py``. Models load once, onto the card, and
each request's seeds run in batches of ``batch_size`` through one sampler
per (batch, guided) pair; requests return cropped signals (and optional
PSDs). A request is queued on the card without waiting
(``sample_async``): its noise goes up from pinned memory, the loops read
nothing back, and each chunk's copy to the host is queued behind it, so a
server can queue request k + 1 before it writes request k's artifacts.

``mesh`` (``sleepgen_torch.parallel``): every rank runs the service, and
each chunk's seeds split over the ranks as ``make_ldm_sampler``'s do; each
rank gets every window back. Left out of the JAX service on purpose:
``base_key`` / ``base_seed``: the port maps a seed to its noise its own
way (``samplers.seed_noise``), and no caller of the JAX service outside
the service sets them.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from sleepgen_torch.config import Config
from sleepgen_torch.parallel.mesh import Mesh
from sleepgen_torch.sample.sample_ldm import (build_models, make_ldm_sampler, padded_chunks,
                                              read_run_dirs, sampling_schedule, stage_labels)
from sleepgen_torch.sample.samplers import validate_stage
from sleepgen_torch.utils.device import resolve_device
from sleepgen_torch.utils.profiling import span


def _queue_host_copy(out: torch.Tensor) -> Tuple[torch.Tensor, Optional[torch.cuda.Event]]:
    """A host tensor that will hold ``out``, and the event after which it
    does. On the card the copy goes to pinned memory, queued behind the
    work that makes ``out``, so waiting for it later does not wait for
    work queued after it."""
    if out.device.type != "cuda":
        return out, None
    host = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
    host.copy_(out, non_blocking=True)
    done = torch.cuda.Event()
    done.record()
    return host, done


@dataclass
class PendingSample:
    """A request queued on the card. ``result()`` is the only call that
    waits: for the request's copies to the host, then it trims the chunks'
    padding and sets the service's ``stats``. Made by
    :meth:`SamplerService.sample_async`."""

    _svc: "SamplerService"
    _chunks: Optional[List[Tuple[torch.Tensor, Optional[torch.cuda.Event]]]]
    _lens: List[int]
    _n: int
    _t0: float
    _out: Optional[np.ndarray] = None

    def result(self) -> np.ndarray:
        if self._chunks is None:  # idempotent: a second call returns the same array
            return self._out
        outs = []
        with span("service.wait"):
            for (host, done), n in zip(self._chunks, self._lens):
                if done is not None:
                    done.synchronize()
                outs.append(host.numpy()[:n])
        self._chunks = None
        self._out = np.concatenate(outs, axis=0)
        dt = time.perf_counter() - self._t0
        self._svc.stats = {"last_windows": self._n, "last_sec": dt,
                           "last_windows_per_sec": self._n / dt}
        return self._out


@dataclass
class SamplerService:
    """Process-resident LDM sampling service.

    >>> svc = SamplerService.from_run_dirs(aekl_dir, ldm_dir)
    >>> signals = svc.sample(seeds=range(256))        # (256, 3000, 1)

    ``unet_state`` and ``ae_state`` are the port's state dicts; the models
    are built on ``device`` in ``cfg.dtype`` when the service is made, and
    the sampler (``cfg.diffusion.sampler``, ``num_inference_steps``) is
    the LDM config's. With a ``mesh`` the models live on its device and
    ``batch_size`` must divide over its ranks."""

    cfg: Config
    aekl_cfg: Config
    unet_state: Mapping[str, np.ndarray]
    ae_state: Mapping[str, np.ndarray]
    scale_factor: float
    batch_size: int = 64
    device: torch.device | str = "cuda"
    mesh: Optional[Mesh] = None
    _samplers: Dict[Tuple[int, bool], Callable] = field(default_factory=dict, repr=False)
    stats: Dict[str, float] = field(default_factory=dict, repr=False)

    def __post_init__(self):
        if self.mesh is not None:
            assert self.batch_size % self.mesh.n_data == 0, (self.batch_size, self.mesh.n_data)
            self.device = self.mesh.device
        self.device = resolve_device(self.device)
        self._unet, self._ae = build_models(self.cfg, self.unet_state, self.ae_state,
                                            self.device, self.aekl_cfg)
        self._sched = sampling_schedule(self.cfg, self.device)

    @classmethod
    def from_run_dirs(cls, aekl_run_dir: str | Path, ldm_run_dir: str | Path,
                      batch_size: int = 64, device: torch.device | str = "cuda",
                      **kw) -> "SamplerService":
        """A service over port run dirs: the AEKL's (``config.yaml``,
        ``params.npz``) and the LDM's (the same plus ``scale_factor.txt``)."""
        cfg, aekl_cfg, unet_state, ae_state, scale_factor = read_run_dirs(aekl_run_dir,
                                                                          ldm_run_dir)
        return cls(cfg=cfg, aekl_cfg=aekl_cfg, unet_state=unet_state, ae_state=ae_state,
                   scale_factor=scale_factor, batch_size=batch_size, device=device, **kw)

    @property
    def conditional(self) -> bool:
        return self.cfg.num_classes > 0

    def _sampler(self, batch: int, guided: bool = False) -> Callable:
        """The sampler of one batch size, plain or guided. The guidance scale
        is an argument of each call, so the cache holds at most two entries
        per batch size, however many scales clients ask for."""
        key = (batch, guided)
        if key not in self._samplers:
            self._samplers[key] = make_ldm_sampler(
                self._unet, self._ae, self._sched, self.cfg.image_size,
                self.aekl_cfg.aekl.latent_channels, self.cfg.diffusion.num_inference_steps,
                sampler=self.cfg.diffusion.sampler, device=self.device,
                conditional=self.conditional, guided=guided, mesh=self.mesh)
        return self._samplers[key]

    def warmup(self) -> float:
        """One request of ``batch_size`` seeds ahead of traffic (for a
        conditional checkpoint, stage 0, plain and then guided): it builds
        or loads the kernels' library, and fills cuDNN's algorithm choices,
        K2's weight tiles and the caching allocator. Returns its seconds;
        ``stats`` is cleared, so the first real request reports steady
        state."""
        t0 = time.perf_counter()
        stage = 0 if self.conditional else None
        self.sample(range(self.batch_size), stage=stage)
        if self.conditional:
            self.sample(range(self.batch_size), stage=stage, guidance_scale=2.0)
        dt = time.perf_counter() - t0
        self.stats = {}
        return dt

    def sample_async(self, seeds: Sequence[int], stage: Optional[int] = None,
                     guidance_scale: float = 1.0) -> PendingSample:
        """Queue a request on the card and return without waiting for it.
        Every chunk of ``batch_size`` seeds is queued (a last partial one
        padded with its last seed), each followed by its copy to the host.
        Arguments are validated here, before anything is queued, so a bad
        request raises ValueError at once. ``PendingSample.result()``
        waits. A request is a ``service.enqueue`` span over its samplers'
        ``sampler.call`` spans; its waits a ``service.wait`` span."""
        with span("service.enqueue"):
            return self._enqueue(seeds, stage, guidance_scale)

    def _enqueue(self, seeds, stage, guidance_scale) -> PendingSample:
        guidance_scale = float(guidance_scale)
        validate_stage(self.cfg.num_classes, stage, guidance_scale)
        guided = self.conditional and guidance_scale != 1.0
        seeds = [int(s) for s in seeds]
        if not seeds:
            raise ValueError("a request needs at least one seed")
        sampler = self._sampler(self.batch_size, guided)
        labels = (stage_labels(stage, self.batch_size, self.device)
                  if self.conditional else None)
        t0 = time.perf_counter()
        chunks, lens = [], []
        for chunk, n in padded_chunks(seeds, self.batch_size):
            chunks.append(_queue_host_copy(sampler(self.scale_factor, chunk, labels,
                                                   guidance_scale)))
            lens.append(n)
        return PendingSample(self, chunks, lens, len(seeds), t0)

    def sample(self, seeds: Sequence[int], stage: Optional[int] = None,
               guidance_scale: float = 1.0) -> np.ndarray:
        """Windows for ``seeds`` -> (N, window, 1) float32, each seed's the
        same however the seeds are batched. ``stage``: the class label,
        required for a conditional checkpoint (``cfg.num_classes`` > 0)
        and range-checked; ``guidance_scale`` other than 1 adds
        classifier-free guidance."""
        return self.sample_async(seeds, stage=stage, guidance_scale=guidance_scale).result()

    def sample_with_psd(self, seeds: Sequence[int], stage: Optional[int] = None,
                        guidance_scale: float = 1.0):
        """(signals, psds_db, freqs): the signals and their dB DPSS
        multitaper PSD up to 18 Hz, the sampling CLI's artifact set."""
        from sleepgen_torch.eval.psd import multitaper_psd_db

        sigs = self.sample(seeds, stage=stage, guidance_scale=guidance_scale)
        psds, freqs = multitaper_psd_db(sigs[..., 0], fmax=18.0)
        return sigs, psds, freqs
