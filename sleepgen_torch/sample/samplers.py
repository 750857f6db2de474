"""Per-seed initial noise, the DDIM and DDPM reverse loops, the model
closure of conditional and guided sampling, and RePaint imputation in
signal and latent space.

Counterpart of ``sleepgen/sample/samplers.py``. The loops are Python loops
over the timesteps; x stays fp32 and the model output is cast to fp32
before each step, whatever the model's compute dtype. Nothing in them reads
a value back from the card, so a caller's sample runs behind the host.

The DDIM loop on a CUDA tensor without autograd replays each step as one
CUDA graph (``ddim_sample_loop``): the host then does one graph launch a
step, where the eager step dispatches some hundreds of kernels from Python.

Noise of the ancestral loops is a ``schedules.Noise``.
"""
from __future__ import annotations

import weakref
from typing import Callable, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from sleepgen_torch.diffusion.schedules import (Noise, NoiseSchedule, ddim_tables, ddim_update,
                                                ddpm_step, draw_noise)
from sleepgen_torch.kernels import fused_resblock
from sleepgen_torch.utils import profiling
from sleepgen_torch.utils.profiling import span

# CUDA graphs of the DDIM step in this process: captures and replays, and
# the replays made while the tracer records
profiling.register("sampler.graph_captures", "sampler.graph_replays")
profiling.register("sampler.traced_graph_replays", traced=True)
# model closure -> schedule -> {(x's shape, device, table length): _StepGraph};
# an entry goes when its closure or its schedule is freed
_graphs = weakref.WeakKeyDictionary()


def seed_noise(seeds: Sequence[int], shape: Tuple[int, ...],
               device: torch.device | str) -> torch.Tensor:
    """(len(seeds), *shape) standard normal fp32 noise, one CPU
    ``torch.Generator`` per seed, then moved to ``device``.

    Each seed's noise depends on that seed alone, so a sample does not
    depend on how seeds are batched or on the device. It is not the JAX
    package's noise: that one comes from threefry ``fold_in`` of a base
    key, which torch cannot reproduce, so the two packages give different
    samples for the same seed. Parity tests hand both the same x_T.

    To a CUDA device the noise goes from pinned memory without waiting: a
    copy from pageable memory would wait for the work already queued on
    the stream, such as the previous request's sampler."""
    with span("sampler.noise"):
        noise = torch.stack([torch.randn(shape, generator=torch.Generator().manual_seed(int(s)))
                             for s in seeds])
        dev = torch.device(device)
        if dev.type == "cuda":
            return noise.pin_memory().to(dev, non_blocking=True)
        return noise.to(dev)


def validate_stage(num_classes: int, stage, guidance_scale: float = 1.0) -> None:
    """Validate the arguments of conditional sampling, as the JAX package's
    ``validate_stage`` does, with the same errors for the same inputs.

    Raises ValueError when ``stage`` is missing or out of range for a
    conditional checkpoint, or when ``stage`` or ``guidance_scale`` is
    given for an unconditional one. Without the range check a negative
    stage would silently sample the guidance null branch (``UNet1d`` masks
    labels below 0 to a zero embedding) and a large one would silently
    clamp to the last class."""
    if num_classes > 0:
        if stage is None:
            raise ValueError(
                f"conditional checkpoint (num_classes={num_classes}): "
                f"pass stage=0..{num_classes - 1}")
        if not 0 <= int(stage) < num_classes:
            raise ValueError(
                f"stage {stage} out of range 0..{num_classes - 1}")
    else:
        if stage is not None:
            raise ValueError(
                "stage given but the checkpoint is unconditional "
                "(config.unet.num_classes=0)")
        if guidance_scale != 1.0:
            raise ValueError(
                "guidance_scale requires a class-conditional checkpoint "
                "(config.unet.num_classes=0 here) — it would be silently "
                "ignored")


def cond_model_fn(unet: Callable[..., torch.Tensor], labels: Optional[torch.Tensor],
                  guidance_scale: Optional[float], guided: Optional[bool] = None
                  ) -> Callable[[torch.Tensor, torch.Tensor], torch.Tensor]:
    """The model closure ``model_fn(x, t)`` of every sampling loop: plain
    (``labels`` None), conditional, ``unet(x, t, labels)``, or guided by
    classifier-free guidance. Counterpart of the JAX package's
    ``_cond_model_fn``.

    Guided runs one forward of the 2B batch ``[x, x]`` at ``[t, t]`` with
    the labels ``[labels, -1]`` (-1 is the null label the UNet masks), then
    returns ``v_n + s (v_c - v_n)`` in fp32: never two forwards of B.
    ``guided`` None guides when ``guidance_scale`` is not 1.0; a sampler
    whose scale is an argument of each call decides it once instead."""
    if guided is None:
        guided = guidance_scale != 1.0
    if labels is None:
        return unet
    if not guided:
        return lambda x, t: unet(x, t, labels)
    y2 = torch.cat([labels, torch.full_like(labels, -1)])

    def model_fn(x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        v_c, v_n = unet(torch.cat([x, x]), torch.cat([t, t]), y2).float().chunk(2)
        return v_n + guidance_scale * (v_c - v_n)

    return model_fn


def ddim_step_fn(model_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
                 sched: NoiseSchedule, tables: Sequence[torch.Tensor], eta: float = 0.0
                 ) -> Callable[[torch.Tensor, torch.Tensor], torch.Tensor]:
    """One DDIM step that serves every step of a loop: ``step(x, i)`` runs
    step ``i`` (a (1,) int64 tensor on x's device) of ``tables``
    (``ddim_tables``' timesteps, acp_t and acp_prev), gathering them on
    the device, returns x at the next timestep and adds 1 to ``i`` in
    place. The model call is followed by a ``sampler.update`` span."""
    ts, acp_t, acp_prev = tables

    def step(x: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
        shape = (1,) * x.dim()
        out = model_fn(x, ts.index_select(0, i).expand(x.shape[0]))
        with span("sampler.update"):
            x, _ = ddim_update(sched, out.float(), x, acp_t.index_select(0, i).reshape(shape),
                               acp_prev.index_select(0, i).reshape(shape), eta=eta)
        i.add_(1)
        return x

    return step


def ddim_sample_loop(model_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
                     sched: NoiseSchedule, x_T: torch.Tensor,
                     num_inference_steps: int = 200, eta: float = 0.0) -> torch.Tensor:
    """Full deterministic DDIM reverse process from x_T (any layout the
    model takes); returns x_0 in fp32, in a tensor of the caller's. Each
    iteration is a ``sampler.step`` span.

    On a CUDA tensor without autograd the steps replay one CUDA graph of
    ``ddim_step_fn`` (``_StepGraph``), kept for later calls with the same
    model closure, schedule, shape and device; the first call runs step 0
    eagerly, then captures (a ``sampler.capture`` span) and replays the
    rest. Otherwise each step runs eagerly, its DDIM update a
    ``sampler.update`` span inside the step's. Both run the same step, so
    they give the same bits."""
    tables = ddim_tables(sched, num_inference_steps, x_T.device)
    if x_T.is_cuda and not torch.is_grad_enabled():
        return _ddim_graph_loop(model_fn, sched, x_T, tables, eta)
    step = ddim_step_fn(model_fn, sched, tables, eta)
    x = x_T.float()
    i = torch.zeros(1, dtype=torch.int64, device=x.device)
    for _ in range(num_inference_steps):
        with span("sampler.step"):
            x = step(x, i)
    return x


class _StepGraph:
    """One DDIM step captured as a CUDA graph over static buffers: x, the
    step index and tables of ``length`` steps, into which each call copies
    its x_T and its ``ddim_tables``. The graph reads K2's weight tiles by
    address, so it is stale once any tile K2 had at the capture has been
    re-laid out or freed or its weight updated in place
    (``fused_resblock.tiles_current``); the weights that cuDNN, K1 and the
    casts read are read in place (a DiT's step reads all its weights in
    place: cuBLAS, SDPA, LayerNorm). It holds no reference to
    the model closure, and its buffers serve one call at a time (one thread's).
    eta is not in its key: a step with eta > 0 needs noise, which the loop
    does not draw, so its first, eager step raises."""

    def __init__(self, shape: torch.Size, device: torch.device, length: int):
        with torch.inference_mode(False):  # buffers any later call may write
            self.x = torch.empty(shape, dtype=torch.float32, device=device)
            self.i = torch.zeros(1, dtype=torch.int64, device=device)
            self.tables = (torch.zeros(length, dtype=torch.int64, device=device),
                           torch.ones(length, device=device), torch.ones(length, device=device))
        self.graph = None
        self.counts = None  # what the capture counted, added again per replay
        self.tiles = ()

    def load(self, x_T: torch.Tensor, tables: Sequence[torch.Tensor]) -> None:
        self.x.copy_(x_T)
        self.i.zero_()
        for static, t in zip(self.tables, tables):
            static[:len(t)].copy_(t)

    def capture(self, step: Callable) -> None:
        before = profiling.snapshot_counts()
        graph = torch.cuda.CUDAGraph()
        stream = torch.cuda.Stream(self.x.device)
        stream.wait_stream(torch.cuda.current_stream(self.x.device))
        with span("sampler.capture"), torch.cuda.stream(stream):
            graph.capture_begin()
            try:
                self.x.copy_(step(self.x, self.i))
            finally:
                graph.capture_end()
        torch.cuda.current_stream(self.x.device).wait_stream(stream)
        # a capture runs nothing: what it counted is counted at each replay
        self.graph, self.counts = graph, profiling.take_back_counts(before)
        self.tiles = fused_resblock.tiles_in_use()
        profiling.count("sampler.graph_captures")

    def fresh(self) -> bool:
        """Whether K2's tiles at the capture are all still current."""
        return fused_resblock.tiles_current(self.tiles)

    def replay(self, n: int) -> None:
        """``n`` steps, each a ``sampler.step`` span around one replay; the
        always-on counters gain the capture's counts per replay."""
        for _ in range(n):
            with span("sampler.step"):
                self.graph.replay()
            profiling.count("sampler.traced_graph_replays")
        profiling.count("sampler.graph_replays", n)
        profiling.add_counts(self.counts, n)


def _graphs_of(model_fn: Callable, sched: NoiseSchedule) -> dict:
    try:
        by_sched = _graphs.setdefault(model_fn, weakref.WeakKeyDictionary())
    except TypeError:  # a closure without weak references keeps its graph for one call
        by_sched = weakref.WeakKeyDictionary()
    return by_sched.setdefault(sched, {})


def _ddim_graph_loop(model_fn: Callable, sched: NoiseSchedule, x_T: torch.Tensor,
                     tables: Sequence[torch.Tensor], eta: float) -> torch.Tensor:
    n = len(tables[0])
    graphs = _graphs_of(model_fn, sched)
    key = (tuple(x_T.shape), x_T.device, max(sched.num_timesteps, n))
    g = graphs.get(key)
    captured = g is not None and g.fresh()
    if not captured:
        g = _StepGraph(x_T.shape, x_T.device, key[2])
    g.load(x_T, tables)
    if not captured:
        step = ddim_step_fn(model_fn, sched, g.tables, eta)
        with span("sampler.step"):  # settles first-call work and K2's tiles
            g.x.copy_(step(g.x, g.i))
        g.capture(step)
        graphs[key] = g
    g.replay(n if captured else n - 1)
    return g.x.clone()


def ddpm_sample_loop(model_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
                     sched: NoiseSchedule, x_T: torch.Tensor, generator: Noise,
                     clip_sample: bool = True) -> torch.Tensor:
    """Full ancestral DDPM loop over every training timestep, from x_T;
    each step draws one noise of x's shape from ``generator`` (a
    ``Noise``), t = 0 included. Returns x_0 in fp32. JAX splits a threefry
    key instead, so the two packages draw different noise; parity tests
    inject it step by step. Spans as ``ddim_sample_loop``'s; the update
    holds the step's noise draw."""
    x = x_T.float()
    for t in range(sched.num_timesteps - 1, -1, -1):
        with span("sampler.step"):
            t_b = torch.full((x.shape[0],), t, dtype=torch.int64, device=x.device)
            out = model_fn(x, t_b)
            with span("sampler.update"):
                x, _ = ddpm_step(sched, out.float(), t, x, draw_noise(generator, x),
                                 clip_sample=clip_sample)
    return x


def ddpm_inpaint_loop(model_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
                      sched: NoiseSchedule, x_known: torch.Tensor, mask: torch.Tensor,
                      noise: Noise, num_resample: int = 1,
                      clip_sample: bool = True) -> torch.Tensor:
    """Masked ancestral sampling (RePaint, Lugmayr et al. 2022): fills the
    region of ``x_known`` where ``mask`` (broadcastable to it) is 0.

    At every reverse step t the observed region (mask 1) is renoised onto
    q(x_t | x_known) and spliced in, the model denoises the whole window,
    and with ``num_resample`` > 1 every pass but the last jumps back one
    forward step with betas[t] and denoises again. The result is spliced
    exactly: ``mask * x_known + (1 - mask) * x``.

    Draws from ``noise``, in order: x_T; then per step, from t = T - 1 down
    to 0, and per pass u: the forward noise of the splice, the reverse
    step's noise, and, for u < num_resample - 1 only, the jump's noise.
    That is the JAX loop's order of use of its keys (x_T from k_init; per
    pass ``key, k_f, k_r, k_j = split(key, 4)``, k_j drawn only on a jump)."""
    x_known = x_known.float()
    mask = mask.to(device=x_known.device, dtype=torch.float32)
    x = draw_noise(noise, x_known)
    for t in range(sched.num_timesteps - 1, -1, -1):
        t_b = torch.full((x.shape[0],), t, dtype=torch.int64, device=x.device)
        for u in range(num_resample):
            x_known_t = sched.add_noise(x_known, draw_noise(noise, x), t)
            x = mask * x_known_t + (1.0 - mask) * x
            out = model_fn(x, t_b)
            x_prev, _ = ddpm_step(sched, out.float(), t, x, draw_noise(noise, x),
                                  clip_sample=clip_sample)
            if u < num_resample - 1:  # jump back: one forward step x_{t-1} -> x_t
                beta = sched.betas[t]
                x = torch.sqrt(1.0 - beta) * x_prev + torch.sqrt(beta) * draw_noise(noise, x)
            else:
                x = x_prev
    return mask * x_known + (1.0 - mask) * x


def impute_dm(unet: Callable[..., torch.Tensor], sched: NoiseSchedule, x_known: torch.Tensor,
              mask: torch.Tensor, noise: Noise, labels: Optional[torch.Tensor] = None,
              num_resample: int = 1, guidance_scale: float = 1.0) -> torch.Tensor:
    """Fill the masked region of windows ``x_known`` (B, C, L) with a
    signal-space DM: ``ddpm_inpaint_loop`` over ``cond_model_fn`` (plain,
    stage-conditional with ``labels``, or guided when ``guidance_scale`` is
    not 1), with clipping to [-1, 1]."""
    model_fn = cond_model_fn(unet, labels, guidance_scale)
    return ddpm_inpaint_loop(model_fn, sched, x_known, mask, noise, num_resample=num_resample)


def latent_observed_mask(mask: torch.Tensor, latent_len: int, erode: int = 4) -> torch.Tensor:
    """Signal-space observed mask (B, 1, L) -> latent anchor mask
    (B, 1, latent_len), conservatively, as the JAX package's.

    A latent position is observed only if every signal sample it covers is
    (the min over each group of L / latent_len samples); the observed region
    is then eroded by ``erode`` latent positions on each side, as the
    encoder's receptive field reaches past its stride into the masked span.
    The window's ends count as observed (JAX's ``reduce_window(min)`` under
    SAME padding with init 1.0), so they are not eroded."""
    m = mask.float()
    length = m.shape[-1]
    if length % latent_len:
        raise ValueError(f"signal length {length} is not a multiple of {latent_len}")
    m = m.reshape(*m.shape[:-1], latent_len, length // latent_len).amin(dim=-1)
    if erode > 0:  # max pooling pads with -inf: the min pads with +inf, i.e. observed
        m = -F.max_pool1d(-m, 2 * erode + 1, stride=1, padding=erode)
    return m


def impute_ldm(unet: Callable[..., torch.Tensor], ae: torch.nn.Module, scale_factor: float,
               sched: NoiseSchedule, x_known: torch.Tensor, mask: torch.Tensor, noise: Noise,
               labels: Optional[torch.Tensor] = None, num_resample: int = 1,
               latent_erode: int = 4, guidance_scale: float = 1.0) -> torch.Tensor:
    """RePaint in the LDM's latent space: encode ``x_known`` (B, 1, L) with
    the posterior mean, times ``scale_factor``; run ``ddpm_inpaint_loop``
    on the latents without clipping (latents are unbounded), anchored by
    ``latent_observed_mask``; decode with ``decode_stage_2_outputs`` and
    splice the observed samples back exactly in signal space."""
    x_known = x_known.float()
    mask = mask.to(device=x_known.device, dtype=torch.float32)
    z_known = ae.encode(x_known)[0].float() * scale_factor
    m_lat = latent_observed_mask(mask, z_known.shape[-1], latent_erode)
    model_fn = cond_model_fn(unet, labels, guidance_scale)
    z = ddpm_inpaint_loop(model_fn, sched, z_known, m_lat, noise,
                          num_resample=num_resample, clip_sample=False)
    x_dec = ae.decode_stage_2_outputs(z / scale_factor).float()
    return mask * x_known + (1.0 - mask) * x_dec


def sample_dm_conditional(unet: Callable[..., torch.Tensor], sched: NoiseSchedule,
                          labels: torch.Tensor, seeds: Sequence[int], window: int,
                          num_steps: int = 200, guidance_scale: float = 1.0) -> torch.Tensor:
    """Stage-conditional signal-space sampling: per-seed x_T
    (``seed_noise`` of (window, 1), as the LDM sampler draws its latents),
    then DDIM over ``num_steps`` with the labels (B,) on their device closed
    over the model (guided when ``guidance_scale`` is not 1). Returns
    (B, 1, window) fp32."""
    x_T = seed_noise(seeds, (window, 1), labels.device).transpose(1, 2)
    return ddim_sample_loop(cond_model_fn(unet, labels, guidance_scale), sched, x_T, num_steps)
