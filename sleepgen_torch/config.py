"""One dataclass config tree, the port's own copy of the JAX package's.

Reads the same YAML files (the repo's ``sleepgen/configs/*.yaml`` and the
reference schema with ``autoencoderkl``/``model`` sections) and writes
``config.yaml`` into a run dir. Keys the port does not use, such as the
JAX package's switches for its TPU kernels (``use_pallas_norm``,
``fused_resblock_sampling``), are ignored on reading.
PyYAML is imported only inside the two functions that read or write a
file, so the rest of the port runs without it.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from pathlib import Path
from typing import List


def _coerce(value, typ):
    """YAML 1.1 quirk: '1E4'/'1E-9' (no dot) parse as strings; the
    reference's configs use that form."""
    if isinstance(value, str):
        try:
            if typ is float:
                return float(value)
            if typ is int:
                return int(value)
        except ValueError:
            return value
    return value


def _replace_known(obj, data: dict):
    known = {f.name: f.type for f in dataclasses.fields(obj)}
    clean = {}
    for k, v in data.items():
        if k not in known:
            continue
        t = known[k]
        t = {"float": float, "int": int, "bool": bool, "str": str}.get(t, t) \
            if isinstance(t, str) else t
        clean[k] = _coerce(v, t)
    return dataclasses.replace(obj, **clean)


@dataclass
class TrainConfig:
    seed: int = 2
    batch_size: int = 16
    n_epochs: int = 100
    val_interval: int = 10
    num_workers: int = 0
    drop_last: bool = False
    base_path: str = "data/sleep-edfx"
    output_dir: str = "outputs"
    run_dir: str = "run"
    experiment: str = "AEKL"
    base_lr: float = 1e-4
    save_every: int = 50
    cond_dropout_prob: float = 0.0


@dataclass
class AEKLModelConfig:
    spatial_dims: int = 1
    in_channels: int = 1
    out_channels: int = 1
    num_channels: List[int] = field(default_factory=lambda: [32, 32, 64])
    latent_channels: int = 1
    num_res_blocks: int = 2
    norm_num_groups: int = 1
    attention_levels: List[bool] = field(default_factory=lambda: [False, False, False])
    with_encoder_nonlocal_attn: bool = False
    with_decoder_nonlocal_attn: bool = False


@dataclass
class DiscriminatorConfig:
    spatial_dims: int = 1
    num_layers_d: int = 3
    num_channels: int = 64
    in_channels: int = 1
    out_channels: int = 1
    kernel_size: int = 3
    norm: str = "BATCH"
    bias: bool = False
    padding: int = 1


@dataclass
class LossConfig:
    optimizer_g_lr: float = 5e-3
    optimizer_d_lr: float = 5e-4
    adv_weight: float = 0.01
    kl_weight: float = 1e-9
    spectral_weight: float = 1e4


@dataclass
class UNetConfig:
    image_size: int = 768
    in_channels: int = 1
    out_channels: int = 1
    model_channels: int = 128
    attention_resolutions: List[int] = field(default_factory=lambda: [8, 4])
    num_res_blocks: int = 2
    channel_mult: List[int] = field(default_factory=lambda: [1, 2, 4])
    dropout: float = 0.0
    conv_resample: bool = True
    num_heads: int = 1
    use_scale_shift_norm: bool = False
    resblock_updown: bool = True
    norm_num_groups: int = 32
    kv_block_size: int = 0
    num_classes: int = 0


@dataclass
class DiTConfig:
    """The DiT denoiser (``nn/dit.py``), named as the published ``DiT``'s
    arguments; the defaults are DiT-XL/2's widths, unconditional, on the
    768-sample latent. ``num_experts`` > 0 makes it DiT-MoE's (``nn/moe.py``,
    named as DiT-MoE's arguments): every MLP the top ``num_experts_per_tok``
    of ``num_experts`` SwiGLU experts plus ``n_shared_experts`` shared ones,
    and the router's auxiliary loss at ``aux_loss_alpha`` in training."""
    input_size: int = 768
    patch_size: int = 2
    hidden_size: int = 1152
    depth: int = 28
    num_heads: int = 16
    mlp_ratio: float = 4.0
    num_classes: int = 0
    num_experts: int = 0
    num_experts_per_tok: int = 2
    n_shared_experts: int = 0
    aux_loss_alpha: float = 0.01

    def __post_init__(self):
        if self.num_experts and not 0 < self.num_experts_per_tok <= self.num_experts:
            raise ValueError(f"dit.num_experts_per_tok {self.num_experts_per_tok} is not "
                             f"between 1 and dit.num_experts {self.num_experts}")


@dataclass
class DiffusionConfig:
    timesteps: int = 1000
    beta_schedule: str = "linear_beta"  # training schedule
    linear_start: float = 0.0015
    linear_end: float = 0.0195
    prediction_type: str = "epsilon"
    # DDIM sampling schedule: deliberately different from training, as in
    # the reference's sampler.
    sample_schedule: str = "scaled_linear_beta"
    sample_beta_start: float = 0.0015
    sample_beta_end: float = 0.0205
    sample_prediction_type: str = "v_prediction"
    num_inference_steps: int = 200
    ema_decay: float = 0.0
    sampler: str = "ddim"


@dataclass
class Config:
    train: TrainConfig = field(default_factory=TrainConfig)
    losses: LossConfig = field(default_factory=LossConfig)
    aekl: AEKLModelConfig = field(default_factory=AEKLModelConfig)
    discriminator: DiscriminatorConfig = field(default_factory=DiscriminatorConfig)
    unet: UNetConfig = field(default_factory=UNetConfig)
    dit: DiTConfig = field(default_factory=DiTConfig)
    # The stage-2 denoiser: "unet" (``unet``) or "dit" (``dit``)
    denoiser: str = "unet"
    diffusion: DiffusionConfig = field(default_factory=DiffusionConfig)
    spectral: bool = False
    dataset: str = "edfx"
    dtype: str = "bfloat16"  # compute dtype of the sampler on the card
    # The JAX package's precision switches for the diffusion UNet under
    # bf16: True is its mixed attention (q and k cast back to bf16 before
    # their product), False its strict one (the product and softmax in
    # fp32); nn/layers.py::attention. Sampling and training each have one.
    fast_sampling_math: bool = True
    fast_train_math: bool = True

    @property
    def num_classes(self) -> int:
        """The denoiser's class labels: 0 for an unconditional one."""
        return self.dit.num_classes if self.denoiser == "dit" else self.unet.num_classes

    @property
    def image_size(self) -> int:
        """The length of the denoiser's input (the latent's, or the DM's
        window)."""
        return self.dit.input_size if self.denoiser == "dit" else self.unet.image_size

    # -- I/O ------------------------------------------------------------------
    def to_yaml(self, path: str | Path) -> None:
        import yaml

        Path(path).write_text(yaml.safe_dump(dataclasses.asdict(self)))

    @classmethod
    def from_yaml(cls, path: str | Path) -> "Config":
        import yaml

        raw = yaml.safe_load(Path(path).read_text())
        return cls.from_dict(raw)

    @classmethod
    def from_dict(cls, raw: dict) -> "Config":
        if "autoencoderkl" in raw or "model" in raw:
            return cls._from_reference_schema(raw)
        cfg = cls()
        for f in dataclasses.fields(cls):
            if f.name in raw:
                sub = raw[f.name]
                if f.name in ("train", "losses", "aekl", "discriminator",
                              "unet", "dit", "diffusion"):
                    setattr(cfg, f.name, _replace_known(getattr(cfg, f.name), sub))
                else:
                    setattr(cfg, f.name, sub)
        return cfg

    @classmethod
    def _from_reference_schema(cls, raw: dict) -> "Config":
        """Read the reference repo's YAML files unchanged."""
        cfg = cls()
        tr = dict(raw.get("train", {}))
        tr.setdefault("val_interval", tr.pop("eval_freq", cfg.train.val_interval))
        cfg.train = _replace_known(cfg.train, tr)
        if "models" in raw:
            cfg.losses = _replace_known(cfg.losses, raw["models"])
        if "autoencoderkl" in raw:
            cfg.aekl = _replace_known(cfg.aekl, raw["autoencoderkl"].get("params", {}))
        if "patchdiscriminator" in raw:
            cfg.discriminator = _replace_known(
                cfg.discriminator, raw["patchdiscriminator"].get("params", {}))
        model = raw.get("model", {}).get("params", {})
        if model:
            cfg.diffusion = dataclasses.replace(
                cfg.diffusion,
                timesteps=model.get("timesteps", 1000),
                beta_schedule="linear_beta",
                linear_start=model.get("linear_start", 0.0015),
                linear_end=model.get("linear_end", 0.0195),
                prediction_type="epsilon"
                if model.get("parameterization", "eps") == "eps" else "sample",
            )
            cfg.unet = _replace_known(
                cfg.unet, model.get("unet_config", {}).get("params", {}))
        uroot = raw.get("unet", {}).get("params", {})
        if uroot:
            cfg.unet = _replace_known(cfg.unet, uroot)
        return cfg
