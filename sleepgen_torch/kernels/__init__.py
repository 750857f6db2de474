"""Hand-written CUDA kernels for Hopper (sm_90a) and their plain versions.

K1 ``group_norm.group_norm_silu`` (GroupNorm + SiLU), K2
``fused_resblock.gn_silu_conv3`` (GroupNorm -> SiLU -> Conv1d k=3), K4
``adaln.adaln_modulate`` (the DiT's gated residual, LayerNorm, adaLN
modulation and cast in one pass) and K5 ``attention.fused_attention`` (the
UNet's fast-math attention without gradient; ``attention.attention``
decides where it runs). The CUDA sources live in ``sleepgen_torch/csrc``
and are built at first use.
"""
