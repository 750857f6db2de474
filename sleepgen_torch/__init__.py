"""sleepgen_torch: the PyTorch and CUDA port of sleepgen for NVIDIA Hopper.

It grows beside the JAX package ``sleepgen``, which stays the reference,
and imports nothing from it. It runs LDM sampling (DDIM over the
diffusion UNet's latent, then the AutoencoderKL decode) and stage-2 LDM
training (``python -m sleepgen_torch train-ldm``), with every GroupNorm,
forward and backward, on hand-written CUDA kernels
(``sleepgen_torch.kernels``). Models work in torch's (B, C, L) layout;
the public sampler and the data loader use the JAX package's (B, L, C).

Entry points run on the GPU (``device="cuda"``) unless the caller passes
``device="cpu"``, which runs the kernels' plain PyTorch versions.
"""

__version__ = "0.1.0"
