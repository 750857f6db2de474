"""sleepgen_torch: the PyTorch and CUDA port of sleepgen for NVIDIA Hopper.

It grows beside the JAX package ``sleepgen``, which stays the reference,
and imports nothing from it. ``python -m sleepgen_torch`` answers every
command of ``python -m sleepgen`` (sampling, both training stages, the
signal-space DM, serving, evaluation, decoding); the first-generation
pipeline (``train.train_v1``), int8 sampling (``nn.quant``) and the
long-window attention option are Python entry points, as in the JAX
package. Every GroupNorm, forward and backward, runs on hand-written CUDA
kernels (``sleepgen_torch.kernels``). Models work in torch's (B, C, L) layout;
the public sampler and the data loader use the JAX package's (B, L, C).

Entry points run on the GPU (``device="cuda"``) unless the caller passes
``device="cpu"``, which runs the kernels' plain PyTorch versions.
"""

__version__ = "0.1.0"
