"""Stage-1 losses of the port: KL, LSGAN and the spectral term."""
from sleepgen_torch.losses.adversarial import discriminator_adv_loss, generator_adv_loss
from sleepgen_torch.losses.kl import kl_gaussian
from sleepgen_torch.losses.spectral import fft_amplitude, jukebox_loss

__all__ = [
    "discriminator_adv_loss",
    "generator_adv_loss",
    "kl_gaussian",
    "fft_amplitude",
    "jukebox_loss",
]
