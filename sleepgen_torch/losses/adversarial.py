"""Least-squares patch-adversarial loss (LSGAN).

Counterpart of ``sleepgen/losses/adversarial.py`` (MONAI-generative's
``PatchAdversarialLoss(criterion="least_squares")``): LeakyReLU(0.05) on
the logits, then the mean squared error against a constant real (1.0) or
fake (0.0) map, in fp32.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

REAL_LABEL = 1.0
FAKE_LABEL = 0.0


def _least_squares(logits: torch.Tensor, target: float) -> torch.Tensor:
    x = F.leaky_relu(logits.float(), negative_slope=0.05)
    return (x - target).square().mean()


def generator_adv_loss(logits_fake: torch.Tensor) -> torch.Tensor:
    """Generator side: push D(fake) toward the real label."""
    return _least_squares(logits_fake, REAL_LABEL)


def discriminator_adv_loss(logits_fake: torch.Tensor, logits_real: torch.Tensor) -> torch.Tensor:
    """Discriminator side: 0.5 * (MSE(D(fake), 0) + MSE(D(real), 1))."""
    return 0.5 * (_least_squares(logits_fake, FAKE_LABEL)
                  + _least_squares(logits_real, REAL_LABEL))
