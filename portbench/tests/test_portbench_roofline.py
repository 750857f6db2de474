"""The copied bounds give the smoke script's bounds at its shapes, and the
walks of the configurations list the GroupNorm chains that the program's
UNet and AEKL really run."""
import collections

import pytest
import torch

from portbench import harness, roofline
from portbench.drivers.train import latent_shape

LDM, DM = harness.config("ldm-eeg"), harness.config("dm-eeg")


def ms(seconds):
    return seconds * 1e3


@pytest.mark.parametrize("cfg, batch, forwards, k2_ms, k1_ms", [
    (LDM, 64, 200, 119.7, 16.60),     # DDIM-200 batch (K1 with the decode's 13)
    (LDM, 64, 20, 11.97, 1.72),       # DPM++2M-20 batch
    (LDM, 128, 20, 23.92, 3.377),     # a guided request: the UNet at 128, the decode at 64
    (DM, 64, 200, 478.39, 66.11),     # DM DDIM-200 batch, no decode
])
def test_sampler_bounds_match_the_kernel_table(cfg, batch, forwards, k2_ms, k1_ms):
    u = cfg["unet"]
    walk = roofline.unet_forward(u, batch, u["image_size"])
    assert ms(forwards * roofline.sample_bounds(u, batch, u["image_size"])) == pytest.approx(
        k2_ms, rel=2e-3)
    k1 = forwards * sum(roofline.k1_bound(k) for k in walk["K1"])
    if "aekl" in cfg:
        k1 += sum(roofline.k1_bound(k)
                  for k in roofline.decoder_norms(cfg["aekl"], 64, u["image_size"]))
    assert ms(k1) == pytest.approx(k1_ms, rel=3e-3)


@pytest.mark.parametrize("cfg, batch, k1_ms, k3_ms", [
    (LDM, 1024, 8.08, 10.64),   # stage-2 step: the encoder's 13 and the UNet's 49
])
def test_training_bounds_match_the_kernel_table(cfg, batch, k1_ms, k3_ms):
    u, a = cfg["unet"], cfg["aekl"]
    norms = roofline.unet_forward(u, batch, latent_shape(cfg)[1], grad=True)["K1"]
    enc = roofline.encoder_norms(a, batch, cfg["window"])
    assert (len(enc), len(norms)) == (13, 49)
    assert ms(sum(roofline.k1_bound(k) for k in enc + norms)) == pytest.approx(k1_ms, rel=3e-3)
    assert ms(sum(roofline.k3_bound(k) for k in norms)) == pytest.approx(k3_ms, rel=3e-3)
    total = ms(roofline.train_gn_bounds(u, a, batch, cfg["window"], latent_shape(cfg)[1]))
    assert total == pytest.approx(k1_ms + k3_ms, rel=3e-3)


def test_dm_training_bounds_match_the_kernel_table():
    u = DM["unet"]
    norms = roofline.unet_forward(u, 512, u["image_size"], grad=True)["K1"]
    assert ms(sum(roofline.k1_bound(k) for k in norms)) == pytest.approx(14.18, rel=3e-3)
    assert ms(sum(roofline.k3_bound(k) for k in norms)) == pytest.approx(21.28, rel=3e-3)


@pytest.mark.parametrize("forwards, decodes", [(200, 1), (20, 1), (1, 0)])
def test_walk_counts_equal_expected_launches(forwards, decodes):
    u, a = LDM["unet"], LDM["aekl"]
    walk = roofline.unet_forward(u, 64, u["image_size"])
    want = roofline.expected_launches(u, a, forwards, decodes)
    assert forwards * len(walk["K2"]) == want["K2"]
    assert forwards * len(walk["K1"]) + decodes * len(roofline.decoder_norms(a, 64, 768)) \
        == want["K1"]
    if (forwards, decodes) == (1, 0):
        assert want == {"K1": 11, "K2": 38}


def _program_shapes(monkeypatch, cfg, batch, grad):
    """The GroupNorm and K2 calls of the program's UNet forward (and, for
    training, of its encoder), by shape, run on meta tensors."""
    from sleepgen_torch.nn import layers, unet1d
    from sleepgen_torch.sample.sample_ldm import build_aekl, build_unet
    from portbench.common import program_configs

    calls = collections.Counter()

    def k1(x, scale, bias, g, eps=1e-6, silu=True):
        calls["K1", (x.shape[0], x.shape[1], x.shape[2], g)] += 1
        return torch.empty_like(x)

    def k2(x, scale, bias, w, b, g, eps=1e-6):
        calls["K2", (x.shape[0], x.shape[1], w.shape[0], x.shape[2], g)] += 1
        return torch.empty((x.shape[0], w.shape[0], x.shape[2]), device=x.device, dtype=x.dtype)

    monkeypatch.setattr(layers, "group_norm_silu", k1)
    monkeypatch.setattr(unet1d, "gn_silu_conv3", k2)
    cfgs = program_configs(cfg)
    u = cfg["unet"]
    with torch.device("meta"):
        unet = build_unet(cfgs[0], u["in_channels"], u["in_channels"])
        x = torch.empty(batch, u["in_channels"], u["image_size"])
        with torch.set_grad_enabled(grad):
            unet(x, torch.zeros(batch, dtype=torch.int64))
            if grad:
                build_aekl(cfgs[1]).encode(torch.empty(batch, 1, cfg["window"]))
    return calls


@pytest.mark.parametrize("cfg", [LDM, DM], ids=["ldm", "dm"])
def test_walk_shapes_equal_the_program_forward(monkeypatch, cfg):
    u = cfg["unet"]
    walk = roofline.unet_forward(u, 8, u["image_size"])
    want = collections.Counter([("K1", k) for k in walk["K1"]] + [("K2", k) for k in walk["K2"]])
    assert _program_shapes(monkeypatch, cfg, 8, grad=False) == want


def test_walk_shapes_equal_the_program_training_step(monkeypatch):
    u = LDM["unet"]
    norms = roofline.unet_forward(u, 8, u["image_size"], grad=True)["K1"]
    enc = roofline.encoder_norms(LDM["aekl"], 8, LDM["window"])
    want = collections.Counter(("K1", k) for k in norms + enc)
    assert _program_shapes(monkeypatch, LDM, 8, grad=True) == want
