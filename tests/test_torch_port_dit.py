"""The port's DiT (``sleepgen_torch/nn/dit.py``) against the benchmark's plain
float32 reference (``portbench/reference/dit.py``), at tiny width on the CPU:
depth 2, hidden 64, 4 heads, patch 2, a 64-sample latent, 5 classes, float32
and seeded random weights in which no gate and no final-layer weight is zero,
so a block that is skipped or mis-gated shows.

The forward with labels, with null labels and with none; the guided
closure; DPM-Solver++(2M) and DDIM loops through ``make_ldm_sampler`` with
the AEKL decode and crop; one ``make_ldm_train_step`` step's loss and
gradients; the state-dict names; the patch layout; the denoiser chosen by
the configuration in ``build_models`` and ``build_trainer`` with DiT's
published initialisation; the int8 refusal; the spans and counters; the
run dir's parameter tree; ``train-ldm`` then ``sample`` on the DiT
configuration's YAML cut to tiny width; and the pass between half-blocks
(``modulate``) in its composed form, which runs here, against the ops it
replaced, bit for bit, with autograd on and off.
"""
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

from portbench import weights as seeded
from portbench.reference import dit as rdit, loops, models as ref
import torch.nn.functional as F

from sleepgen_torch.config import Config
from sleepgen_torch.kernels import adaln
from sleepgen_torch.nn import dit
from sleepgen_torch.nn.dit import DiT1d
from sleepgen_torch.nn.unet1d import UNet1d
from sleepgen_torch.utils import profiling, weights

ROOT = Path(__file__).resolve().parent.parent
DIT_YAML = ROOT / "portbench" / "configs" / "dit-xl2-eeg.yaml"
TINY = dict(in_channels=1, input_size=64, patch_size=2, hidden_size=64, depth=2, num_heads=4,
            mlp_ratio=4.0, num_classes=5)
AEKL_CH = (4, 4, 8)
SEED = 2**31 + 5
RTOL = 2e-5  # float32 on both sides, the same operations in another order


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """torch on one intra-op thread in this module: the suite runs several
    worker processes on the same cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _state(model_fn, purpose):
    with torch.device("meta"):
        model = model_fn()
    return seeded.make_state(seeded.shapes_of(model), ref.groupnorm_params(model), SEED, "cpu",
                             purpose, served=False)


@pytest.fixture(scope="module")
def pair():
    """(program DiT, reference DiT, state) on the same seeded fp32 weights."""
    state = _state(lambda: rdit.DiT(**TINY), seeded.WEIGHTS_UNET)
    assert all(v.abs().min() > 0 for k, v in state.items()
               if "adaLN" in k or k.startswith("final_layer"))
    program = DiT1d(**TINY).eval()
    program.load_state_dict(state)
    reference = rdit.DiT(**TINY).eval()
    reference.load_state_dict(state)
    return program, reference, state


@pytest.fixture(scope="module")
def aekl_pair():
    state = _state(lambda: ref.AutoencoderKL(AEKL_CH), seeded.WEIGHTS_AEKL)
    reference = ref.AutoencoderKL(AEKL_CH).eval()
    reference.load_state_dict(state)
    return state, reference


def _inputs(batch=3):
    g = torch.Generator().manual_seed(7)
    x = torch.randn((batch, 1, TINY["input_size"]), generator=g)
    t = torch.tensor([0, 417, 999][:batch])
    return x, t


def _close(got, want, rtol=RTOL):
    err = float((got - want).norm() / want.norm())
    assert err < rtol, err


@pytest.mark.parametrize("labels", ["labels", "null", "none"])
def test_forward_matches_the_reference(pair, labels):
    program, reference, _ = pair
    x, t = _inputs()
    y = {"labels": torch.tensor([0, 3, 4]), "null": torch.tensor([-1, 2, -1]),
         "none": None}[labels]
    ref_y = None if y is None else torch.where(y < 0, TINY["num_classes"], y)
    with torch.no_grad():
        got, want = program(x, t, y), reference(x, t, ref_y)
    assert got.dtype == torch.float32 and got.shape == x.shape
    _close(got, want)


def test_null_labels_differ_from_labels(pair):
    program, _, _ = pair
    x, t = _inputs()
    with torch.no_grad():
        a, b = program(x, t, torch.tensor([1, 1, 1])), program(x, t, torch.tensor([-1, -1, -1]))
    assert float((a - b).norm() / b.norm()) > 1e-3
    assert torch.equal(b, program(x, t))


def test_the_guided_closure_matches_the_reference(pair):
    from sleepgen_torch.sample.samplers import cond_model_fn

    program, reference, _ = pair
    x, t = _inputs()
    labels = torch.tensor([0, 2, 4])
    with torch.no_grad():
        got = cond_model_fn(program, labels, 1.5)(x, t)
        want = rdit.guided(reference, labels, 1.5)(x, t)
    _close(got, want)


def _dit_config(dtype="float32") -> Config:
    cfg = Config.from_yaml(DIT_YAML)
    for k, v in TINY.items():
        if k != "in_channels":
            setattr(cfg.dit, k, v)
    cfg.dtype = dtype
    cfg.aekl.num_channels = list(AEKL_CH)
    return cfg


@pytest.mark.parametrize("sampler", ["dpm++2m", "ddim"])
def test_guided_loops_with_decode_and_crop_match_the_reference(pair, aekl_pair, sampler):
    from sleepgen_torch.sample.sample_ldm import build_models, make_ldm_sampler, sampling_schedule

    _, reference, state = pair
    ae_state, ref_ae = aekl_pair
    cfg = _dit_config()
    to_np = {k: v.numpy() for k, v in state.items()}
    model, ae = build_models(cfg, to_np, {k: v.numpy() for k, v in ae_state.items()}, "cpu")
    assert isinstance(model, DiT1d)
    sample = make_ldm_sampler(model, ae, sampling_schedule(cfg), 64, 1, 3, sampler=sampler,
                              device="cpu", conditional=True, guided=True)
    seeds, labels = [11, 12], torch.tensor([1, 4])
    got = sample(1.0, seeds, labels, 1.5)
    d = cfg.diffusion
    acp = loops.alphas_cumprod(d.sample_schedule, d.timesteps, d.sample_beta_start,
                               d.sample_beta_end)
    loop = {"ddim": loops.ddim, "dpm++2m": loops.dpm_pp_2m}[sampler]
    with torch.no_grad():
        z = loop(rdit.guided(reference, labels, 1.5), acp, loops.seed_noise(seeds, 1, 64), 3)
        want = loops.crop(ref_ae.decode(z))
    assert got.shape == want.shape == (2, 184, 1)
    _close(got, want, 1e-4)


def test_one_train_step_matches_the_reference(pair, aekl_pair):
    from sleepgen_torch.sample.sample_ldm import build_aekl
    from sleepgen_torch.train.train_ldm import make_ldm_train_step, make_schedule

    _, reference, state = pair
    ae_state, ref_ae = aekl_pair
    cfg = _dit_config()
    program = DiT1d(**TINY)
    program.load_state_dict(state)
    ae = build_aekl(cfg).eval().requires_grad_(False)
    ae.load_state_dict(ae_state)
    opt = torch.optim.Adam(program.parameters(), lr=1e-4)
    step = make_ldm_train_step(program, ae, make_schedule(cfg), opt, 0.7)
    g = torch.Generator().manual_seed(3)
    x = torch.randn((4, 1, 256), generator=g)
    t = torch.tensor([3, 250, 600, 999])
    noise, enc_eps = (torch.randn((4, 1, 64), generator=g) for _ in range(2))
    loss = step(x, t, noise, enc_eps)
    d = cfg.diffusion
    acp = loops.alphas_cumprod(d.beta_schedule, d.timesteps, d.linear_start, d.linear_end)
    reference = rdit.DiT(**TINY)
    reference.load_state_dict(state)
    want = loops.ldm_losses(reference, ref_ae, acp, 0.7, x, t, noise, enc_eps).mean()
    want.backward()
    assert abs(float(loss) - float(want.detach())) < RTOL * float(want.detach())
    got_grads = dict(program.named_parameters())
    for name, p in reference.named_parameters():
        _close(got_grads[name].grad, p.grad, 1e-4)


def test_state_dict_names_equal_the_references(pair):
    program, reference, _ = pair
    assert list(program.state_dict()) == list(reference.state_dict())
    assert "pos_embed" not in program.state_dict()


def test_patches_round_trip():
    """A patch embedding that copies each patch's values gives the tokens
    that ``unpatchify`` lays back out as the input."""
    c, p, length = 3, 2, 8
    embed = dit.PatchEmbed(c, p * c, p)
    with torch.no_grad():
        embed.proj.weight.zero_()
        embed.proj.bias.zero_()
        for j in range(p):
            for ch in range(c):
                embed.proj.weight[j * c + ch, ch, j] = 1.0
    x = torch.randn(2, c, length)
    with torch.no_grad():
        assert torch.equal(dit.unpatchify(embed(x), p, c), x)


def test_the_configuration_selects_the_denoiser(aekl_pair):
    from sleepgen_torch.sample.sample_ldm import build_models, build_unet
    from sleepgen_torch.train.train_ldm import build_trainer

    ae_state = {k: v.numpy() for k, v in aekl_pair[0].items()}
    cfg = _dit_config("bfloat16")
    assert (cfg.denoiser, cfg.num_classes, cfg.image_size) == ("dit", 5, 64)
    with torch.device("meta"):
        shapes = {k: v.shape for k, v in build_unet(cfg, 1, 1).state_dict().items()}
    sd = {k: np.zeros(shape, np.float32) for k, shape in shapes.items()}
    model, _ = build_models(cfg, sd, ae_state, "cpu")
    assert isinstance(model, DiT1d) and model.blocks[0].attn.qkv.weight.dtype == torch.bfloat16
    cfg.dtype = "float32"
    model, _, _, opt = build_trainer(cfg, ae_state, cfg, "cpu")
    assert isinstance(model, DiT1d) and model.blocks[0].attn.qkv.weight.dtype == torch.float32
    assert opt.param_groups[0]["lr"] == cfg.train.base_lr
    unet_cfg = Config()
    unet_cfg.aekl.num_channels = list(AEKL_CH)
    unet_cfg.unet.model_channels, unet_cfg.unet.channel_mult = 16, [1, 2]
    unet_cfg.unet.attention_resolutions, unet_cfg.unet.norm_num_groups = [2], 8
    assert (unet_cfg.denoiser, unet_cfg.image_size) == ("unet", 768)
    assert isinstance(build_trainer(unet_cfg, ae_state, unet_cfg, "cpu")[0], UNet1d)
    cfg.denoiser = "transformer"
    with pytest.raises(ValueError, match="unknown denoiser"):
        build_unet(cfg, 1, 1)


def test_the_published_initialisation():
    """Zero adaLN modulations and final layer, Xavier-uniform linears and
    patch embedding, N(0, 0.02) label table and timestep MLP, zero biases."""
    model = DiT1d(**{**TINY, "hidden_size": 128})
    state = dit.init_state(model, 0)
    assert list(state) == list(model.state_dict())
    for name, v in state.items():
        if ".adaLN_modulation." in name or name.startswith("final_layer.") \
                or name.endswith("bias"):
            assert not v.any(), name
        elif name.startswith(("y_embedder.", "t_embedder.")):
            assert abs(v.std() - 0.02) < 0.002, name
        else:
            fan_out, fan_in = v.shape[0], int(np.prod(v.shape[1:]))
            bound = (6.0 / (fan_in + fan_out)) ** 0.5
            assert bound * 0.95 < np.abs(v).max() <= bound, name
    assert np.array_equal(state["blocks.1.mlp.fc1.weight"],
                          dit.init_state(model, 0)["blocks.1.mlp.fc1.weight"])


def test_int8_sampling_refuses_the_dit(pair, aekl_pair):
    from sleepgen_torch.sample.sample_ldm import build_models, make_ldm_sampler, sampling_schedule

    _, _, state = pair
    cfg = _dit_config()
    args = (cfg, {k: v.numpy() for k, v in state.items()},
            {k: v.numpy() for k, v in aekl_pair[0].items()}, "cpu")
    with pytest.raises(ValueError, match="int8"):
        build_models(*args, quantized=True)
    model, ae = build_models(*args)
    with pytest.raises(ValueError, match="int8"):
        make_ldm_sampler(model, ae, sampling_schedule(cfg), 64, device="cpu", quantized=True)


def test_spans_and_counters_while_tracing(pair):
    program, _, _ = pair
    x, t = _inputs()
    profiling.reset()
    with torch.no_grad():
        program(x, t)  # not recorded
        with profiling.tracing():
            program(x, t, torch.tensor([0, 1, 2]))
    spans = profiling.spans()
    by_id = {s["id"]: s for s in spans}
    names = [s["name"] for s in spans]
    assert names.count("dit.forward") == 1 and names.count("dit.cond") == 1
    assert names.count("dit.attn") == names.count("dit.mlp") == TINY["depth"]
    assert names.count("dit.modulate") == 2 * TINY["depth"] + 1 and names.count("dit.final") == 1
    for s in spans:
        parent = by_id.get(s["parent"], {}).get("name")
        if s["name"] in ("dit.cond", "dit.attn", "dit.mlp", "dit.final"):
            assert parent == "dit.forward"
        elif s["name"] == "dit.modulate":
            assert parent in ("dit.attn", "dit.mlp", "dit.final")
    c = profiling.counters()
    assert (c["dit.forwards"], c["dit.tokens"]) == (1, 3 * TINY["input_size"] // 2)
    assert c["dit.fused_norms"] == 0  # the composed ops on the CPU
    profiling.reset()
    assert profiling.counters()["dit.forwards"] == 0


def test_the_run_dir_tree_round_trips(pair):
    _, _, state = pair
    tree = weights.denoiser_state_to_tree("dit", state)
    assert tree["blocks"]["1"]["adaLN_modulation"]["1"]["weight"].shape == (384, 64)
    back = weights.denoiser_state_from_tree("dit", {"params": tree})
    assert list(back) == list(state)
    assert all(np.array_equal(back[k], v.numpy()) for k, v in state.items())


def _tiny_dit_yaml(tmp_path, num_classes) -> Path:
    """The DiT configuration's YAML at tiny width: float32-ready, 20
    timesteps, one epoch of batch 4, on the 3072-sample window's latent."""
    raw = yaml.safe_load(DIT_YAML.read_text())
    raw["dit"].update(input_size=768, hidden_size=32, depth=1, num_heads=2,
                      num_classes=num_classes)
    raw["train"].update(n_epochs=1, batch_size=4, val_interval=1, output_dir=str(tmp_path / "out"))
    raw["diffusion"].update(timesteps=20, ema_decay=0.0)
    raw["aekl"] = {"num_channels": list(AEKL_CH)}
    path = tmp_path / "dit.yaml"
    path.write_text(yaml.safe_dump(raw))
    return path


def _aekl_run_dir(tmp_path, aekl_pair) -> Path:
    aekl_cfg = Config()
    aekl_cfg.aekl.num_channels = list(AEKL_CH)
    ae_dir = tmp_path / "aekl"
    ae_dir.mkdir()
    aekl_cfg.to_yaml(ae_dir / "config.yaml")
    weights.save_params_npz(ae_dir / "params.npz", weights.aekl_state_to_jax(aekl_pair[0]))
    return ae_dir


@pytest.mark.parametrize("num_classes", [0, 5])
def test_train_ldm_and_sample_clis_on_the_dit_config(tmp_path, aekl_pair, monkeypatch, capsys,
                                                     num_classes):
    """``train-ldm`` on the DiT YAML at tiny width, then ``sample`` from its
    ``best_model``. The CLI loads windows without labels, so the conditional
    YAML (5 stages) is refused before a run dir is written: it would train
    the null class alone."""
    from sleepgen_torch.__main__ import main as umbrella
    from sleepgen_torch.cli.sample_trials import main as sample_main
    from sleepgen_torch.data.synthetic import write_ids_csv, write_synthetic_npy_tree

    rows = write_synthetic_npy_tree(tmp_path / "npy", n_subjects=3, duration_s=35.0)
    write_ids_csv(tmp_path / "ids_train.csv", [r for r in rows if r["subject"] < 2])
    write_ids_csv(tmp_path / "ids_valid.csv", [r for r in rows if r["subject"] == 2])
    ae_dir = _aekl_run_dir(tmp_path, aekl_pair)
    monkeypatch.setattr(sys, "argv", [
        "sleepgen_torch", "train-ldm", "--config_file", str(_tiny_dit_yaml(tmp_path, num_classes)),
        "--autoencoderkl_config_file_path", str(ae_dir / "config.yaml"),
        "--best_model_path", str(ae_dir), "--path_train_ids", str(tmp_path / "ids_train.csv"),
        "--path_valid_ids", str(tmp_path / "ids_valid.csv"),
        "--path_pre_processed", str(tmp_path / "npy"), "--dtype", "float32", "--device", "cpu"])
    if num_classes:
        with pytest.raises(ValueError, match="num_classes=5.*no labels"):
            umbrella()
        assert not (tmp_path / "out").exists()
        return
    umbrella()
    assert "run_dir=" in capsys.readouterr().out
    run = tmp_path / "out" / "ldm_eeg_no-spectral_edfx"
    saved = Config.from_yaml(run / "best_model" / "config.yaml")
    assert saved.denoiser == "dit" and saved.dit.hidden_size == 32
    with np.load(run / "best_model" / "params.npz") as data:
        assert "blocks/0/attn/qkv/weight" in data.files
    sample_main(["--output_dir", str(tmp_path / "samples"), "--best_model_path", str(ae_dir),
                 "--diffusion_path", str(run / "best_model"), "--stop_seed", "2",
                 "--num_inference_steps", "2", "--sampler", "dpm++2m", "--batch_size", "2",
                 "--no_psd", "--device", "cpu"])
    out = tmp_path / "samples" / "samples_ldm_1_no-spectral_edfx"
    assert np.load(out / "sample_1.npy").shape == (1, 1, 3000)


def test_train_ldm_fits_a_conditional_dits_stage_rows(tmp_path, aekl_pair):
    """``train_ldm`` on labelled windows moves every stage's row of the
    DiT's label table from its initial value, and the null row too."""
    from sleepgen_torch.data.staging import LabeledEpochDataset
    from sleepgen_torch.train.train_ldm import train_ldm

    cfg = Config.from_yaml(_tiny_dit_yaml(tmp_path, 5))
    # adaLN-Zero: the label table's gradient is zero until the modulations
    # and the final layer have moved off zero, so a larger step and two epochs
    cfg.dtype, cfg.train.base_lr, cfg.train.n_epochs = "float32", 1e-2, 2
    g = np.random.default_rng(3)
    train = LabeledEpochDataset(g.standard_normal((10, 3000)), np.arange(10) % 5)
    valid = LabeledEpochDataset(g.standard_normal((2, 3000)), np.array([0, 4]))
    ae_state = {k: v.numpy() for k, v in aekl_pair[0].items()}
    res = train_ldm(cfg, train, valid, ae_state, aekl_cfg=cfg, device="cpu")
    with torch.device("meta"):
        model = DiT1d(in_channels=1, input_size=768, patch_size=2, hidden_size=32, depth=1,
                      num_heads=2, mlp_ratio=4.0, num_classes=5)
    init = dit.init_state(model, cfg.train.seed)["y_embedder.embedding_table.weight"]
    with np.load(Path(res.run_dir) / "final_model" / "params.npz") as data:
        table = data["y_embedder/embedding_table/weight"]
    assert table.shape == init.shape == (6, 32)
    moved = np.abs(table - init).max(axis=1)
    assert (moved > 1e-6).all(), moved


def _old_modulate(x, shift, scale):
    """The LayerNorm and modulation as the DiT computed them before the pass
    took in the gated residual and the cast."""
    h = F.layer_norm(x, (x.shape[-1],), eps=adaln.LN_EPS)
    return torch.addcmul(shift[:, None], h, 1.0 + scale.float()[:, None])


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("form", ["first", "residual", "final"])
def test_the_composed_pass_is_the_old_ops_bit_for_bit(form, dtype):
    """The pass's composed form: no pending branch (block 0's attention), the
    gated residual then LayerNorm and modulation, and the final layer's
    (x_new not kept); against ``addcmul`` -> LayerNorm -> ``addcmul`` ->
    ``.to``, with gate, shift and scale chunks of one (B, 6 D) projection."""
    g = torch.Generator().manual_seed(11)
    b, t, d = 3, 5, 64
    x = 3.0 * torch.randn((b, t, d), generator=g) + 0.5
    x_before = x.clone()
    mods = (0.3 * torch.randn((b, 6 * d), generator=g)).to(dtype).chunk(6, dim=1)
    shift, scale, gate = mods[0], mods[1], mods[2]
    h = torch.randn((b, t, d), generator=g).to(dtype)
    pending = None if form == "first" else (h, gate)
    x_new, y = dit.modulate(x, shift, scale, dtype, pending, write_back=form != "final")
    want_x = x if pending is None else torch.addcmul(x, gate[:, None], h)
    want_y = _old_modulate(want_x, shift, scale).to(dtype)
    assert y.dtype == dtype and torch.equal(y, want_y)
    assert torch.equal(x, x_before)  # nothing in place
    assert x_new is None if form == "final" else torch.equal(x_new, want_x)


def test_the_pass_keeps_the_composed_ops_under_autograd():
    """Inputs that autograd follows never reach K4: the pass returns the
    composed ops' x_new with its graph, and launches nothing; on the CPU
    without autograd, and under autocast, the composed ops run too."""
    g = torch.Generator().manual_seed(5)
    x = torch.randn((2, 3, 64), generator=g)
    shift, scale, gate = (0.1 * torch.randn((2, 64), generator=g) for _ in range(3))
    h = torch.randn((2, 3, 64), generator=g, requires_grad=True)
    before = profiling.counters()["k4.launches"]
    x_new, y = adaln.adaln_modulate(x, shift, scale, torch.float32, (h, gate))
    assert x_new.grad_fn is not None and y.requires_grad
    y.sum().backward()
    assert h.grad is not None and torch.isfinite(h.grad).all()
    with torch.no_grad():
        want = adaln.adaln_modulate_reference(x, shift, scale, torch.float32, (h, gate))
        assert all(torch.equal(a, b) for a, b in zip(
            adaln.adaln_modulate(x, shift, scale, torch.float32, (h, gate)), want))
    with torch.autocast("cpu", dtype=torch.bfloat16):
        adaln.adaln_modulate(x, shift, scale, torch.float32, (h.detach(), gate))
    assert profiling.counters()["k4.launches"] == before


def test_a_forward_without_autograd_equals_one_with_it(pair):
    """The DiT with gradients on (training's parameters) and under no_grad
    and inference_mode gives the same output; the pass runs its composed
    ops each time here, and K4 never while autograd follows."""
    x, t = _inputs()
    labels = torch.tensor([0, 3, -1])
    model = DiT1d(**TINY)
    model.load_state_dict(pair[2])
    profiling.reset()
    with profiling.tracing():
        with_grad = model(x, t, labels)
        with_grad.square().mean().backward()
        assert profiling.counters()["dit.fused_norms"] == 0
    with torch.no_grad():
        no_grad = model(x, t, labels)
    with torch.inference_mode():
        inference = model(x, t, labels)
    profiling.reset()
    assert with_grad.requires_grad and model.blocks[0].attn.qkv.weight.grad is not None
    assert torch.equal(with_grad.detach(), no_grad) and torch.equal(no_grad, inference)
