"""The port's DiT-MoE (``sleepgen_torch/nn/dit.py`` with ``nn/moe.py``) against
the benchmark's plain float32 reference (``portbench/reference/dit_moe.py``,
a loop over the experts), at tiny width on the CPU: depth 2, hidden 64, 4
heads, patch 2, a 64-sample latent, 5 classes, 4 experts, top 2, 1 shared
expert, float32 and seeded random weights in which no gate, router or
final-layer weight is zero.

The forward with labels, null labels and none; the guided closure;
DPM-Solver++(2M) and DDIM loops through ``make_ldm_sampler`` with the AEKL
decode and crop; one ``make_ldm_train_step`` step's loss (the routers'
auxiliary loss included) and gradients per leaf, the routers' among them;
routing forced through the router's weights onto an expert that takes every
token and one that takes none; the state-dict names and the run dir's
tree; the configuration's keys, their refusal of a top-k above the
experts, and the denoiser they build; the int8 refusal; ``train-ldm`` then
``sample`` on the DiT-MoE YAML cut to tiny width; the spans, counters and
the device tally while tracing; and a dense DiT (no experts) unchanged.
"""
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

from portbench import weights as seeded
from portbench.reference import dit as rdit, dit_moe as rmoe, loops, models as ref
from sleepgen_torch.config import Config, DiTConfig
from sleepgen_torch.nn import dit, moe
from sleepgen_torch.nn.dit import DiT1d
from sleepgen_torch.utils import profiling, weights

ROOT = Path(__file__).resolve().parent.parent
MOE_YAML = ROOT / "portbench" / "configs" / "dit-moe-xl2-8e2a-eeg.yaml"
TINY = dict(in_channels=1, input_size=64, patch_size=2, hidden_size=64, depth=2, num_heads=4,
            mlp_ratio=4.0, num_classes=5, num_experts=4, num_experts_per_tok=2,
            n_shared_experts=1)
DENSE = {k: v for k, v in TINY.items() if k not in ("num_experts", "num_experts_per_tok",
                                                    "n_shared_experts")}
AEKL_CH = (4, 4, 8)
SEED = 2**31 + 9
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
    """(program DiT-MoE, reference DiT-MoE, state) on the same seeded fp32
    weights."""
    state = _state(lambda: rmoe.DiTMoE(**TINY), seeded.WEIGHTS_UNET)
    assert all(v.abs().min() > 0 for k, v in state.items()
               if "adaLN" in k or k.startswith("final_layer") or ".moe.gate." in k)
    program = DiT1d(**TINY).eval()
    program.load_state_dict(state)
    reference = rmoe.DiTMoE(**TINY).eval()
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
    assert program.aux_loss is None  # eval mode: no auxiliary loss


def test_the_guided_closure_matches_the_reference(pair):
    from sleepgen_torch.sample.samplers import cond_model_fn

    program, reference, _ = pair
    x, t = _inputs()
    labels = torch.tensor([0, 2, 4])
    with torch.no_grad():
        got = cond_model_fn(program, labels, 1.5)(x, t)
        want = rdit.guided(reference, labels, 1.5)(x, t)
    _close(got, want)


def _moe_config(dtype="float32") -> Config:
    cfg = Config.from_yaml(MOE_YAML)
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
    cfg = _moe_config()
    model, ae = build_models(cfg, state, {k: v.numpy() for k, v in ae_state.items()}, "cpu")
    assert isinstance(model, DiT1d) and model.num_experts == TINY["num_experts"]
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


def _published_grads(model: DiT1d) -> dict:
    """The program's gradients under the published per-expert names."""
    grads = {k: p.grad for k, p in model.named_parameters()}
    out = {}
    for name, g in grads.items():
        prefix, _, leaf = name.rpartition(".")
        if leaf == "gate_up":
            i = g.shape[1] // 2
            for e in range(g.shape[0]):
                out[f"{prefix}.{e}.gate_proj.weight"] = g[e, :i]
                out[f"{prefix}.{e}.up_proj.weight"] = g[e, i:]
        elif leaf == "down":
            for e in range(g.shape[0]):
                out[f"{prefix}.{e}.down_proj.weight"] = g[e]
        else:
            out[name] = g
    return out


def test_one_train_step_matches_the_reference(pair, aekl_pair):
    """Loss (the diffusion loss plus the routers' auxiliary loss) and every
    leaf's gradient, the routers' included, against the reference's."""
    from sleepgen_torch.sample.sample_ldm import build_aekl
    from sleepgen_torch.train.train_ldm import make_ldm_train_step, make_schedule

    _, _, state = pair
    ae_state, ref_ae = aekl_pair
    cfg = _moe_config()
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
    aux = program.aux_loss.detach()
    d = cfg.diffusion
    acp = loops.alphas_cumprod(d.beta_schedule, d.timesteps, d.linear_start, d.linear_end)
    reference = rmoe.DiTMoE(**TINY)
    reference.load_state_dict(state)
    mse = loops.ldm_losses(reference, ref_ae, acp, 0.7, x, t, noise, enc_eps).mean()
    want = mse + reference.aux_loss
    want.backward()
    want_aux = float(reference.aux_loss.detach())
    assert float(aux) > 0 and abs(float(aux) - want_aux) < 1e-5 * float(aux)
    assert abs(float(loss) - float(want.detach())) < RTOL * float(want.detach())
    got_grads = _published_grads(program)
    assert set(got_grads) == {k for k, _ in reference.named_parameters()}
    for name, p in reference.named_parameters():
        _close(got_grads[name], p.grad, 1e-4)
    assert float(got_grads["blocks.1.moe.gate.weight"].norm()) > 0


def test_the_aux_loss_is_the_published_one():
    """alpha * sum_e P_e f_e with f_e = E x the share of routed slots."""
    gate = moe.MoEGate(8, 4, 2, 0.01)
    idx = torch.tensor([[0, 1], [0, 2], [0, 1]])
    scores = torch.tensor([[0.5, 0.3, 0.1, 0.1], [0.4, 0.1, 0.4, 0.1], [0.6, 0.2, 0.1, 0.1]])
    share = torch.tensor([3, 2, 1, 0]) / 6.0
    want = 0.01 * float((scores.mean(0) * share * 4).sum())
    assert float(gate.aux_loss(idx, scores)) == pytest.approx(want, rel=1e-6)


@pytest.mark.parametrize("forced", ["every_row", "no_row"])
def test_forced_routing_matches_the_reference_and_the_plain_loop(forced):
    """Router weights that give expert 0 the first choice of every token
    and expert 3 no token (``every_row``), or route no token to experts 1
    and 2 (``no_row``): the dispatch agrees with the reference (its plain
    loop over the experts), and the offsets show the load."""
    torch.manual_seed(4)
    d = 16
    block = moe.SparseMoeBlock(d, 2.0, 4, 2, 1).eval()
    reference = rmoe.MoE(d, 2.0, 4, 2, 1, 0.0, ref.Precision())
    u = torch.randn(2, 5, d)
    u[..., 0] = 4.0 + u[..., 0].abs()  # one coordinate large and positive on every token
    with torch.no_grad():
        block.gate.weight.zero_()
        if forced == "every_row":
            block.gate.weight[0, 0], block.gate.weight[3, 0] = 5.0, -5.0
        else:
            block.gate.weight[0, 0], block.gate.weight[3, 0] = 5.0, 4.0
            block.gate.weight[1:3] = 0.05 * torch.randn(2, d) - torch.tensor([3.0] + [0.0] * 15)
        block.gate.weight[:, 1:] += 0.01 * torch.randn(4, d - 1)
    reference.load_state_dict(block.state_dict())
    ends = block.route(u.reshape(-1, d))[-1].tolist()
    loads = np.diff([0] + ends).tolist()
    if forced == "every_row":
        assert loads[0] == 10 and loads[3] == 0 and sum(loads) == 20
    else:
        assert loads == [10, 0, 0, 10]
    with torch.no_grad():
        _close(block(u), reference(u))


def test_state_dict_names_equal_the_references_and_round_trip(pair):
    program, reference, state = pair
    assert list(program.state_dict()) == list(reference.state_dict())
    assert "blocks.0.moe.experts.3.down_proj.weight" in program.state_dict()
    assert not any(k.endswith(("gate_up", "down")) for k in program.state_dict())
    tree = weights.denoiser_state_to_tree("dit", program.state_dict())
    assert tree["blocks"]["1"]["moe"]["experts"]["2"]["up_proj"]["weight"].shape == (256, 64)
    back = weights.denoiser_state_from_tree("dit", {"params": tree})
    assert list(back) == list(state)
    assert all(np.array_equal(back[k], v.numpy()) for k, v in state.items())
    again = DiT1d(**TINY)
    again.load_state_dict({k: torch.from_numpy(v) for k, v in back.items()})
    assert all(torch.equal(a, b) for a, b in zip(again.parameters(), program.parameters()))


def test_the_configuration_keys_and_their_refusal():
    cfg = Config.from_yaml(MOE_YAML)
    assert (cfg.denoiser, cfg.dit.num_experts, cfg.dit.num_experts_per_tok,
            cfg.dit.n_shared_experts, cfg.dit.aux_loss_alpha) == ("dit", 8, 2, 2, 0.01)
    assert Config().dit.num_experts == 0  # the dense DiT by default
    with pytest.raises(ValueError, match="num_experts_per_tok 9"):
        Config.from_dict({"denoiser": "dit", "dit": {"num_experts": 8, "num_experts_per_tok": 9}})
    with pytest.raises(ValueError, match="num_experts_per_tok 0"):
        DiTConfig(num_experts=4, num_experts_per_tok=0)
    with pytest.raises(ValueError, match="top 5 of 4"):
        DiT1d(**{**TINY, "num_experts_per_tok": 5})


def test_the_configuration_builds_the_moe_dit(aekl_pair):
    from sleepgen_torch.sample.sample_ldm import build_models, build_unet, make_ldm_sampler, \
        sampling_schedule
    from sleepgen_torch.train.train_ldm import build_trainer

    ae_state = {k: v.numpy() for k, v in aekl_pair[0].items()}
    cfg = _moe_config("bfloat16")
    with torch.device("meta"):
        shapes = {k: v.shape for k, v in build_unet(cfg, 1, 1).state_dict().items()}
    sd = {k: np.zeros(shape, np.float32) for k, shape in shapes.items()}
    model, ae = build_models(cfg, sd, ae_state, "cpu")
    assert isinstance(model.blocks[0].moe, moe.SparseMoeBlock)
    assert model.blocks[0].moe.experts.gate_up.dtype == torch.bfloat16
    assert model.blocks[0].moe.gate.weight.dtype == torch.bfloat16
    with pytest.raises(ValueError, match="int8"):
        build_models(cfg, sd, ae_state, "cpu", quantized=True)
    with pytest.raises(ValueError, match="int8"):
        make_ldm_sampler(model, ae, sampling_schedule(cfg), 64, device="cpu", quantized=True)
    cfg.dtype = "float32"
    model, _, _, opt = build_trainer(cfg, ae_state, cfg, "cpu")
    assert model.num_experts == 4 and model.blocks[1].moe.experts.down.dtype == torch.float32
    init = dit.init_state(model, 0)
    assert list(init) == list(model.state_dict())
    bound = 1.0 / np.sqrt(TINY["hidden_size"])
    router = init["blocks.0.moe.gate.weight"]
    assert 0.9 * bound < np.abs(router).max() <= bound
    expert = init["blocks.0.moe.experts.1.gate_proj.weight"]  # Xavier-uniform (256, 64)
    assert np.abs(expert).max() <= np.sqrt(6.0 / (256 + 64))


def test_spans_counters_and_the_device_tally_while_tracing(pair):
    program, _, _ = pair
    x, t = _inputs()
    profiling.reset()
    with torch.no_grad():
        program(x, t)  # not recorded
        assert profiling.keyed("dit.expert_rows") == {}
        with profiling.tracing():
            program(x, t, torch.tensor([0, 1, 2]))
    spans = profiling.spans()
    by_id = {s["id"]: s for s in spans}
    names = [s["name"] for s in spans]
    depth = TINY["depth"]
    for name in ("route", "dispatch", "experts", "shared", "combine"):
        assert names.count(f"dit.moe.{name}") == depth
    for s in spans:
        if s["name"].startswith("dit.moe."):
            assert by_id[s["parent"]]["name"] == "dit.mlp"
    c = profiling.counters()
    slots = 3 * TINY["input_size"] // 2 * TINY["num_experts_per_tok"]
    assert (c["dit.moe_layers"], c["dit.routed_rows"]) == (depth, depth * slots)
    rows = profiling.keyed("dit.expert_rows")
    assert sorted(rows) == list(range(TINY["num_experts"])) and sum(rows.values()) == depth * slots
    assert profiling.keyed("dit.expert_rows") == rows  # read once, kept
    profiling.reset()
    assert profiling.keyed("dit.expert_rows") == {} and profiling.counters()["dit.moe_layers"] == 0


def _tiny_moe_yaml(tmp_path) -> Path:
    """The DiT-MoE YAML at tiny width, unconditional (the CLI loads no
    labels), 20 timesteps, one epoch of batch 4, on the 3072-sample
    window's latent."""
    raw = yaml.safe_load(MOE_YAML.read_text())
    raw["dit"].update(input_size=768, hidden_size=32, depth=1, num_heads=2, num_classes=0,
                      num_experts=4, n_shared_experts=1)
    raw["train"].update(n_epochs=1, batch_size=4, val_interval=1, output_dir=str(tmp_path / "out"))
    raw["diffusion"].update(timesteps=20, ema_decay=0.0)
    raw["aekl"] = {"num_channels": list(AEKL_CH)}
    path = tmp_path / "moe.yaml"
    path.write_text(yaml.safe_dump(raw))
    return path


def test_train_ldm_and_sample_clis_on_the_moe_config(tmp_path, aekl_pair, monkeypatch, capsys):
    from sleepgen_torch.__main__ import main as umbrella
    from sleepgen_torch.cli.sample_trials import main as sample_main
    from sleepgen_torch.data.synthetic import write_ids_csv, write_synthetic_npy_tree

    rows = write_synthetic_npy_tree(tmp_path / "npy", n_subjects=3, duration_s=35.0)
    write_ids_csv(tmp_path / "ids_train.csv", [r for r in rows if r["subject"] < 2])
    write_ids_csv(tmp_path / "ids_valid.csv", [r for r in rows if r["subject"] == 2])
    ae_dir = tmp_path / "aekl"
    ae_dir.mkdir()
    aekl_cfg = Config()
    aekl_cfg.aekl.num_channels = list(AEKL_CH)
    aekl_cfg.to_yaml(ae_dir / "config.yaml")
    weights.save_params_npz(ae_dir / "params.npz", weights.aekl_state_to_jax(aekl_pair[0]))
    monkeypatch.setattr(sys, "argv", [
        "sleepgen_torch", "train-ldm", "--config_file", str(_tiny_moe_yaml(tmp_path)),
        "--autoencoderkl_config_file_path", str(ae_dir / "config.yaml"),
        "--best_model_path", str(ae_dir), "--path_train_ids", str(tmp_path / "ids_train.csv"),
        "--path_valid_ids", str(tmp_path / "ids_valid.csv"),
        "--path_pre_processed", str(tmp_path / "npy"), "--dtype", "float32", "--device", "cpu"])
    umbrella()
    assert "run_dir=" in capsys.readouterr().out
    run = tmp_path / "out" / "ldm_eeg_no-spectral_edfx"
    saved = Config.from_yaml(run / "best_model" / "config.yaml")
    assert saved.denoiser == "dit" and saved.dit.num_experts == 4
    with np.load(run / "best_model" / "params.npz") as data:
        assert "blocks/0/moe/experts/3/gate_proj/weight" in data.files
        assert "blocks/0/moe/gate/weight" in data.files
    sample_main(["--output_dir", str(tmp_path / "samples"), "--best_model_path", str(ae_dir),
                 "--diffusion_path", str(run / "best_model"), "--stop_seed", "2",
                 "--num_inference_steps", "2", "--sampler", "dpm++2m", "--batch_size", "2",
                 "--no_psd", "--device", "cpu"])
    out = tmp_path / "samples" / "samples_ldm_1_no-spectral_edfx"
    assert np.load(out / "sample_1.npy").shape == (1, 1, 3000)


def test_a_dense_dit_keeps_its_state_dict_and_outputs():
    """``num_experts`` 0 builds DiT-XL/2's dense MLP: the dense reference's
    names, its outputs, no MoE span or counter, no auxiliary loss."""
    state = _state(lambda: rdit.DiT(**DENSE), seeded.WEIGHTS_UNET)
    program = DiT1d(**DENSE, num_experts=0)
    assert list(program.state_dict()) == list(state)
    assert isinstance(program.blocks[0].mlp, dit.Mlp) and not hasattr(program.blocks[0], "moe")
    program.load_state_dict(state)
    reference = rdit.DiT(**DENSE).eval()
    reference.load_state_dict(state)
    x, t = _inputs()
    profiling.reset()
    with profiling.tracing():
        got = program(x, t, torch.tensor([0, 1, -1]))
        got.square().mean().backward()  # training mode, autograd on
    with torch.no_grad():
        want = reference(x, t, torch.tensor([0, 1, 5]))
    _close(got.detach(), want)
    assert program.aux_loss is None and profiling.counters()["dit.moe_layers"] == 0
    assert not any(s["name"].startswith("dit.moe.") for s in profiling.spans())
    profiling.reset()
