"""DiT-MoE's sparse layer (``sleepgen_torch/nn/moe.py``) on the card.

Every test here needs a CUDA card: they carry the ``cuda`` marker, and the
``cuda_card`` fixture skips them elsewhere. On the H100 they run with
``python -m pytest --noconftest -q tests/test_torch_cuda_moe.py``.
The grouped GEMMs against a loop over the experts on uneven offsets with
an empty expert; one full-width DiT-MoE-XL/2-8E2A layer in bf16 against its
loop in bf16 on the same routing and against the fp32 reference (closer
than the reference with fp8 products); a whole guided forward of the
full-width model with no wait for the card (``set_sync_debug_mode``
"error"), K4 at every pass between half-blocks as in the dense DiT, and a
training step's gradients reaching every expert.
"""
import pytest
import torch

from sleepgen_torch.nn import moe
from sleepgen_torch.utils import profiling

pytestmark = [pytest.mark.cuda, pytest.mark.usefixtures("cuda_card")]

MOE_XL2 = dict(in_channels=1, input_size=768, patch_size=2, hidden_size=1152, depth=28,
               num_heads=16, mlp_ratio=4.0, num_classes=5, num_experts=8,
               num_experts_per_tok=2, n_shared_experts=2)


@pytest.fixture
def cuda_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the grouped GEMMs have no interpret mode)")
    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    torch.cuda.set_sync_debug_mode(0)


def _rel(got, want):
    return float((got.float() - want.float()).norm() / want.float().norm())


def _loop_moe(block, x):
    """``block``'s output by a loop over the experts, each applied to its
    own tokens (host sizes), in the weights' dtype with ``x``'s: the
    dispatch's mathematics on the block's own routing."""
    b, t, d = x.shape
    u = x.reshape(b * t, d)
    idx, weight, _ = block.gate(u)
    i = block.experts.intermediate
    out = torch.zeros(b * t, d, dtype=torch.float32, device=x.device)
    for e in range(block.experts.num_experts):
        tok, slot = torch.nonzero(idx == e, as_tuple=True)
        if not len(tok):
            continue
        h = u[tok] @ block.experts.gate_up[e].t()
        y = (torch.nn.functional.silu(h[:, :i]) * h[:, i:]) @ block.experts.down[e].t()
        out.index_add_(0, tok, y.float() * weight[tok, slot, None])
    if block.n_shared_experts:
        out = out + block.shared_experts(u).float()
    return out.to(u.dtype).view(b, t, d)


def test_grouped_gemms_equal_a_loop_over_the_experts():
    """Uneven loads with an empty expert (and an empty last one): each
    expert's rows through its own SwiGLU, in bf16, to bf16 rounding."""
    torch.manual_seed(0)
    with torch.device("cuda"):
        experts = moe.Experts(8, 256, 512).to(torch.bfloat16).requires_grad_(False)
        counts = [0, 700, 33, 1, 300, 0, 1014, 0]
        ends = torch.tensor(counts).cumsum(0).to(torch.int32).cuda()
        rows = torch.randn(sum(counts), 256, device="cuda").bfloat16()
    got = experts(rows, ends, torch.bfloat16)
    assert got.shape == (sum(counts), 256) and got.dtype == torch.bfloat16
    start = 0
    for e, n in enumerate(counts):
        if n:
            h = rows[start:start + n].float() @ experts.gate_up[e].float().t()
            act = (torch.nn.functional.silu(h[:, :512]) * h[:, 512:]).bfloat16().float()
            want = act @ experts.down[e].float().t()
            assert _rel(got[start:start + n], want) < 2e-2, e
        start += n
    with pytest.raises(ValueError, match="bf16"):
        experts.float()(rows.float(), ends, torch.float32)


def _layer(seed=3):
    """DiT-MoE-XL/2-8E2A's sparse layer with bf16-exact random weights
    N(0, 1/fan_in), in bf16 and in fp32."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    with torch.device("cuda"):
        block = moe.SparseMoeBlock(1152, 4.0, 8, 2, 2).eval().requires_grad_(False)
    for p in block.parameters():
        p.copy_((torch.randn(p.shape, generator=g, device="cuda") * p.shape[-1] ** -0.5)
                .bfloat16().float())
    fp32 = block
    bf16 = moe.SparseMoeBlock(1152, 4.0, 8, 2, 2).cuda().eval().requires_grad_(False)
    bf16.load_state_dict(block.state_dict())
    return bf16.to(torch.bfloat16), fp32


def test_a_full_width_layer_in_bf16_against_fp32():
    """The dispatch in bf16 equals the loop over the experts on the same
    bf16 layer (the same routing) to bf16 rounding, and lies closer to the
    fp32 reference than the reference with fp8 products does."""
    from portbench.reference import dit_moe as rmoe, models as ref

    bf16, fp32 = _layer()
    g = torch.Generator(device="cuda").manual_seed(4)
    u = torch.randn((16, 384, 1152), generator=g, device="cuda")
    with torch.no_grad():
        got = bf16(u.bfloat16())
        loop = _loop_moe(bf16, u.bfloat16())
        want, fp8 = (rmoe.MoE(1152, 4.0, 8, 2, 2, 0.0, ref.Precision(p)).cuda().eval()
                     for p in ("fp32", "fp8"))
        want.load_state_dict(fp32.state_dict())
        fp8.load_state_dict(fp32.state_dict())
        want, fp8 = want(u.bfloat16().float()), fp8(u.bfloat16().float())
    assert _rel(got, loop) < 1e-2
    err, err_fp8 = _rel(got, want), _rel(fp8, want)
    print(f"MoE layer bf16 rel err {err:.5f}, fp8 reference {err_fp8:.5f}")
    assert torch.isfinite(got).all() and err <= 0.5 * err_fp8, (err, err_fp8)


def _moe_dit():
    from portbench import weights
    from portbench.reference import dit_moe as rmoe
    from sleepgen_torch.nn.dit import DiT1d
    from sleepgen_torch.nn.layers import cast_compute_dtype

    with torch.device("meta"):
        names = list(rmoe.DiTMoE(**MOE_XL2).state_dict())
    with torch.device("cuda"):
        model = DiT1d(**MOE_XL2)
    state = {}
    for i in range(MOE_XL2["depth"] + 1):
        part = [n for n in names if (n.startswith(f"blocks.{i - 1}.") if i
                                     else not n.startswith("blocks."))]
        shapes = {n: tuple(model.state_dict()[n].shape) for n in part}
        state.update(weights.make_state(shapes, (), 29, "cuda", 1000 + i))
    model.load_state_dict(state)
    del state
    return cast_compute_dtype(model.eval(), torch.bfloat16).requires_grad_(False)


def test_a_guided_forward_never_waits_for_the_card():
    """DiT-MoE-XL/2-8E2A at every published width, a guided forward of 2 x 8
    latents: no operation waits for the card, K4 runs at each of its 2
    depth + 1 passes as in the dense DiT, and the traced tally sees every
    routed row once read."""
    from sleepgen_torch.sample.samplers import cond_model_fn

    model = _moe_dit()
    g = torch.Generator(device="cuda").manual_seed(5)
    x = torch.randn((8, 1, 768), generator=g, device="cuda")
    t = torch.full((8,), 500, device="cuda")
    labels = torch.tensor([0, 1, 2, 3, 4, 0, 1, 2], device="cuda")
    fn = cond_model_fn(model, labels, 1.5)
    with torch.inference_mode():
        fn(x, t)  # the library's first calls may wait: build, handles
        torch.cuda.synchronize()
        before = profiling.counters()["k4.launches"]
        torch.cuda.set_sync_debug_mode("error")
        out = fn(x, t)
        torch.cuda.set_sync_debug_mode(0)
        launched = profiling.counters()["k4.launches"] - before
        profiling.reset()
        with profiling.tracing():
            fn(x, t)
        rows = profiling.keyed("dit.expert_rows")
        profiling.reset()
    assert torch.isfinite(out).all() and out.shape == x.shape
    assert launched == 2 * MOE_XL2["depth"] + 1
    assert sum(rows.values()) == MOE_XL2["depth"] * 16 * 384 * 2
    print("expert rows over the forward:", rows)


def test_a_training_step_reaches_every_expert_and_the_router():
    """One bf16-autocast forward and backward of a full-width layer in
    training mode: every expert, the router (through its weights and the
    auxiliary loss) and the shared experts get a gradient, and the loss
    includes the auxiliary loss."""
    torch.manual_seed(6)
    with torch.device("cuda"):
        block = moe.SparseMoeBlock(1152, 4.0, 8, 2, 2).train()
        u = torch.randn((4, 384, 1152), device="cuda")
    with torch.autocast("cuda", dtype=torch.bfloat16):
        out = block(u)
        loss = out.float().square().mean() + block.aux_loss
    loss.backward()
    assert out.dtype == torch.bfloat16 and float(block.aux_loss) > 0
    for name, p in block.named_parameters():
        assert p.grad is not None and torch.isfinite(p.grad).all(), name
    per_expert = block.experts.gate_up.grad.flatten(1).norm(dim=1)
    assert (per_expert > 0).all(), per_expert
    assert float(block.gate.weight.grad.norm()) > 0
