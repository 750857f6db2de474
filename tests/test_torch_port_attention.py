"""The attention's dispatch (``sleepgen_torch/kernels/attention.py``) and K5's
plain version on the CPU, against the JAX package.

The plain version is held to JAX's fast-math SelfAttention1d
(``mixed_precision``) in bf16 on the same bf16 q, k and v (projections that
permute channels, exact in bf16): both round the scaled q and k, and the
softmax weights, to bf16 at the same places, so they differ only where
their fp32 sums, taken in other orders, round the bf16 output the other
way: within one bf16 step of the output (2^-8 relative) plus 2^-10 of the
largest output. K5 itself runs only on a card (tests/test_torch_cuda_kernels.py).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sleepgen.nn.layers import SelfAttention1d as JaxSelfAttention
from sleepgen_torch.kernels import attention as K
from sleepgen_torch.nn.layers import SelfAttention1d, attention
from sleepgen_torch.utils import profiling, weights


@pytest.fixture(autouse=True)
def zeroed_counters():
    profiling.reset()
    yield
    profiling.reset()


def _permuting_attention(heads, c, rng):
    """JAX parameters and the port's state dict of a SelfAttention1d whose
    qkv projection permutes the input channels into q, k and v, and whose
    output projection is the identity."""
    eye = np.eye(c, dtype=np.float32)
    k3 = np.stack([eye, eye[rng.permutation(c)], eye[rng.permutation(c)]], 1)
    k3 = k3.reshape(c, 3, heads, c // heads).transpose(0, 2, 1, 3).reshape(1, c, 3 * c)
    params = {"qkv": {"kernel": k3, "bias": np.zeros(3 * c, np.float32)},
              "proj_out": {"kernel": eye[None], "bias": np.zeros(c, np.float32)}}
    sd = {}
    weights._conv(sd, "qkv", params["qkv"])
    weights._conv(sd, "proj_out", params["proj_out"])
    return params, sd


@pytest.mark.parametrize("heads,c,l,scale", [(1, 64, 48, 1.0), (2, 64, 40, 2.0), (1, 128, 64, 3.0)])
def test_plain_version_matches_jax_fast_math_in_bf16(heads, c, l, scale):
    rng = np.random.default_rng(11)
    params, sd = _permuting_attention(heads, c, rng)
    x = jnp.asarray((scale * rng.normal(size=(2, l, c))).astype(np.float32), jnp.bfloat16)
    jm = JaxSelfAttention(heads, dtype=jnp.bfloat16, zero_out=False, mixed_precision=True)
    want = np.asarray(jm.apply({"params": params}, x).astype(jnp.float32)).transpose(0, 2, 1)
    xt = torch.from_numpy(np.asarray(x.astype(jnp.float32)).transpose(0, 2, 1).copy())
    pm = weights.load_numpy_state(SelfAttention1d(c, heads), sd).to(torch.bfloat16)
    qkv = pm.project_qkv(xt.bfloat16()).detach()
    got = K.attention_reference(qkv, heads).float().numpy()
    tol = 2.0**-8 * np.abs(want) + 2.0**-10 * np.abs(want).max()
    assert (np.abs(got - want) <= tol).all(), np.abs(got - want).max()
    # the layer's own path on the CPU: the plain version where K5 takes the
    # shape on a card (d 32 it does not: SDPA)
    path = K.attention_reference if K.k5_takes(l, c // heads) else (
        lambda t, h: K.sdpa_attention(t, h, True))
    with torch.no_grad():
        assert torch.equal(pm(xt.bfloat16()), pm.proj_out(path(qkv, heads)))


@pytest.mark.parametrize("device,dtype,grad,mixed,length,d,want", [
    ("cuda", torch.bfloat16, False, True, 768, 512, "k5"),
    ("cuda", torch.bfloat16, False, True, 192, 512, "k5"),
    ("cuda", torch.bfloat16, False, True, 8, 64, "k5"),
    ("cpu", torch.bfloat16, False, True, 768, 512, "plain"),
    ("cuda", torch.bfloat16, True, True, 768, 512, "sdpa"),      # autograd follows it
    ("cpu", torch.bfloat16, True, True, 768, 512, "sdpa"),
    ("cuda", torch.bfloat16, False, False, 768, 512, "sdpa"),    # the strict path
    ("cuda", torch.float32, False, True, 768, 512, "sdpa"),
    ("cuda", torch.float16, False, True, 768, 512, "sdpa"),
    ("cuda", torch.bfloat16, False, True, 3072, 512, "declined"),  # the long window
    ("cuda", torch.bfloat16, False, True, 776, 512, "declined"),
    ("cuda", torch.bfloat16, False, True, 100, 64, "declined"),
    ("cuda", torch.bfloat16, False, True, 768, 32, "declined"),
    ("cuda", torch.bfloat16, False, True, 768, 576, "declined"),
    ("cpu", torch.bfloat16, False, True, 3072, 512, "declined"),
])
def test_route_sends_only_bf16_fast_math_inference_within_k5s_shapes_to_k5(
        device, dtype, grad, mixed, length, d, want):
    assert K.route(device, dtype, grad, mixed, length, d) == want


def test_attention_on_the_cpu_runs_the_plain_version_or_sdpa():
    """bf16 without gradient: the plain version; fp32, the strict path and
    autograd: SDPA as before; a bf16 row K5 would not take: SDPA, counted."""
    rng = np.random.default_rng(12)
    qkv = torch.from_numpy(rng.normal(size=(2, 3 * 128, 48)).astype(np.float32))
    bf = qkv.bfloat16()
    assert torch.equal(attention(bf, 2), K.attention_reference(bf, 2))
    assert torch.equal(attention(qkv, 2), K.sdpa_attention(qkv, 2, True))
    assert torch.equal(attention(bf, 2, mixed_precision=False), K.sdpa_attention(bf, 2, False))
    grad = bf.float().requires_grad_(True)
    out = attention(grad.bfloat16(), 2)
    assert out.requires_grad and torch.equal(out.detach(), K.sdpa_attention(bf, 2, True))
    assert profiling.counters()["k5.declined"] == 0
    odd = torch.from_numpy(rng.normal(size=(1, 3 * 64, 50)).astype(np.float32)).bfloat16()
    assert torch.equal(attention(odd, 1), K.sdpa_attention(odd, 1, True))
    c = profiling.counters()
    assert (c["k5.declined"], c["k5.launches"]) == (1, 0)


def test_the_launcher_takes_no_cpu_tensor():
    qkv = torch.zeros((1, 3 * 64, 64), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA"):
        K.fused_attention(qkv, 1)
    assert profiling.counters()["k5.launches"] == 0


def test_k5_counters_are_registered_and_the_traced_twin_follows_replays():
    """``counters()`` lists K5's counters at 0; ``k5.traced_launches`` gains
    what ``k5.launches`` gains while the tracer records, a graph replay's
    ``add_counts`` included, and nothing otherwise."""
    c = profiling.counters()
    assert {k: c[k] for k in ("k5.launches", "k5.traced_launches", "k5.declined")} == dict.fromkeys(
        ("k5.launches", "k5.traced_launches", "k5.declined"), 0)
    profiling.count("k5.launches")
    before = profiling.snapshot_counts()
    profiling.count("k5.launches", 6)
    made = profiling.take_back_counts(before)
    assert made["k5.launches"] == 6
    with profiling.tracing():
        profiling.count("k5.launches")
        profiling.add_counts(made, 2)
    profiling.add_counts(made, 1)
    c = profiling.counters()
    assert (c["k5.launches"], c["k5.traced_launches"]) == (1 + 1 + 12 + 6, 1 + 12)
