"""K2's bf16 kernel (``gn_silu_conv3_tc`` in csrc/gn_silu_conv3.cu), its
formulation mirrored in plain torch on the CPU before the card runs it.

The kernel reads each warpgroup's h tile through no-swizzle wgmma
descriptors (channel planes of 16-byte rows; a tap is the same planes from
one row further), makes h in quads of rows with a per-thread rotation
against bank conflicts, takes raw x from a tensor-map box that starts 8
positions before the tile, and folds the group statistics, merged once per
group in pieces, into a per-channel affine (a / 2, d / 2). Each of those is
rebuilt here from the kernel's constants and held to the plain version;
the names of K2's kernels are held to what the benchmark's roofline reader
counts. No JAX.
"""
import ast
import re
from pathlib import Path

import pytest
import torch
import torch.nn.functional as F

from sleepgen_torch.kernels import fused_resblock, group_norm  # noqa: F401 (K2 registers its counters)
from sleepgen_torch.kernels.group_norm import group_norm_silu_reference
from sleepgen_torch.utils import profiling

ROOT = Path(__file__).resolve().parent.parent
SRC = ROOT / "sleepgen_torch" / "csrc" / "gn_silu_conv3.cu"
READER = ROOT / "portbench" / "metrics" / "k2_roofline_pct.sample.py"

# tc:: constants of csrc/gn_silu_conv3.cu
KC, TN, MW = 64, 128, 3
TM = 64 * MW
XOFF, XP = 8, TM + 16
HR = 64 + 2
PLANE = 72 * 16
SBO = 128


def _constant(name):
    """An int constexpr of the source, as the kernel has it."""
    m = re.search(rf"constexpr int {name} = ([^;]+);", SRC.read_text())
    return m.group(1).strip()


def test_constants_are_the_kernels():
    src = {k: _constant(k) for k in ("KC", "TN", "MW", "XOFF", "XP", "HR", "PLANE")}
    assert src == {"KC": "64", "TN": "128", "MW": "3", "XOFF": "8", "XP": "TM + 16",
                   "HR": "64 + 2", "PLANE": "72 * 16"}


def test_k2_kernels_are_counted_by_the_roofline_reader():
    """Every __global__ kernel of K2's source has a name the k2_roofline_pct
    readers count, so they see all of K2's device time."""
    kernels = ast.literal_eval(next(
        node.value for node in ast.parse(READER.read_text()).body
        if isinstance(node, ast.Assign) and node.targets[0].id == "KERNELS"))
    names = re.findall(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s+)?(\w+)\s*\(",
                       SRC.read_text())
    assert {"gn_silu_conv3_tc", "gn_silu_conv3_tc_stats", "gn_silu_conv3_fp32"} <= set(names)
    assert all(any(k in name for k in kernels) for name in names), (names, kernels)


def test_k2_form_counters_are_registered_and_counted():
    profiling.reset()
    counters = profiling.counters()
    assert counters["k2.form.tma"] == 0 and counters["k2.form.elem"] == 0
    t0 = profiling.clock_ns()
    group_norm.count_launch("k2", (2, 128, 128, 768, 32, "torch.bfloat16"), t0, 0)
    group_norm.count_launch("k2", (2, 128, 128, 1002, 32, "torch.bfloat16"), t0, 1)
    group_norm.count_launch("k2", (2, 128, 128, 768, 32, "torch.float32"), t0)
    counters = profiling.counters()
    assert (counters["k2.form.tma"], counters["k2.form.elem"], counters["k2.launches"]) == (1, 1, 3)
    profiling.reset()
    assert profiling.counters()["k2.form.tma"] == 0


def _quad_rows(t):
    """Thread t's quad of h rows, in the order it stores them (rotated)."""
    r0, rot = 4 * (t % 16) + 1, (t % 16) // 2 % 4
    return [r0 + (j + rot) % 4 for j in range(4)]


def test_transform_covers_each_row_once_and_stores_without_conflicts():
    """The 128 threads' quads (rows 1 .. 64 of plane t / 16) and the edge
    rows (threads 8 k: row 0 or 65 of plane k % 8) write every (plane, row)
    of a warpgroup's h once; each store instruction's quarter-warps hit 8
    distinct 16-byte bank groups; each quad's raw x is one aligned 8-byte
    load inside the box."""
    written = []
    for t in range(128):
        written += [(t // 16, r) for r in _quad_rows(t)]
        if t % 8 == 0:
            k = t // 8
            written.append((k % 8, 0 if k < 8 else HR - 1))
    assert sorted(written) == [(p, r) for p in range(8) for r in range(HR)]
    for warp in range(4):
        for j in range(4):
            for quarter in range(4):
                lanes = range(32 * warp + 8 * quarter, 32 * warp + 8 * quarter + 8)
                groups = {((t // 16) * PLANE + _quad_rows(t)[j] * 16) // 16 % 8 for t in lanes}
                assert len(groups) == 8
    for wg in range(MW):
        for r in range(HR):
            e = 64 * wg + XOFF - 1 + r  # raw x element of h row r: position l0 - XOFF + e
            assert 0 <= e < XP
        for t in range(128):
            e0 = 64 * wg + XOFF - 1 + 4 * (t % 16) + 1
            assert e0 % 4 == 0 and e0 + 3 < XP  # 8-byte aligned, inside the row
    assert (XP * 2) % 16 == 0 and XOFF % 8 == 0  # the box: 16-byte rows, an aligned start


def _a_tile(planes, k, j):
    """The 64 x 16 A operand a no-swizzle descriptor reads at start 2 j PLANE
    + 16 k, LBO PLANE, SBO 128: element (m, kk) at start + (m // 8) SBO + (m %
    8) 16 + (kk // 8) LBO + (kk % 8) 2 bytes, looked up in planes[p][row][c]
    (byte p PLANE + 16 row + 2 c)."""
    flat = planes.reshape(-1)  # bf16 elements, 2 bytes each
    m = torch.arange(64)[:, None]
    kk = torch.arange(16)[None, :]
    byte = 2 * j * PLANE + 16 * k + (m // 8) * SBO + (m % 8) * 16 + (kk // 8) * PLANE + (kk % 8) * 2
    return flat[byte // 2]


@pytest.mark.parametrize("b,cin,cout,l,g", [(1, 128, 128, 384, 32), (2, 96, 40, 200, 8),
                                            (1, 64, 128, 130, 4)])
def test_descriptor_taps_of_the_h_planes_are_the_convolution(b, cin, cout, l, g):
    """Every tile and warpgroup: h laid out in the kernel's planes (rows at
    positions lw - 1 .., zero outside [0, L) and past C_in), read through
    the descriptors of the twelve products per chunk, summed over chunks
    against W_k, is the plain version's convolution (fp32, before the bias
    and the output rounding)."""
    gen = torch.Generator().manual_seed(cin + l)
    x = torch.randn(b, cin, l, generator=gen)
    scale, bias = 1 + 0.2 * torch.randn(cin, generator=gen), 0.2 * torch.randn(cin, generator=gen)
    w = torch.randn(cout, cin, 3, generator=gen) / (3 * cin) ** 0.5
    h = group_norm_silu_reference(x, scale, bias, g)  # (B, C_in, L)
    want = F.conv1d(h, w, padding=1)
    nk = -(-cin // KC)
    hp = F.pad(h, (0, 0, 0, nk * KC - cin))  # channels past C_in are 0
    wp = F.pad(w, (0, 0, 0, nk * KC - cin))
    for bi in range(b):
        for lt in range(-(-l // TM)):
            for wg in range(MW):
                lw = lt * TM + 64 * wg
                acc = torch.zeros(64, cout)
                for kc in range(nk):
                    planes = torch.zeros(8, PLANE // 16, 8)
                    for r in range(HR):
                        pos = lw - 1 + r
                        if 0 <= pos < l:
                            planes[:, r] = hp[bi, kc * KC:(kc + 1) * KC, pos].view(8, 8)
                    for k in range(3):
                        for j in range(4):
                            a = _a_tile(planes, k, j)
                            acc += a @ wp[:, kc * KC + 16 * j:kc * KC + 16 * j + 16, k].T
                rows = [m for m in range(64) if lw + m < l]
                torch.testing.assert_close(acc[rows], want[bi, :, lw:lw + len(rows)].T,
                                           rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("n,v", [(3072, 8), (36864, 8), (130 * 3, 1), (12288, 1)])
def test_statistics_pieces_and_affine_fold(n, v):
    """The statistics kernel's pieces (128 threads x 4 loads of 8 elements,
    or 16 loads of 1), two passes each, merged in order by Chan's formula,
    give the group's mean and biased variance; the affine (a / 2, d / 2) it
    writes gives silu(a x + d) as u + u tanh(u), u = a' x + d'."""
    gen = torch.Generator().manual_seed(n)
    xg = (3 + 2 * torch.randn(n, generator=gen, dtype=torch.float64)).float()
    piece = 128 * (4 if v == 8 else 16) * v
    count = mean = m2 = 0.0
    for p0 in range(0, n, piece):
        part = xg[p0:p0 + piece]
        cnt = part.numel()
        pm = part.sum() / cnt
        pm2 = ((part - pm) ** 2).sum()
        total = count + cnt
        delta = pm - mean
        mean = mean + delta * (cnt / total)
        m2 = m2 + pm2 + delta * delta * (count / total) * cnt
        count = total
    var, ref_mean = torch.var_mean(xg.double(), unbiased=False)
    assert abs(float(mean) - float(ref_mean)) <= 1e-5 * abs(float(ref_mean))
    assert abs(float(m2 / count) - float(var)) <= 1e-5 * float(var)
    rstd = torch.rsqrt(torch.tensor(float(m2 / count) + 1e-6))
    scale, bias_c = torch.tensor(1.3), torch.tensor(-0.4)
    a = rstd * scale
    a_half, d_half = 0.5 * a, 0.5 * (bias_c - mean * a)
    u = a_half * xg + d_half
    torch.testing.assert_close(u + u * torch.tanh(u), F.silu(a * xg + (bias_c - mean * a)),
                               rtol=1e-5, atol=1e-6)

