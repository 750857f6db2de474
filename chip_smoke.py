#!/usr/bin/env python3
"""Drive sleepgen_torch on one CUDA card and check it end to end.

Run from the repo root on a machine with an NVIDIA Hopper card and the
CUDA toolkit: ``python3 chip_smoke.py``. Phases, one line each:

  1. device: the card's name and power limit (nvidia-smi);
  2. build: compile the kernels from sleepgen_torch/csrc, one nvcc per
     source, in parallel;
  3. kernel checks: a one-step run of the main path records the shapes it
     gives each kernel; at every one of them, each kernel is held to its
     plain PyTorch version, in fp32 (TF32 off; K1 rtol 1e-5 / atol 2e-6,
     K2 2e-4, the bounds of tests/test_pallas_kernels.py) and in bf16
     (against the plain version in fp32 on the same bf16 inputs, to bf16
     rounding: K1 |err| <= 2^-8 |ref| + 1e-5, K2 |err| <= 2^-8 |ref| +
     2^-6 rms(ref), as K2 also rounds h to bf16 before its convolution);
  4. tiny sampler: 4 DDIM steps plus decode at tiny widths, on the card
     with the kernels against the CPU with the plain versions, same seeds
     and weights, fp32, at the model parity bound (rtol 2e-3 / atol 2e-4);
  5. full width: ``sample_ldm_trials`` at the flagship configuration
     (UNet mc 128 / [1, 2, 4] / attention [8, 4] / G 32 / latent 768 x 1,
     AEKL [32, 32, 64], bf16), batch 64, 200 DDIM steps, seeded random
     weights, called once per batch for three batches after the warm-up;
     each batch's launch counts must equal those derived from the
     configuration; prints each batch's seconds and the median windows/s;
     then one batch in a fresh process (``--cold-batch``), the first batch
     a user of the entry point pays for (kernels already on disk);
  6. timings: each kernel at each main-path shape in bf16: kernel, plain
     version, one-PyTorch-call yardstick (``library_ms``) and the bound;
  7. profile: model build and one AEKL decode on the host clock; the PSD's
     scipy import (fresh process) and DPSS taper solve; five full-width
     DDIM steps on the host clock, then again under torch.profiler: device
     time per step by kernel, and the device's busy share of the wall time.

The line before the device line at the end is one JSON object with every
kernel's launches in one batch of the main path, its error and its times
(each shape's time times its launches in that batch, summed: ms per
batch); the last line is {"ok": true, "device": {...}}. Per-shape details
go to chiprun_out/chip_smoke_report.json. Any failure raises and the
script exits non-zero without the last line.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

from sleepgen_torch.config import Config  # noqa: E402
from sleepgen_torch.kernels import _build, fused_resblock, group_norm  # noqa: E402
from sleepgen_torch.eval.psd import dpss_tapers  # noqa: E402
from sleepgen_torch.sample.sample_ldm import (build_aekl, build_models,  # noqa: E402
                                              build_unet, sample_ldm_trials,
                                              sampling_schedule)
from sleepgen_torch.sample.samplers import ddim_sample_loop  # noqa: E402
from sleepgen_torch.utils.weights import seeded_state_dict  # noqa: E402

# Published H100 SXM peaks (dense): HBM bytes/s, bf16 tensor-core and
# fp32 CUDA-core operations/s.
HBM_BYTES_PER_S = 3.35e12
BF16_TC_OPS_PER_S = 989e12
FP32_OPS_PER_S = 67e12
GN_OPS_PER_ELEMENT = 12  # stats 4, normalise + affine 4, SiLU 4
BATCH, STEPS, SEED = 64, 200, 0
TIMED_BATCHES = 3

K1_SRC = "sleepgen_torch/csrc/group_norm_silu.cu"  # + the shared gn_stats.cu
K2_SRC = "sleepgen_torch/csrc/gn_silu_conv3.cu"
K1_REPLACES = "sleepgen/pallas_kernels/group_norm.py:125"
K2_REPLACES = "sleepgen/pallas_kernels/fused_resblock.py:142"


def say(phase: str, **fields) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in fields.items()), flush=True)


def flagship_config(steps: int) -> Config:
    cfg = Config()  # UNet mc 128 [1,2,4] attn [8,4] G 32, AEKL [32,32,64], bf16
    cfg.unet.image_size = 768
    cfg.diffusion.num_inference_steps = steps
    return cfg


def tiny_config(steps: int) -> Config:
    cfg = Config()
    cfg.dtype = "float32"
    cfg.unet.model_channels, cfg.unet.channel_mult = 32, [1, 2]
    cfg.unet.attention_resolutions, cfg.unet.norm_num_groups = [2], 8
    cfg.unet.image_size = 64
    cfg.aekl.num_channels = [4, 4, 8]
    cfg.diffusion.num_inference_steps = steps
    return cfg


def seeded_weights(cfg: Config, seed: int):
    lc = cfg.aekl.latent_channels
    with torch.device("meta"):
        unet, ae = build_unet(cfg, lc, lc), build_aekl(cfg)
    return seeded_state_dict(unet, seed), seeded_state_dict(ae, seed + 1)


def expected_launches(cfg: Config, unet_forwards: int, decodes: int) -> dict:
    """Kernel launches of the sampler, derived from the configuration: K2
    runs both chains of every plain resblock and chain 2 of every
    resampling one; K1 runs chain 1 of the resampling resblocks, every
    attention norm and the UNet's output norm, and every AEKL decoder
    GroupNorm (two per resblock and norm_out)."""
    u, a = cfg.unet, cfg.aekl
    levels, nrb = len(u.channel_mult), u.num_res_blocks
    plain = levels * nrb + 2 + levels * (nrb + 1)
    resampling = 2 * (levels - 1)
    attn = 1 + sum((nrb + nrb + 1) for level in range(levels)
                   if 2**level in u.attention_resolutions)
    k1_unet = resampling + attn + 1
    k1_decode = 2 * len(a.num_channels) * a.num_res_blocks + 1
    return {"K1": unet_forwards * k1_unet + decodes * k1_decode,
            "K2": unet_forwards * (2 * plain + resampling)}


def reset_counts() -> None:
    group_norm.reset_counts()
    fused_resblock.reset_counts()


# -- kernel inputs, references, yardsticks ------------------------------------

def k1_inputs(key, dtype, seed):
    b, c, l, g, silu, _ = key
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = (torch.randn((b, c, l), generator=gen, device="cuda") + 0.5).to(dtype)
    scale = 1.0 + 0.2 * torch.randn(c, generator=gen, device="cuda")
    bias = 0.2 * torch.randn(c, generator=gen, device="cuda")
    return (x, scale, bias, g, 1e-6, silu)


def k2_inputs(key, dtype, seed):
    b, cin, cout, l, g, _ = key
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = (torch.randn((b, cin, l), generator=gen, device="cuda") + 0.5).to(dtype)
    scale = 1.0 + 0.2 * torch.randn(cin, generator=gen, device="cuda")
    bias = 0.2 * torch.randn(cin, generator=gen, device="cuda")
    w = (torch.randn((cout, cin, 3), generator=gen, device="cuda") / (3 * cin) ** 0.5).to(dtype)
    bb = (0.1 * torch.randn(cout, generator=gen, device="cuda")).to(dtype)
    return (x, scale, bias, w, bb, g, 1e-6)


def k1_library(x, scale, bias, g, eps, silu):
    y = F.group_norm(x, g, scale.to(x.dtype), bias.to(x.dtype), eps)
    return F.silu(y) if silu else y


def k2_library(x, scale, bias, w, bb, g, eps):
    h = F.silu(F.group_norm(x, g, scale.to(x.dtype), bias.to(x.dtype), eps))
    return F.conv1d(h, w, bb, padding=1)


def k1_bound(key, dtype):
    b, c, l, *_ = key
    n = b * c * l
    t_bytes = (2 * n * dtype.itemsize + 8 * c) / HBM_BYTES_PER_S
    t_ops = GN_OPS_PER_ELEMENT * n / FP32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def k2_bound(key, dtype):
    """The convolution's products on the tensor cores and the GroupNorm's
    fp32 work on the CUDA cores can overlap, so the least time is the
    largest of the three times, not a sum."""
    b, cin, cout, l, *_ = key
    t_bytes = ((b * cin * l + cout * cin * 3 + cout + b * cout * l) * dtype.itemsize
               + 8 * cin) / HBM_BYTES_PER_S
    t_ops = max(2 * 3 * b * l * cin * cout / BF16_TC_OPS_PER_S,
                GN_OPS_PER_ELEMENT * b * cin * l / FP32_OPS_PER_S)
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


KERNELS = {
    "K1": dict(name="group_norm_silu", module=group_norm, src=K1_SRC, replaces=K1_REPLACES,
               inputs=k1_inputs, kernel=group_norm.group_norm_silu,
               plain=group_norm.group_norm_silu_reference, library=k1_library,
               bound=k1_bound, fp32_tol=(1e-5, 2e-6)),
    "K2": dict(name="gn_silu_conv3", module=fused_resblock, src=K2_SRC, replaces=K2_REPLACES,
               inputs=k2_inputs, kernel=fused_resblock.gn_silu_conv3,
               plain=fused_resblock.gn_silu_conv3_reference, library=k2_library,
               bound=k2_bound, fp32_tol=(2e-4, 2e-4)),
}


def bf16_tolerance(kid: str, ref: torch.Tensor) -> torch.Tensor:
    rtol = 2.0**-8
    if kid == "K1":
        return rtol * ref.abs() + 1e-5
    return rtol * ref.abs() + 4 * rtol * ref.square().mean().sqrt()


def check_kernel(kid: str, key) -> dict:
    spec = KERNELS[kid]
    out = {}
    args = spec["inputs"](key, torch.float32, seed=1)
    got = spec["kernel"](*args)
    torch.cuda.synchronize()
    want = spec["plain"](*args)
    rtol, atol = spec["fp32_tol"]
    torch.testing.assert_close(got, want, rtol=rtol, atol=atol,
                               msg=lambda m: f"{kid} fp32 at {key}: {m}")
    out["fp32_max_abs_err"] = float((got - want).abs().max())

    args = spec["inputs"](key, torch.bfloat16, seed=2)
    got = spec["kernel"](*args)
    torch.cuda.synchronize()
    up = [a.float() if torch.is_tensor(a) else a for a in args]
    want = spec["plain"](*up)
    err = (got.float() - want).abs()
    if not bool((err <= bf16_tolerance(kid, want)).all()):
        raise AssertionError(f"{kid} bf16 at {key}: max abs err {float(err.max())}")
    out["bf16_max_abs_err"] = float(err.max())
    return out


def time_ms(fn, args, reps: int) -> float:
    for _ in range(3):
        fn(*args)
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn(*args)
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


# -- phases --------------------------------------------------------------------

def phase_device() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() is False)")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    say("device", name=torch.cuda.get_device_name(0), count=torch.cuda.device_count(),
        torch=torch.__version__, cuda=torch.version.cuda)
    return smi


def phase_build() -> dict:
    t0 = time.perf_counter()
    logs = _build.build()
    _build.load()
    say("build", seconds=f"{time.perf_counter() - t0:.2f}", built=",".join(logs) or "cached")
    return logs


def phase_checks(tmp: Path) -> tuple:
    """One DDIM step of the main path records the shapes it gives each
    kernel (the counts of that warm-up run are discarded), then every
    kernel is checked at every shape. The warm-up also pays the
    process's one-time costs (cuDNN plans, the import of scipy.signal for
    the PSD's tapers, which takes seconds), so phase 5 times steady-state
    batches."""
    cfg = flagship_config(steps=1)
    unet_sd, ae_sd = seeded_weights(cfg, SEED)
    reset_counts()
    sample_ldm_trials(cfg, unet_sd, ae_sd, 1.0, tmp / "warmup", 0, BATCH, BATCH)
    torch.cuda.synchronize()
    shapes = {"K1": dict(group_norm.launch_shapes), "K2": dict(fused_resblock.launch_shapes)}
    reset_counts()
    results = {kid: {key: check_kernel(kid, key) for key in shapes[kid]} for kid in KERNELS}
    for kid, res in results.items():
        say("check", kernel=KERNELS[kid]["name"], shapes=len(res),
            fp32_max_abs_err=f"{max(r['fp32_max_abs_err'] for r in res.values()):.3e}",
            bf16_max_abs_err=f"{max(r['bf16_max_abs_err'] for r in res.values()):.3e}")
    return shapes, results


def phase_tiny(tmp: Path) -> None:
    cfg = tiny_config(steps=4)
    unet_sd, ae_sd = seeded_weights(cfg, SEED + 10)
    kw = dict(start_seed=0, stop_seed=4, batch_size=4, compute_psd=False)
    reset_counts()
    card = sample_ldm_trials(cfg, unet_sd, ae_sd, 1.3, tmp / "tiny_card", device="cuda", **kw)
    counts = (group_norm.launches, fused_resblock.launches)
    cpu = sample_ldm_trials(cfg, unet_sd, ae_sd, 1.3, tmp / "tiny_cpu", device="cpu", **kw)
    want = expected_launches(cfg, unet_forwards=4, decodes=1)
    if counts != (want["K1"], want["K2"]):
        raise AssertionError(f"tiny sampler launches {counts}, expected {want}")
    np.testing.assert_allclose(card, cpu, rtol=2e-3, atol=2e-4,
                               err_msg="tiny sampler: card (kernels) vs CPU (plain)")
    say("tiny", shape=card.shape, max_abs_err=f"{np.abs(card - cpu).max():.3e}",
        k1_launches=counts[0], k2_launches=counts[1])


def phase_full(tmp: Path) -> dict:
    """Three full-width batches, each one call of the entry point as a
    user makes it (model build, 200 steps, decode, artifacts), with the
    counts set to 0 before and read after each."""
    cfg = flagship_config(steps=STEPS)
    unet_sd, ae_sd = seeded_weights(cfg, SEED)
    want = expected_launches(cfg, unet_forwards=STEPS, decodes=1)
    seconds = []
    for i in range(TIMED_BATCHES):
        seeds = (i * BATCH, (i + 1) * BATCH)
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = sample_ldm_trials(cfg, unet_sd, ae_sd, 1.0, tmp / "full", *seeds, BATCH)
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
        launches = {"K1": group_norm.launches, "K2": fused_resblock.launches}
        shapes = {"K1": dict(group_norm.launch_shapes), "K2": dict(fused_resblock.launch_shapes)}
        if out.shape != (BATCH, 3000, 1) or not np.isfinite(out).all():
            raise AssertionError(f"full-width output {out.shape}, finite={np.isfinite(out).all()}")
        if launches != want or min(launches.values()) == 0:
            raise AssertionError(f"batch {i}: launches {launches}, expected {want}")
        if not (tmp / "full" / f"sample_{seeds[1] - 1}.npy").exists():
            raise AssertionError("artifacts missing")
        say("full", batch=i, shape=out.shape, seconds=f"{seconds[-1]:.3f}",
            k1_launches=launches["K1"], k2_launches=launches["K2"], out_std=f"{out.std():.4f}")
    median = statistics.median(seconds)
    say("full", batches=TIMED_BATCHES, median_seconds=f"{median:.3f}",
        min_seconds=f"{min(seconds):.3f}", max_seconds=f"{max(seconds):.3f}",
        windows_per_s=f"{BATCH / median:.3f}")
    return dict(seconds=seconds, median_seconds=median, windows_per_s=BATCH / median,
                launches=launches, shapes=shapes)


def cold_batch(out_dir: str) -> None:
    """Body of ``--cold-batch``: one full-width batch through the entry
    point in this fresh process; prints its seconds as JSON. The clock
    starts after ``import torch`` and the weights are made, before the
    process first touches the card, so it includes the CUDA context."""
    cfg = flagship_config(steps=STEPS)
    unet_sd, ae_sd = seeded_weights(cfg, SEED)
    t0 = time.perf_counter()
    out = sample_ldm_trials(cfg, unet_sd, ae_sd, 1.0, out_dir, 0, BATCH, BATCH)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    if out.shape != (BATCH, 3000, 1) or not np.isfinite(out).all():
        raise AssertionError(f"cold batch output {out.shape}")
    print(json.dumps({"cold_seconds": seconds}), flush=True)


def phase_cold(tmp: Path) -> dict:
    proc = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--cold-batch",
                           str(tmp / "cold")], capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        raise RuntimeError(f"cold batch failed ({proc.returncode}):\n{proc.stderr[-4000:]}")
    seconds = json.loads(proc.stdout.strip().splitlines()[-1])["cold_seconds"]
    say("cold", seconds=f"{seconds:.3f}", windows_per_s=f"{BATCH / seconds:.3f}")
    return dict(seconds=seconds, windows_per_s=BATCH / seconds)


def phase_timings(full: dict, checks: dict) -> list:
    rows, per_shape = [], []
    for kid, spec in KERNELS.items():
        tot = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, library_ms=0.0)
        bound_kinds = set()
        for key, count in sorted(full["shapes"][kid].items()):
            args = spec["inputs"](key, torch.bfloat16, seed=3)
            reps = 20 if kid == "K2" else 50
            t = dict(ms=time_ms(spec["kernel"], args, reps),
                     plain_ms=time_ms(spec["plain"], args, reps),
                     library_ms=time_ms(spec["library"], args, reps))
            t["bound_ms"], kind = spec["bound"](key, torch.bfloat16)
            bound_kinds.add(kind)
            for k in tot:
                tot[k] += t[k] * count
            per_shape.append(dict(kernel=spec["name"], shape=list(key), launches=count,
                                  bound_by=kind, **t))
            say("time", kernel=spec["name"], shape=key, launches=count,
                **{k: f"{v:.4f}" for k, v in t.items()})
        errs = checks[kid].values()
        rows.append(dict(
            name=spec["name"], route="cuda", source=spec["src"], replaces=spec["replaces"],
            launches=full["launches"][kid],
            max_abs_err=max(r["bf16_max_abs_err"] for r in errs),
            ms=tot["ms"], plain_ms=tot["plain_ms"], bound_ms=tot["bound_ms"],
            bound_by="operations" if "operations" in bound_kinds else "bytes",
            library_ms=tot["library_ms"]))
    return rows, per_shape


def _device_us(event) -> float:
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(event, attr):
            return float(getattr(event, attr))
    return 0.0


def time_psd_setup() -> dict:
    """The PSD's one-time costs: importing scipy's windows module in a
    fresh process that has numpy loaded, and solving the 3000-sample DPSS
    tapers (cache cleared before each of three solves; median)."""
    code = ("import time, numpy; t = time.perf_counter(); import scipy.signal.windows; "
            "print(time.perf_counter() - t)")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          check=True, timeout=120)
    scipy_import_ms = float(proc.stdout.strip().splitlines()[-1]) * 1e3
    solves = []
    for _ in range(3):
        dpss_tapers.cache_clear()
        t0 = time.perf_counter()
        dpss_tapers(3000)
        solves.append((time.perf_counter() - t0) * 1e3)
    return dict(scipy_import_ms=scipy_import_ms, dpss_ms=statistics.median(solves),
                dpss_ms_all=solves)


def phase_profile() -> dict:
    """Where a full-width batch's time goes: model build (as
    sample_ldm_trials does it), the PSD's one-time set-up, five DDIM
    steps (UNet forward + step, batch 64, bf16) on the host clock and then
    under torch.profiler (device time per step by kernel; busy share =
    device time / wall time), and one AEKL decode."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    cfg = flagship_config(steps=STEPS)
    unet_sd, ae_sd = seeded_weights(cfg, SEED)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    unet, ae = build_models(cfg, unet_sd, ae_sd, torch.device("cuda"))
    torch.cuda.synchronize()
    build_ms = (time.perf_counter() - t0) * 1e3
    psd_setup = time_psd_setup()
    sched = sampling_schedule(cfg, "cuda")
    x = torch.randn((BATCH, 1, 768), device="cuda")
    n = 5
    with torch.inference_mode():
        ae.decode_stage_2_outputs(x)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ae.decode_stage_2_outputs(x)
        torch.cuda.synchronize()
        decode_ms = (time.perf_counter() - t0) * 1e3
        ddim_sample_loop(unet, sched, x, 2)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ddim_sample_loop(unet, sched, x, n)
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) * 1e3 / n
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            ddim_sample_loop(unet, sched, x, n)
            torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    by_name = sorted(((_device_us(e) / 1e3 / n, e.key) for e in kernels), reverse=True)
    device_ms = sum(ms for ms, _ in by_name)
    out = dict(build_ms=build_ms, decode_ms=decode_ms, step_ms=step_ms, **psd_setup,
               device_ms_per_step=device_ms,
               busy_share=device_ms / step_ms if step_ms else 0.0,
               top=[dict(ms_per_step=ms, kernel=name[:120]) for ms, name in by_name[:12]])
    say("profile", build_ms=f"{build_ms:.1f}", decode_ms=f"{decode_ms:.3f}",
        scipy_import_ms=f"{psd_setup['scipy_import_ms']:.1f}",
        dpss_ms=f"{psd_setup['dpss_ms']:.1f}",
        step_ms=f"{step_ms:.3f}", device_ms_per_step=f"{device_ms:.3f}",
        busy_share=f"{out['busy_share']:.3f}", kernels=len(kernels))
    for row in out["top"][:8]:
        say("profile-top", ms_per_step=f"{row['ms_per_step']:.3f}", kernel=row["kernel"][:80])
    return out


def main() -> int:
    smi = phase_device()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    build_logs = phase_build()
    with tempfile.TemporaryDirectory() as td:
        tmp = Path(td)
        _, checks = phase_checks(tmp)
        phase_tiny(tmp)
        full = phase_full(tmp)
        cold = phase_cold(tmp)
    rows, per_shape = phase_timings(full, checks)
    prof = phase_profile()
    report = dict(card=smi, windows_per_s=full["windows_per_s"],
                  full_seconds=full["seconds"], full_median_seconds=full["median_seconds"],
                  cold=cold, batch=BATCH, steps=STEPS,
                  kernels=rows, per_shape=per_shape, profile=prof, build_logs=build_logs,
                  checks={kid: [dict(shape=list(k), **v) for k, v in res.items()]
                          for kid, res in checks.items()})
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke_report.json").write_text(json.dumps(report, indent=1))
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--cold-batch"]:
        cold_batch(sys.argv[2])
        sys.exit(0)
    sys.exit(main())
