"""CLI: a warm sampling service (``sleepgen_torch.serve.SamplerService``).

Loads the models once onto the card, warms the sampler, prints a
``ready (...)`` line and answers requests from stdin, one JSON object per
line: ``{"seeds": [0, 1, ...]}`` or ``{"start": 0, "stop": 128}``, plus
optional ``"stage"`` and ``"guidance_scale"`` fields for class-conditional
checkpoints. Each request writes ``signals_{i}.npy`` (and ``psds_{i}.npy``
with ``--psd``) under ``--output_dir`` and prints one JSON line with its
stats; a malformed or invalid request prints ``{"request": i, "error":
...}`` and the loop goes on. ``--oneshot`` serves one request from
``--start``/``--stop`` and exits. ``--pipeline`` holds one request in
flight: request k + 1 is queued on the card before request k's artifacts
are written.

Reads port run dirs, as ``sample`` does: the AEKL's (``config.yaml``,
``params.npz``) and the LDM's (the same plus ``scale_factor.txt``).
"""
from __future__ import annotations

import argparse


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--best_model_path", type=str, required=True, help="AEKL run dir")
    p.add_argument("--diffusion_path", type=str, required=True, help="LDM run dir")
    p.add_argument("--output_dir", type=str, required=True)
    p.add_argument("--batch_size", type=int, default=64)
    p.add_argument("--oneshot", action="store_true",
                   help="serve one request from --start/--stop and exit")
    p.add_argument("--start", type=int, default=0)
    p.add_argument("--stop", type=int, default=128)
    p.add_argument("--psd", action="store_true")
    p.add_argument("--stage", type=int, default=None,
                   help="default sleep-stage label for class-conditional "
                        "checkpoints (the denoiser's num_classes > 0); required "
                        "for them unless every request carries a 'stage' "
                        "field. Omit for unconditional checkpoints.")
    p.add_argument("--guidance_scale", type=float, default=1.0,
                   help="default classifier-free guidance scale; requests "
                        "may override it with a 'guidance_scale' field (one "
                        "sampler serves every scale)")
    p.add_argument("--pipeline", action="store_true",
                   help="hold one request in flight: queue request k+1 on "
                        "the card before writing request k's artifacts, so "
                        "the card does not idle between queued requests. "
                        "Request k's response then comes when request k+1 "
                        "arrives (or at EOF): for bulk feeds, not for strict "
                        "request/response clients")
    p.add_argument("--device", type=str, default="cuda",
                   help="'cuda' (default) or 'cpu' for the plain PyTorch versions")
    return p


def main(argv=None):
    import json
    import sys
    from pathlib import Path

    import numpy as np

    from sleepgen_torch.serve import SamplerService

    args = build_parser().parse_args(argv)

    from sleepgen_torch.utils.profiling import maybe_initialize_multihost


    maybe_initialize_multihost(args.device)
    out = Path(args.output_dir)
    out.mkdir(parents=True, exist_ok=True)

    svc = SamplerService.from_run_dirs(args.best_model_path, args.diffusion_path,
                                       batch_size=args.batch_size, device=args.device)
    if svc.conditional and args.stage is None:
        print(f"conditional checkpoint (num_classes={svc.cfg.num_classes}): "
              f"requests must carry a 'stage' field (no --stage default given)", flush=True)
    warmup_s = svc.warmup()
    print(f"ready (warm-up {warmup_s:.1f}s, batch {args.batch_size})", flush=True)

    def dispatch(seeds, req_id, stage=None, guidance_scale=None):
        """Queue a request; returns (req_id, pending), or None after
        reporting an invalid one."""
        stage = args.stage if stage is None else stage
        gs = args.guidance_scale if guidance_scale is None else guidance_scale
        try:
            return req_id, svc.sample_async(seeds, stage=stage, guidance_scale=gs)
        except (ValueError, TypeError) as e:
            print(json.dumps({"request": req_id, "error": str(e)}), flush=True)
            return None

    def finalize(req_id, pending):
        sigs = pending.result()
        if args.psd:
            from sleepgen_torch.eval.psd import multitaper_psd_db

            psds, _ = multitaper_psd_db(sigs[..., 0], fmax=18.0)
            np.save(out / f"psds_{req_id}.npy", psds)
        np.save(out / f"signals_{req_id}.npy", sigs)
        print(json.dumps({"request": req_id, "n": len(sigs), **svc.stats}), flush=True)

    if args.oneshot:
        job = dispatch(range(args.start, args.stop), 0)
        if job is not None:
            finalize(*job)
        return

    # Strict mode finalizes each request before reading the next line;
    # --pipeline finalizes request k after queuing request k + 1.
    held = None
    for i, line in enumerate(sys.stdin):
        line = line.strip()
        if not line:
            continue
        # a malformed request must not end the loop: the warm models are the
        # point of the service
        try:
            req = json.loads(line)
            if not isinstance(req, dict):
                raise ValueError(f"request must be a JSON object, got {type(req).__name__}")
            seeds = list(req["seeds"] if "seeds" in req
                         else range(req.get("start", 0), req.get("stop", 128)))
        except (ValueError, TypeError, KeyError) as e:
            print(json.dumps({"request": i, "error": str(e)}), flush=True)
            continue
        job = dispatch(seeds, i, stage=req.get("stage"),
                       guidance_scale=req.get("guidance_scale"))
        if job is None:
            continue
        if not args.pipeline:
            finalize(*job)
        else:
            if held is not None:
                finalize(*held)
            held = job
    if held is not None:
        finalize(*held)


if __name__ == "__main__":
    main()
