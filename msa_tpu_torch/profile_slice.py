"""Where the time of one serving forward goes, on the card.

    python3 -m msa_tpu_torch.profile_slice [--tokens 512] [--batch 2] [--steps 3] [--quantize int8|none]

Builds the full-width models (``PipelineModels.initialize``, by default in
the int8 serving recipe; ``--quantize none`` for the bf16 one), warms
``SegmentPipeline.run_host`` up, then records ``--steps`` forwards with
``torch.profiler`` (CPU + CUDA activities) and prints: the wall time per
forward (host clock around work that ends in ``synchronize``), the device's
busy time per forward (sum of kernel durations, from the trace) and its idle
share, and the kernels ranked by device time. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np
import torch


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tokens", type=int, default=512)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--top", type=int, default=20)
    ap.add_argument("--quantize", choices=("int8", "none"), default="int8")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_slice: needs a CUDA device", file=sys.stderr)
        return 2
    from torch.profiler import ProfilerActivity, profile

    from msa_tpu_torch.pipeline import graph as G

    print(
        subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True,
        ).stdout.strip(),
        flush=True,
    )
    models = G.PipelineModels.initialize(seed=0, quantize=args.quantize, device="cuda")
    pipe = G.SegmentPipeline(models)
    rng = np.random.default_rng(0)
    b, tokens = args.batch, args.tokens
    inp = G.SegmentInputs.zeros(models, b, samples=80_000, tokens=tokens)
    inp.frames = rng.integers(0, 256, size=inp.frames.shape, dtype=np.uint8)
    inp.audio = (0.1 * rng.standard_normal((b, 80_000))).astype(np.float32)
    inp.token_ids = rng.integers(1, models.text.cfg.vocab_size, size=(b, tokens)).astype(np.int32)
    inp.token_mask[:] = 1
    for _ in range(2):
        pipe.run_host(inp)
    torch.cuda.synchronize()

    walls = []
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(args.steps):
            t0 = time.perf_counter()
            pipe.run_host(inp)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
    rows = []
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue  # CPU ops: their kernels are listed as device events
        dev_us = getattr(e, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(e, "self_cuda_time_total", 0.0)
        if dev_us > 0:
            rows.append((dev_us / args.steps, e.count // args.steps, e.key))
    rows.sort(reverse=True)
    busy_ms = sum(r[0] for r in rows) / 1e3
    wall_ms = 1e3 * float(np.median(walls))
    print(f"quantize={args.quantize} B={b} tokens={tokens}: wall {wall_ms:.3f} ms/forward (median of {args.steps}), "
          f"device busy {busy_ms:.3f} ms/forward, idle share {1 - busy_ms / wall_ms:.3f}", flush=True)
    for us, n, key in rows[: args.top]:
        print(f"  {us / 1e3:9.4f} ms  {n:5d}x  {100 * us / 1e3 / busy_ms:5.1f}%  {key[:90]}", flush=True)
    print(json.dumps({"quantize": args.quantize, "batch": b, "tokens": tokens, "wall_ms": wall_ms, "device_busy_ms": busy_ms,
                      "device": torch.cuda.get_device_name(0)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
