"""Where the time of one serving forward, or one training step, goes on the card.

    python3 -m msa_tpu_torch.profile_slice [--tokens 512] [--batch 2] [--steps 3] [--quantize int8|none|f32|int8_f32]
                                           [--samples 80000]
                                           [--train | --stream | --conv | --extractor | --asr | --gemm-s8 | --gemm-bf16 | --gemm-f32
                                            | --f32-rows | --attn-bwd-f32 | --attn-wide | --attn-wide-tiles
                                            | --attn-wide-f32 | --attn-wide-f32-plans | --int8-chains]

Builds the full-width models (``PipelineModels.initialize``, by default in
the int8 serving recipe; ``--quantize none`` for the bf16 one, ``f32``
for the encoders of JAX's f32 parity mode, f32 through the kernels' f32
variants, on the init's weights; ``int8_f32`` for W8A8 under f32 compute,
``compute_dtype="float32"`` with ``quantize="int8"``), runs the
segment graph at ``--samples`` audio samples per segment (the
``segment_samples`` of its config; 240000, 15 s, puts the audio encoder on
the flash kernel), warms
``SegmentPipeline.run_host`` up, then records ``--steps`` forwards with
``torch.profiler`` (CPU + CUDA activities) and prints: the wall time per
forward (host clock around work that ends in ``synchronize``), the device's
busy time per forward (the union of the device activities' intervals in
the trace, so that a kernel that starts under programmatic dependent
launch while its predecessor runs, and whose duration holds its wait,
counts once; the plain sum of durations is printed beside it) and its
idle share, the kernels ranked by device time, and the int8 chains of rows
7 and 9 in the forward (each chain's span, from its first kernel's start
to its last one's end, summed). ``--train`` profiles instead
one training step of the text model (``msa_tpu_torch.training``: bf16,
kernel attention, dropout 0; forward, backward and AdamW) at ``--batch``
(default 8) × ``--tokens``, or with ``--samples`` that of the audio model
at ``--samples`` per clip; ``--train --quantize f32`` the same step in f32
(the parity mode's encoders fine-tuned: rows 5/6 forward and rows 3 and 4
backward in f32, TF32 off). ``--stream`` profiles instead one streaming
window, ``StreamingProcessor.process_segment`` (one 480×640 frame, 5 s of
synthetic PCM16, no text: bucket 32; the default neural diarizer), and
prints the processor's ``StageTimer`` over the profiled windows beside the
trace. ``--conv`` times instead the counterpart of
``tools/conv_bench.py``: ``conv_stride2_fused`` (row 11) at the wav2vec2
extractor's six stride-2 layers, 512 → 512 channels, bf16, at ``--batch``
(default 64), beside its plain version and cuDNN's bf16 ``F.conv1d`` (on
the channels-first input, transposed once outside the timing; without the
GELU), each the median of ``--steps`` CUDA-event timings, and the device
time of the row's kernel (with and without its GELU) and of cuDNN's from
the profiler's trace; two calls compared bit for bit. It times another
tree of the package too (``PYTHONPATH=<tree> python3 -P
msa_tpu_torch/profile_slice.py --conv``). ``--extractor`` times the
full-width audio extractor at 5 s (B=2 and 64, bf16 and f32) with
``extractor_impl="matmul"`` (row 11 in its stride-2 layers) and with
``"conv"`` (cuDNN), kernel by kernel, and its layout change from [B, C, L]
to the GEMM layers' [B, L, C] alone. ``--asr``
profiles instead one ``transcribe_batch`` of the shipped whisper ASR on
``--batch`` (default 8) windows of ``tests/data/asr_clips.npz``.
``--gemm-s8`` times instead the int8 GEMM of rows 7 and 9 alone
(``ops/kernels/gemm_s8.py``) at an encoder layer's four GEMMs (QKV, Wo,
fc_in, fc_out at d_model 768, d_ff 3072) and M = 4096, 1024, 500, 256,
128, 64: the device ms of the planner's plan, of each tile at one split, at the
fewest splits that fill the SMs, at twice that and at as many of them as
leave each split 4 k-tiles, and of
``torch._int_mm`` (cuBLASLt) on the same codes, each from the profiler's
trace of ``--steps`` (at least 20) calls. ``--gemm-bf16`` does the same
for the bf16 GEMM of rows 8 and 10 (``ops/kernels/gemm_bf16.py``; bias
f32, no GELU) at the same shapes: every tile the kernel is built for at
splits 1, 2, 3, 4, 6, 8, 12 and 16 where each split keeps 2 k-tiles or
more, beside ``torch.matmul`` on the same bf16 operands, each plan's max
abs error against the f32 product of those operands printed beside its
time; then fc_in with its own epilogue (bf16 bias, GELU) on the planner's
plan beside the same plan without it. ``--gemm-f32`` times the f32 GEMM
of rows 10, 8 and 11 in f32 (``ops/kernels/gemm_f32.py``; bias f32, no
GELU) at the f32 parity forward's eight encoder GEMMs (text at M = 1024,
audio at M = 512 for QKV and Wo and 500 for the FFN), the 15 s audio FFN
(M = 1498) and row 11's f32 conv (B=8 L=1999 k=3, w [K, N]): every tile
the kernel is built for at a grid of one CTA a tile and of 132, 264, 396
and 528 CTAs (stream-K), each plan's device ms and its largest error
against the plain product (relative to the largest output), beside
``torch.matmul`` and ``torch.addmm`` with TF32 off (device ms from the
profiler, call ms from CUDA events, as for the planner's plan); then
fc_in with its GELU on the planner's plan beside the same plan without it,
and the registers and spills ``-Xptxas -v`` reports for each instance
of ``gemm_f32_kernel``. ``--f32-rows`` times rows 10, 8 and 11 in f32
through their public wrappers only (``ffn_fused`` at N = 1024 and 500,
``attention_block`` at B=2 T=512 and 250, ``conv_stride2_fused`` at B=8
L=1999 k=3 with the GELU and L=999 k=2 without), device ms and call ms, so
that the same file times another tree of the package (``PYTHONPATH=<tree>
python3 msa_tpu_torch/profile_slice.py --f32-rows``). ``--attn-bwd-f32`` times instead
the one-pass f32 attention backward (rows 3 and 4 on f32 at D ≤ 64,
``attention_bwd_onepass``) at the f32 training steps' shapes (B=8 T=512
and T=250, B=2 T=749, H=12 D=64) and the custom widths' (B=2 T=40 H=4
D=24), on the planner's plan and on every key tile at splits 1, 2, 3, 4,
6, 8 and 12 of the query loop, beside the D-tiled pair it replaced there
and autograd's backward of one f32 ``scaled_dot_product_attention`` (TF32
off), each from the profiler's trace of ``--steps`` (at least 20) calls,
with each plan's largest error against the plain version (relative to the
largest |value|); then it profiles the f32 training step (``--train
--quantize f32``) of the text model (B=8, 512 tokens) and of the audio
model at 5 s (B=8) and 15 s (B=2). ``--attn-wide`` times the bf16
attention rows above head dim 128 through their public wrappers only, so
that it times another tree too (``PYTHONPATH=<tree> python3 -P
msa_tpu_torch/profile_slice.py --attn-wide``): rows 1, 2, 5 and row 8's
core at B=2 T=512 H=4 D=192 and H=3 D=256, row 6 at B=2 T=749 H=4 D=192,
rows 3 + 4 at B=8 T=512 H=4 D=192 and H=3 D=256 (dq and dk/dv apart), and
the tiny shapes of the smoke's phase 22 (B=2 H=2 T=100, T=600 for row 6, D
= 160, 192, 256): device ms of the attention kernels alone (the profiler's
trace of ``--steps``, at least 20, calls) and call ms, with each call's
largest error against its plain version. ``--attn-wide-tiles`` times the
tensor-core forward above D = 128 (``msa_attention_wide_mma``) in each
rounding order at each column tile (128, 192) and at the rule's, at
the same shapes and at B=8 T=512 H=4 D=192, beside one
``scaled_dot_product_attention`` call, then the backward's dQ kernel
(``msa_attention_bwd_wide``) at each column tile (128, and 192 at D ≤
192) and at the rule's, and its dK/dV kernel, at the backward's shapes
beside SDPA's autograd backward, and prints the registers and spills of
the new kernels' instances. ``--attn-wide-f32`` times the f32 attention
rows above head dim 64 / 128 through their public wrappers only, so that
it times another tree too (``PYTHONPATH=<tree> python3 -P
msa_tpu_torch/profile_slice.py --attn-wide-f32``): rows 1, 2, 5, row 8's
core and row 7 on f32 x at B=2 T=512 H=4 D=192 and H=3 D=256, row 5 at B=8
T=512 H=4 D=192, row 6 at B=2 T=749 H=4 D=192, rows 3 + 4 (dq, dk and dv
together) at B=8 T=512 H=4 D=192, H=3 D=256 and H=6 D=128, and phase 22's
small shapes (B=2 H=2 T=100, T=600 for row 6, D = 160, 192, 256, 640,
768, 1024; rows 8 and 7 at B=2 T=100 H=4 D = 160, 192, 256, their core
alone by device ms, the whole block by call ms), with row 5 at B=2 T=512
H=12 D=64 and rows 3 + 4 at B=8
(D = 64, the f32 kernels the wide ones leave alone) as the control: the
attention kernels' device ms (the f32 forward's and
backward's kernels of either tree, by name), the call's CUDA-event ms, the
largest error against the plain version, one f32
``scaled_dot_product_attention`` call (or its autograd backward; TF32 off)
with the backend it picked, and the exact-f32 bound (max(bytes / 3.35
TB/s, FLOP at 67 TFLOP/s)). ``--attn-wide-f32-plans`` times every plan
of the two f32 kernels at those shapes: the forward
(``msa_fused_attention`` on f32, each query tile at each split of the key
loop) and the one-pass backward above D = 64 (``attention_bwd_onepass``,
each split of the query loop), the planner's plan marked: where the
planners' constants come from. ``--int8-chains`` reads the int8 chains of
rows 7 and 9 (``attention_block_int8``: quantize, QKV GEMM, core,
quantize, Wo GEMM; ``ffn_fused_int8``: quantize, fc_in, the hidden tile's
quantization, fc_out) through their public wrappers only, so that it reads
another tree too (``PYTHONPATH=<tree> python3 -P
msa_tpu_torch/profile_slice.py --int8-chains``), on bf16 x and f32 x at
B=2 T=512, B=2 T=250 (pad 256), B=1 T=128 (the stream) and B=64 T=512
(d_model 768, 12 heads), and row 7 at B=2 T=512 with 4 heads (head dim
192): each call enqueued behind a spin kernel (``torch.cuda._sleep``) so
that all its launches are queued before its first kernel runs, then the
chain's span on the card, the union of its kernels' busy intervals and its
kernels' count, medians over the profiler's trace of ``--steps`` (at
least 20) calls; beside them each kernel timed alone on a direct call, launched in
plain stream order (``gemm_s8`` at the chains' GEMMs, the cores inside
row 8's ``attention_block``, the row quantization from x at 768 and 3072
columns and from the hidden tile's amax). It starts with the row quantization (bf16 [128 |
1024, 768], f32 [1024, 3072], the amax form at [1024, 3072]; normal
values, and with the smoke's zero rows) in three states of the card, each
beside the SM clock read from spin kernels of known cycles: on direct
calls launched one by one (as ``chip_smoke.py`` times it) after 1 s idle
and right after 100 ms of spin, and queued back to back behind a spin.
Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from msa_tpu_torch.core.config import PipelineConfig, SystemConfig


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tokens", type=int, default=512)
    ap.add_argument("--batch", type=int, default=None, help="2 for a forward, 8 for --train")
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--top", type=int, default=20)
    ap.add_argument("--quantize", choices=("int8", "none", "f32", "int8_f32"), default="int8")
    ap.add_argument("--samples", type=int, default=None, help="audio samples a segment (with --train: the audio step's clip)")
    ap.add_argument("--train", action="store_true", help="one text (with --samples: audio) training step instead of a forward")
    ap.add_argument("--stream", action="store_true", help="one StreamingProcessor.process_segment window instead of a forward")
    ap.add_argument("--conv", action="store_true", help="row 11 at the wav2vec2 stride-2 layers instead of a forward")
    ap.add_argument("--asr", action="store_true", help="one batch of the shipped whisper ASR instead of a forward")
    ap.add_argument("--extractor", action="store_true",
                    help="the audio extractor, extractor_impl='matmul' (row 11) against 'conv' (cuDNN), kernel by kernel")
    ap.add_argument("--gemm-s8", action="store_true", help="the int8 GEMM of rows 7 and 9 alone, each plan, beside torch._int_mm")
    ap.add_argument("--gemm-bf16", action="store_true", help="the bf16 GEMM of rows 8 and 10 alone, each plan, beside torch.matmul")
    ap.add_argument("--gemm-f32", action="store_true", help="the f32 GEMM of rows 10, 8 and 11 alone, each plan, beside torch.addmm")
    ap.add_argument("--f32-rows", action="store_true", help="rows 10, 8 and 11 in f32 through their public wrappers")
    ap.add_argument("--attn-bwd-f32", action="store_true",
                    help="the one-pass f32 attention backward, each plan, beside the pair and f32 SDPA; then the f32 steps")
    ap.add_argument("--attn-wide", action="store_true", help="the bf16 attention rows above D = 128 through their wrappers")
    ap.add_argument("--attn-wide-f32", action="store_true",
                    help="the f32 attention rows above D = 64 / 128 through their wrappers, beside f32 SDPA")
    ap.add_argument("--attn-wide-f32-plans", action="store_true",
                    help="every plan of the f32 forward above D = 128 and the one-pass backward above D = 64")
    ap.add_argument("--int8-chains", action="store_true",
                    help="rows 7 and 9's int8 chains (span, union busy) and their kernels alone, on any tree")
    ap.add_argument("--attn-wide-tiles", action="store_true",
                    help="the bf16 forward above D = 128 at each column tile and order, beside SDPA")
    args = ap.parse_args(argv)
    b = args.batch or (64 if args.conv else 8 if args.train or args.asr else 1 if args.stream else 2)
    if not torch.cuda.is_available():
        print("profile_slice: needs a CUDA device", file=sys.stderr)
        return 2
    if args.conv:
        return conv_layers(b, max(args.steps, 5))
    if args.extractor:
        return extractor_paths(max(args.steps, 5))
    if args.gemm_s8:
        return gemm_s8_plans(max(args.steps, 20))
    if args.gemm_bf16:
        return gemm_bf16_plans(max(args.steps, 20))
    if args.gemm_f32:
        return gemm_f32_plans(max(args.steps, 20))
    if args.f32_rows:
        return f32_rows(max(args.steps, 20))
    if args.attn_wide:
        return attention_wide_rows(max(args.steps, 20))
    if args.attn_wide_tiles:
        return attention_wide_tiles(max(args.steps, 20))
    if args.attn_wide_f32:
        return attention_wide_f32_rows(max(args.steps, 20))
    if args.attn_wide_f32_plans:
        return attention_wide_f32_plans(max(args.steps, 20))
    if args.int8_chains:
        return int8_chains(max(args.steps, 20))
    if args.attn_bwd_f32:
        rc = attention_bwd_f32_plans(max(args.steps, 20))
        for step in ([], ["--samples", "80000"], ["--samples", "240000", "--batch", "2"]):
            rc = rc or main(["--train", "--quantize", "f32", *step])
        return rc
    from torch.profiler import ProfilerActivity, profile

    from msa_tpu_torch.pipeline import graph as G

    print(
        subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True,
        ).stdout.strip(),
        flush=True,
    )
    rng = np.random.default_rng(0)
    tokens, samples = args.tokens, args.samples or SystemConfig().pipeline.segment_samples
    if args.asr:
        from msa_tpu_torch.host.transcription import make_transcriber

        tr = make_transcriber("auto", scale="full", device="cuda")
        waves = np.load(ASR_CLIPS)["waves"][:b]
        clips = list(waves.astype(np.float32) / 32768.0)

        def run():
            tr.transcribe_batch(clips, 16_000)

    elif args.train:
        from msa_tpu_torch import training

        f32 = args.quantize == "f32"
        models = G.PipelineModels.initialize(seed=0, quantize="none" if f32 else args.quantize, device="cuda")
        models = models.with_encoders(dropout=0.0, **({"compute_dtype": "float32"} if f32 else {}))
        if args.samples:  # the audio model's step
            model, loss = models.audio.requires_grad_(True), training.audio_loss
            batch = (
                torch.from_numpy((0.1 * rng.standard_normal((b, samples))).astype(np.float32)).cuda(),
                torch.from_numpy(rng.integers(0, 4, size=b)).cuda(),
            )
        else:
            model, loss = models.text.requires_grad_(True), training.text_loss
            batch = (
                torch.from_numpy(rng.integers(1, model.cfg.vocab_size, size=(b, tokens))).cuda(),
                torch.ones(b, tokens, dtype=torch.int32, device="cuda"),
                {h: torch.from_numpy(rng.integers(0, n, size=b)).cuda() for h, n in zip(training.TEXT_HEADS, (7, 2, 2, 3))},
            )
        opt = training.adamw(model.parameters())

        def run():
            training.train_step(model, loss, opt, *batch)

    elif args.stream:
        from msa_tpu_torch.processors.streaming import StreamingProcessor, SyntheticAudioSource, SyntheticFrameSource

        models = G.PipelineModels.initialize(seed=0, quantize=args.quantize, device="cuda")
        cfg = SystemConfig(pipeline=PipelineConfig(segment_samples=samples, precompile=False))
        proc = StreamingProcessor(cfg, models=models, device="cuda")
        tokens = 32  # no transcript: the shortest bucket
        frames = [SyntheticFrameSource(1, 480, 640).read()]
        pcm = SyntheticAudioSource(chunk_seconds=samples / 16_000).drain()

        def run():
            out = proc.process_segment(frames, pcm, "")
            if out["fused_emotion"] is None or not proc._use_packed:
                raise RuntimeError("the streaming window failed")

    else:
        if args.quantize in ("f32", "int8_f32"):  # f32 compute: the parity mode's encoders, or W8A8 under f32
            quantize = "none" if args.quantize == "f32" else "int8"
            models = G.PipelineModels.initialize(seed=0, quantize=quantize, device="cuda").with_encoders(compute_dtype="float32")
        else:
            models = G.PipelineModels.initialize(seed=0, quantize=args.quantize, device="cuda")
        pipe = G.SegmentPipeline(models, SystemConfig(pipeline=PipelineConfig(segment_samples=samples)))
        inp = G.SegmentInputs.zeros(models, b, samples=samples, tokens=tokens)
        inp.frames = rng.integers(0, 256, size=inp.frames.shape, dtype=np.uint8)
        inp.audio = (0.1 * rng.standard_normal((b, samples))).astype(np.float32)
        inp.token_ids = rng.integers(1, models.text.cfg.vocab_size, size=(b, tokens)).astype(np.int32)
        inp.token_mask[:] = 1

        def run():
            pipe.run_host(inp)

    for _ in range(2):
        run()
    torch.cuda.synchronize()
    if args.stream:
        proc.timer.reset()

    walls = []
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(args.steps):
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
    rows = []
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA or getattr(e, "is_user_annotation", False):
            continue  # CPU ops and annotated ranges (the optimizer's step): their kernels are listed on their own
        dev_us = getattr(e, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(e, "self_cuda_time_total", 0.0)
        if dev_us > 0:
            rows.append((dev_us / args.steps, e.count // args.steps, e.key))
    rows.sort(reverse=True)
    sum_ms = sum(r[0] for r in rows) / 1e3
    intervals = _device_intervals(prof)
    busy_ms = _union_us(intervals) / 1e3 / args.steps
    chains = _chains(intervals)
    spans = {kind: sum(c["span_us"] for c in cs) / 1e3 / args.steps for kind, cs in chains.items()}
    wall_ms = 1e3 * float(np.median(walls))
    what = (
        "whisper batch" if args.asr
        else f"quantize={args.quantize} samples={samples} streaming window (process_segment)" if args.stream
        else f"quantize={args.quantize} {'audio' if args.samples else 'text'} training step" if args.train
        else f"quantize={args.quantize} samples={samples} forward"
    )
    print(f"{what} B={b} tokens={tokens}: wall {wall_ms:.3f} ms (median of {args.steps}), "
          f"device busy {busy_ms:.3f} ms (union of intervals; sum of durations {sum_ms:.3f}), "
          f"idle share {1 - busy_ms / wall_ms:.3f}", flush=True)
    for kind, cs in chains.items():
        print(f"  int8 chains of {kind}: {len(cs) // args.steps} a forward, spans summed {spans[kind]:.4f} ms", flush=True)
    if args.stream:
        print("  StageTimer under the profiler: " + ", ".join(
            f"{k} {v['mean_ms']:.3f} ms" for k, v in proc.timer.summary().items()), flush=True)
    for us, n, key in rows[: args.top]:
        print(f"  {us / 1e3:9.4f} ms  {n:5d}x  {100 * us / 1e3 / sum_ms:5.1f}%  {key[:90]}", flush=True)
    print(json.dumps({"train": args.train, "stream": args.stream, "asr": args.asr, "quantize": args.quantize, "batch": b, "tokens": tokens, "samples": samples, "wall_ms": wall_ms,
                      "device_busy_ms": busy_ms, "device_sum_ms": sum_ms,
                      "chains": {kind: {"per_forward": len(cs) // args.steps, "span_ms": spans[kind]} for kind, cs in chains.items()},
                      "device": torch.cuda.get_device_name(0)}), flush=True)
    if args.stream:
        stream_dispatch(proc, frames, pcm, max(args.steps, 10))
    return 0


def stream_dispatch(proc, frames, pcm, reps: int) -> None:
    """Without the profiler, in turns: the window's ``dispatch`` stage
    (``run_stream`` inside ``process_segment``), a bare ``run_stream`` on the
    same packed buffer, and a bare one after the frame's resize (the host
    work that comes before it in a window): the host's time to issue each,
    median of ``reps``; the card is idle when each starts."""
    from msa_tpu_torch.host.video import preprocess_frame
    from msa_tpu_torch.pipeline.graph import pack_stream_inputs

    size = proc.models.landmark.cfg.frame_size
    frame_u8 = preprocess_frame(frames[0], size)
    pcm16 = np.frombuffer(pcm, np.int16)
    packed = pack_stream_inputs(frame_u8, pcm16, np.zeros(32, np.int32), np.zeros(32, np.int32), True, True, False, 0.0, 0.0)
    pipe = proc._pipeline
    readings = {"window dispatch": [], "bare run_stream": [], "run_stream after the resize": []}

    def bare(resize: bool) -> float:
        if resize:
            preprocess_frame(frames[0], size)
        t0 = time.perf_counter()
        pipe.run_stream(packed, proc._prev_landmarks, proc._has_prev)
        issued = time.perf_counter()
        torch.cuda.synchronize()
        return 1e3 * (issued - t0)

    for _ in range(reps):
        proc.timer.reset()
        proc.process_segment(frames, pcm, "")
        readings["window dispatch"].append(1e3 * proc.timer.totals["dispatch"])
        readings["bare run_stream"].append(bare(False))
        readings["run_stream after the resize"].append(bare(True))
    print("  without the profiler, ms (median of %d, host clock): " % reps + ", ".join(
        f"{k} {np.median(v):.3f} (min {min(v):.3f})" for k, v in readings.items()), flush=True)


def _device_intervals(prof):
    """(start µs, end µs, name) of every device activity the trace recorded
    (kernels, copies, sets; annotated ranges left out), by start."""
    out = [(e.time_range.start, e.time_range.end, e.name) for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA and not getattr(e, "is_user_annotation", False)]
    return sorted(out)


def _union_us(intervals) -> float:
    """The time covered by the intervals: busy time that counts a stretch
    once, however many kernels ran in it (under programmatic dependent
    launch a waiting kernel's duration holds its wait)."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e, _ in intervals:
        if cur_e is None or s > cur_e:
            total += 0.0 if cur_e is None else cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    return total + (0.0 if cur_e is None else cur_e - cur_s)


# the kernels of the int8 chains, by name: the row quantization (Q), the
# hidden tile's from its amax (A), the int8 GEMM (G), the cores of row 7 (C)
_CHAIN_KERNELS = (("quantize_rows_amax_kernel", "A"), ("quantize_rows_kernel", "Q"), ("gemm_s8_kernel", "G"),
                  ("packed_qkv_kernel", "C"), ("fused_f32_kernel", "C"), ("wide_mma_kernel", "C"),
                  ("wide_f32_kernel", "C"))
_CHAINS = {"row 7": "QGCQG", "row 9": "QGAG"}


def _chains(intervals):
    """The int8 chains among the intervals (one stream, by start): for each
    of rows 7 and 9 a list of {span_us, busy_us, kernels, durations_us},
    the span from the first kernel's start to the last one's end."""
    marked = [(s, e, next((c for k, c in _CHAIN_KERNELS if k in name), "")) for s, e, name in intervals]
    marked = [m for m in marked if m[2]]
    code = "".join(m[2] for m in marked)
    found = {kind: [] for kind in _CHAINS}
    i = 0
    while i < len(code):
        kind = next((k for k, pat in _CHAINS.items() if code.startswith(pat, i)), None)
        if kind is None:
            i += 1
            continue
        ks = marked[i : i + len(_CHAINS[kind])]
        found[kind].append({"span_us": max(e for _, e, _ in ks) - ks[0][0], "busy_us": _union_us(ks),
                            "kernels": len(ks), "durations_us": [e - s for s, e, _ in ks]})
        i += len(ks)
    return found


# 8 windows of 5 s of synthetic speech, int16 (tests/test_torch_whisper.py)
ASR_CLIPS = Path(__file__).resolve().parents[1] / "tests" / "data" / "asr_clips.npz"

# wav2vec2-base's stride-2 layers after the k=10/s=5 stem, on 5 s of audio:
# (L_in, k), all 512 → 512 channels (tools/conv_bench.py:42-44)
CONV_LAYERS = ((15999, 3), (7999, 3), (3999, 3), (1999, 3), (999, 2), (499, 2))


def _event_ms(fn, reps: int) -> float:
    fn()
    times = []
    for _ in range(reps):
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
    return float(np.median(times))


def conv_layers(b: int, reps: int) -> int:
    """Row 11 against its plain version and cuDNN at the six layers."""
    import torch.nn.functional as F

    from msa_tpu_torch.ops.kernels.conv import conv_stride2_fused, conv_stride2_reference

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    g = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    for length, k in CONV_LAYERS:
        x = torch.randn(b, length, 512, generator=g, device="cuda").to(torch.bfloat16)
        w = 0.04 * torch.randn(k, 512, 512, generator=g, device="cuda")
        got, want = conv_stride2_fused(x, w), conv_stride2_reference(x, w)
        rel = ((got.float() - want.float()).abs().max() / want.float().abs().max()).item()
        x_ncw, w_oik = x.transpose(1, 2).contiguous(), w.permute(2, 1, 0).to(torch.bfloat16).contiguous()
        out_len = (length - k) // 2 + 1
        flop = 2 * b * out_len * k * 512 * 512
        row = {
            "L": length, "k": k, "batch": b, "rel_err": rel,
            "bit_equal": bool(torch.equal(got, conv_stride2_fused(x, w))),
            "kernel_ms": _event_ms(lambda: conv_stride2_fused(x, w), reps),
            "device_ms": _device_ms(lambda: conv_stride2_fused(x, w), reps, "conv"),
            "device_ms_no_gelu": _device_ms(lambda: conv_stride2_fused(x, w, False), reps, "conv"),
            "plain_ms": _event_ms(lambda: conv_stride2_reference(x, w), reps),
            "cudnn_ms": _event_ms(lambda: F.conv1d(x_ncw, w_oik, stride=2), reps),
            "cudnn_device_ms": _device_ms(lambda: F.conv1d(x_ncw, w_oik, stride=2), reps),
            "bound_ms": 1e3 * max(flop / 989e12, 2 * (b * length * 512 + k * 512 * 512 + b * out_len * 512) / 3.35e12),
        }
        rows.append(row)
        print(f"L={length:6d} k={k}  kernel {row['kernel_ms']:8.4f} ms (call; device {row['device_ms']:8.4f}, "
              f"{flop / row['device_ms'] / 1e9:6.1f} TFLOP/s)  plain {row['plain_ms']:8.3f}  cudnn {row['cudnn_ms']:8.4f} ms "
              f"(call; device {row['cudnn_device_ms']:8.4f}, {flop / row['cudnn_device_ms'] / 1e9:6.1f} TFLOP/s)"
              f"  bound {row['bound_ms']:.4f}  rel_err {rel:.2e}  bit_equal {row['bit_equal']}  without the GELU: "
              f"device {row['device_ms_no_gelu']:.4f}", flush=True)
        del x, w, got, want, x_ncw
    keys = ("kernel_ms", "device_ms", "device_ms_no_gelu", "plain_ms", "cudnn_ms", "cudnn_device_ms", "bound_ms")
    total = {key: sum(r[key] for r in rows) for key in keys}
    print(f"TOTAL stride-2 layers: kernel {total['kernel_ms']:.4f} ms (device {total['device_ms']:.4f})  cudnn "
          f"{total['cudnn_ms']:.4f} ms (device {total['cudnn_device_ms']:.4f})  bound {total['bound_ms']:.4f} ms", flush=True)
    import msa_tpu_torch

    print(json.dumps({"conv": rows, "total": total, "package": str(Path(msa_tpu_torch.__file__).parent),
                      "device": torch.cuda.get_device_name(0)}), flush=True)
    return 0


def extractor_paths(reps: int) -> int:
    """The full-width audio extractor (JAX's flax init, seed 2) at 5 s, B=2
    and B=64, bf16 and f32 (TF32 off): ``extractor_impl="matmul"`` (row 11
    in its six stride-2 layers) against ``"conv"`` (cuDNN), each path's
    device ms per call from the profiler's trace and its kernels ranked,
    and the matmul path's layout change after layer 0 ([B, C, L] → [B, L,
    C]) timed alone."""
    import dataclasses

    from torch.profiler import ProfilerActivity, profile

    from msa_tpu_torch import flax_init
    from msa_tpu_torch.models.audio import AudioModelConfig, ConvFeatureExtractor
    from msa_tpu_torch.models.transformer import EncoderConfig
    from msa_tpu_torch.precision import exact_fp32

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    rng = np.random.default_rng(0)
    for dtype in ("bfloat16", "float32"):
        cfg = AudioModelConfig(encoder=EncoderConfig(compute_dtype=dtype))
        with torch.device("cuda"):
            conv = flax_init.init_module_(ConvFeatureExtractor(cfg).eval().requires_grad_(False), 2)
            mm = ConvFeatureExtractor(dataclasses.replace(cfg, extractor_impl="matmul")).eval().requires_grad_(False)
        mm.load_state_dict(conv.state_dict())
        for b in (2, 64):
            wav = torch.from_numpy((0.1 * rng.standard_normal((b, 80_000))).astype(np.float32)).cuda()
            with torch.inference_mode(), exact_fp32():
                for label, fx in (("conv", conv), ("matmul", mm)):
                    fx(wav)
                    torch.cuda.synchronize()
                    with profile(activities=[ProfilerActivity.CUDA]) as prof:
                        for _ in range(reps):
                            fx(wav)
                        torch.cuda.synchronize()
                    rows = sorted(
                        ((e.key, (getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0.0))
                          / reps / 1e3, e.count / reps)
                         for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA and e.count),
                        key=lambda r: -r[1],
                    )
                    total = sum(r[1] for r in rows)
                    print(f"{dtype} B={b} 5 s extractor {label}: {total:.4f} ms of device time per call; "
                          + "; ".join(f"{k[:70]} {ms:.4f} ({n:g}/call)" for k, ms, n in rows[:8]), flush=True)
                x0 = torch.empty(b, 512, 15999, dtype=conv.cfg.encoder.dtype, device="cuda")
                ms = _device_ms(lambda: x0.transpose(1, 2).contiguous(), reps)
                print(f"{dtype} B={b}: [B, 512, 15999] → [B, 15999, 512] alone {ms:.4f} ms "
                      f"({2 * x0.numel() * x0.element_size() / ms / 1e6:.1f} GB/s)", flush=True)
                del x0
    return 0


def _device_ms(fn, reps: int, only: str = "") -> float:
    """Device ms per call of the kernels (whose name holds ``only``) that
    ``reps`` calls of ``fn`` ran, from the profiler's trace: each kernel's
    mean recorded duration times its launches per call (a trace can lose
    a few kernels; ``only`` may be a tuple of names, any of which counts).
    A trace that recorded none is taken again, up to three times; then it
    is not measured (nan)."""
    names = only if isinstance(only, tuple) else (only,)
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        us = sum(
            (getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0.0)) / e.count
            * max(1, round(e.count / reps))
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA and any(n in e.key for n in names) and e.count
        )
        if us > 0:
            return us / 1e3
    return float("nan")


def gemm_s8_plans(reps: int) -> int:
    """The int8 GEMM alone: each candidate plan beside the planner's and
    torch._int_mm, at a layer's four GEMMs and the main path's row counts."""
    from msa_tpu_torch.ops.kernels import gemm_s8 as GS

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    g = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    for name, n, k in (("QKV", 2304, 768), ("Wo", 768, 768), ("fc_in", 3072, 768), ("fc_out", 768, 3072)):
        w = torch.randint(-127, 128, (n, k), generator=g, device="cuda", dtype=torch.int8)
        for m in (4096, 1024, 500, 256, 128, 64):
            a = torch.randint(-127, 128, (m, k), generator=g, device="cuda", dtype=torch.int8)
            scales = (torch.ones(m, device="cuda"), torch.ones(n, device="cuda"), torch.zeros(n, device="cuda"))
            nk, cands = -(-k // GS.K_TILE), set()
            for t in GS.TILES:
                tiles = -(-m // t) * (n // t)
                fill = 1 if tiles >= GS.SMS else min(nk, -(-GS.SMS // tiles))
                cands |= {GS.Plan(t, t, s) for s in (1, fill, min(nk, 2 * fill), max(1, min(fill, nk // 4)))}
            times = {
                p: _device_ms(lambda p=p: GS.gemm_s8(a, w, *scales, p), reps, "gemm_s8_kernel")
                for p in sorted(cands, key=lambda p: (p.bm, p.bn, p.splits))
            }
            chosen, best = GS.plan(m, n, k), min(times, key=times.get)
            lib = _device_ms(lambda: torch._int_mm(a, w.t()), reps)
            row = {"gemm": name, "M": m, "N": n, "K": k, "plan": dataclasses.astuple(chosen), "plan_ms": times[chosen],
                   "best": dataclasses.astuple(best), "best_ms": times[best], "int_mm_ms": lib,
                   "bound_ms": 1e3 * max(2 * m * n * k / 1979e12, (m * k + n * k + 4 * m * n) / 3.35e12),
                   "all": {f"{p.bm}x{p.bn}/{p.splits}": t for p, t in times.items()}}
            rows.append(row)
            print(f"{name:6s} M={m:4d} N={n} K={k}: plan {chosen.bm}x{chosen.bn}/{chosen.splits} {times[chosen]:.4f} ms, "
                  f"best {best.bm}x{best.bn}/{best.splits} {times[best]:.4f}, torch._int_mm {lib:.4f}, "
                  f"bound {row['bound_ms']:.5f}  | " + " ".join(f"{key} {t:.4f}" for key, t in row["all"].items()), flush=True)
    print(json.dumps({"gemm_s8": rows, "device": torch.cuda.get_device_name(0)}), flush=True)
    return 0


def gemm_bf16_plans(reps: int) -> int:
    """The bf16 GEMM alone: each candidate plan beside the planner's and
    torch.matmul, at a layer's four GEMMs and the main path's row counts."""
    from msa_tpu_torch.ops.kernels import gemm_bf16 as GB
    from msa_tpu_torch.ops.kernels import gemm_plan as GP

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    g = torch.Generator(device="cuda").manual_seed(0)
    bf16, rows = torch.bfloat16, []
    for name, n, k in (("QKV", 2304, 768), ("Wo", 768, 768), ("fc_in", 3072, 768), ("fc_out", 768, 3072)):
        w = (torch.randn(n, k, generator=g, device="cuda") * k**-0.5).to(bf16)
        bias = 0.02 * torch.randn(n, generator=g, device="cuda")
        for m in (4096, 1024, 500, 256, 128, 64):
            a = torch.randn(m, k, generator=g, device="cuda").to(bf16)
            want = a.float() @ w.float().t() + bias
            nk = GP.BF16_RULE.k_tiles(k)
            chosen = GP.plan(m, n, k, bf16)
            cands = [GP.Plan(bm, bn, s) for bm, bn in GP.BF16_RULE.tiles for s in (1, 2, 3, 4, 6, 8, 12, 16)
                     if s == 1 or nk // s >= 2]
            cands += [chosen] if chosen not in cands else []
            times, errs = {}, {}
            for p in cands:
                errs[p] = (GB.gemm_bf16(a, w, bias, p).float() - want).abs().max().item()
                times[p] = _device_ms(lambda p=p: GB.gemm_bf16(a, w, bias, p), reps, "gemm_bf16_kernel")
            best = min(times, key=times.get)
            lib = _device_ms(lambda: torch.matmul(a, w.t()), reps)
            row = {"gemm": name, "M": m, "N": n, "K": k, "plan": dataclasses.astuple(chosen), "plan_ms": times[chosen],
                   "best": dataclasses.astuple(best), "best_ms": times[best], "matmul_ms": lib,
                   "bound_ms": 1e3 * max(2 * m * n * k / 989e12, 2 * (m * k + n * k + m * n) / 3.35e12),
                   "max_abs_err": max(errs.values()),
                   "all": {f"{p.bm}x{p.bn}/{p.splits}": t for p, t in times.items()}}
            rows.append(row)
            print(f"{name:6s} M={m:4d} N={n} K={k}: plan {chosen.bm}x{chosen.bn}/{chosen.splits} {times[chosen]:.4f} ms, "
                  f"best {best.bm}x{best.bn}/{best.splits} {times[best]:.4f}, torch.matmul {lib:.4f}, "
                  f"bound {row['bound_ms']:.5f}, max abs err {row['max_abs_err']:.3e} (|want| {want.abs().max().item():.2f})  | "
                  + " ".join(f"{key} {t:.4f}" for key, t in row["all"].items()), flush=True)
    # fc_in's own epilogue (bf16 bias, GELU) on the planner's plan, beside the same plan without it
    w = (torch.randn(3072, 768, generator=g, device="cuda") * 768**-0.5).to(bf16)
    b1 = (0.02 * torch.randn(3072, generator=g, device="cuda")).to(bf16)
    for m in (1024, 500, 64):
        a = torch.randn(m, 768, generator=g, device="cuda").to(bf16)
        p = GP.plan(m, 3072, 768, bf16)
        gelu_ms, bare_ms = (_device_ms(lambda gl=gl: GB.gemm_bf16(a, w, b1, p, gl), reps, "gemm_bf16_kernel") for gl in (True, False))
        rows.append({"gemm": "fc_in+GELU", "M": m, "plan": dataclasses.astuple(p), "plan_ms": gelu_ms, "no_gelu_ms": bare_ms})
        print(f"fc_in  M={m:4d} with its GELU (bf16 bias): plan {p.bm}x{p.bn}/{p.splits} {gelu_ms:.4f} ms, "
              f"{bare_ms:.4f} without", flush=True)
    print(json.dumps({"gemm_bf16": rows, "device": torch.cuda.get_device_name(0)}), flush=True)
    return 0


# the f32 parity forward's GEMMs at B=2 (name, M, N, K): text at bucket 512,
# audio at 5 s (QKV and Wo on T_pad 256, the FFN on T = 250), the 15 s audio FFN
GEMMS_F32 = (("QKV", 1024, 2304, 768), ("Wo", 1024, 768, 768), ("fc_in", 1024, 3072, 768), ("fc_out", 1024, 768, 3072),
             ("QKV", 512, 2304, 768), ("Wo", 512, 768, 768), ("fc_in", 500, 3072, 768), ("fc_out", 500, 768, 3072),
             ("fc_in", 1498, 3072, 768), ("fc_out", 1498, 768, 3072))


def gemm_f32_plans(reps: int) -> int:
    """The f32 GEMM alone: each candidate plan beside the planner's,
    torch.matmul and torch.addmm (TF32 off), at the parity forward's GEMMs
    and row 11's f32 conv; then the registers of each instance."""
    from msa_tpu_torch.ops.kernels import build
    from msa_tpu_torch.ops.kernels import conv as KC
    from msa_tpu_torch.ops.kernels import gemm_f32 as GF
    from msa_tpu_torch.ops.kernels import gemm_plan as GP

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    _, log = build.build(verbose=True)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    g = torch.Generator(device="cuda").manual_seed(0)
    rows = []

    def sweep(tag, m, n, k, run, plain, chosen, cands, flop, nbytes, lib=None):
        want = plain()
        scale = want.abs().max().item()
        times, errs = {}, {}
        for p in sorted(set(cands) | {chosen}, key=lambda p: (p.bm, p.bn, p.ctas)):
            errs[p] = (run(p) - want).abs().max().item() / scale
            times[p] = _device_ms(lambda p=p: run(p), reps, "gemm_f32_kernel")
        best = min(times, key=times.get)
        row = {"gemm": tag, "M": m, "N": n, "K": k, "plan": dataclasses.astuple(chosen), "plan_ms": times[chosen],
               "plan_call_ms": _event_ms(lambda: run(chosen), reps), "best": dataclasses.astuple(best),
               "best_ms": times[best], "bound_ms": 1e3 * max(flop / 67e12, nbytes / 3.35e12),
               "max_rel_err": max(errs.values()), "all": {f"{p.bm}x{p.bn}/{p.ctas}": t for p, t in times.items()}}
        text = ""
        for name, fn in (lib or {}).items():
            row[f"{name}_ms"], row[f"{name}_call_ms"] = _device_ms(fn, reps), _event_ms(fn, reps)
            text += f", {name} {row[f'{name}_ms']:.4f} (call {row[f'{name}_call_ms']:.4f})"
        rows.append(row)
        print(f"{tag:6s} M={m:4d} N={n} K={k}: plan {chosen.bm}x{chosen.bn}/{chosen.ctas} {times[chosen]:.4f} ms "
              f"(call {row['plan_call_ms']:.4f}; {flop / times[chosen] / 1e9:.1f} TFLOP/s), best {best.bm}x{best.bn}/"
              f"{best.ctas} {times[best]:.4f}{text}, bound {row['bound_ms']:.5f}, max rel err {row['max_rel_err']:.2e}  | "
              + " ".join(f"{key} {t:.4f}" for key, t in row["all"].items()), flush=True)

    def candidates(m, n, k, tiles, batch=1):
        out = []
        for bm, bn in tiles:
            p0 = GP.StreamPlan(bm, bn, 0)
            out += [p0] + [GP.StreamPlan(bm, bn, c) for c in (132, 264, 396, 528) if c <= p0.steps(m, n, k, batch)]
        return out

    for name, m, n, k in GEMMS_F32:
        a = torch.randn(m, k, generator=g, device="cuda")
        w = torch.randn(n, k, generator=g, device="cuda") * k**-0.5
        bias = 0.02 * torch.randn(n, generator=g, device="cuda")
        sweep(name, m, n, k, lambda p: GF.gemm_f32(a, w, bias, p), lambda: GF.gemm_f32_plain(a, w, bias),
              GP.plan_f32(m, n, k), candidates(m, n, k, GP.F32_TILES), 2 * m * n * k, 4 * (m * k + n * k + m * n + n),
              {"matmul": lambda: torch.matmul(a, w.t()), "addmm": lambda: torch.addmm(bias, a, w.t())})
    # row 11 on f32: B=8 L=1999 k=3 C=C'=512, the GELU; w [K, N], A rows 2C apart
    b, length, c, kw = 8, 1999, 512, 3
    x = torch.randn(b, length, c, generator=g, device="cuda")
    wc = 0.04 * torch.randn(kw, c, c, generator=g, device="cuda")
    out_len = (length - kw) // 2 + 1
    out = torch.empty(b, out_len, c, device="cuda")

    def conv(p):
        GF.launch(x, wc, None, out, out_len, c, kw * c, p, lda=2 * c, w_nk=False, batch=b, a_batch=length * c,
                  c_batch=out_len * c, gelu=True)
        return out

    sweep("conv", out_len, c, kw * c, conv, lambda: KC.conv_stride2_reference(x, wc),
          GP.plan_f32(out_len, c, kw * c, batch=b, w_nk=False), candidates(out_len, c, kw * c, GP.F32_KN_TILES, b),
          2 * b * out_len * kw * c * c, 4 * (b * length * c + kw * c * c + b * out_len * c))
    # fc_in with its GELU on the planner's plan, beside the same plan without it
    for m in (1024, 500, 1498):
        a = torch.randn(m, 768, generator=g, device="cuda")
        w = torch.randn(3072, 768, generator=g, device="cuda") * 768**-0.5
        b1 = 0.02 * torch.randn(3072, generator=g, device="cuda")
        p = GP.plan_f32(m, 3072, 768)
        gelu_ms, bare_ms = (_device_ms(lambda gl=gl: GF.gemm_f32(a, w, b1, p, gl), reps, "gemm_f32_kernel") for gl in (True, False))
        rows.append({"gemm": "fc_in+GELU", "M": m, "plan": dataclasses.astuple(p), "plan_ms": gelu_ms, "no_gelu_ms": bare_ms})
        print(f"fc_in  M={m:4d} with its GELU: plan {p.bm}x{p.bn}/{p.ctas} {gelu_ms:.4f} ms, {bare_ms:.4f} without", flush=True)
    name = None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1] if "gemm_f32_kernel" in line else None
        elif name and ("registers" in line or "spill" in line):
            print(f"ptxas {name}: {line.split('ptxas info    :')[-1].strip()}", flush=True)
    print(json.dumps({"gemm_f32": rows, "device": torch.cuda.get_device_name(0)}), flush=True)
    return 0


def f32_rows(reps: int) -> int:
    """Rows 10, 8 and 11 in f32 through ffn_fused, attention_block and
    conv_stride2_fused alone (TF32 off): device ms (every kernel of the
    call) and call ms (CUDA events), with the package they ran from."""
    import msa_tpu_torch
    from msa_tpu_torch.ops.kernels import attention as A
    from msa_tpu_torch.ops.kernels import conv as KC
    from msa_tpu_torch.ops.kernels import ffn as F

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    g = torch.Generator(device="cuda").manual_seed(0)
    dm, dff, heads = 768, 3072, 12

    def rand(*shape, scale=1.0):
        return torch.randn(*shape, generator=g, device="cuda") * scale

    w1, b1, w2, b2 = rand(dff, dm, scale=dm**-0.5), rand(dff, scale=0.02), rand(dm, dff, scale=dff**-0.5), rand(dm, scale=0.02)
    wq, bq, wo, bo = rand(3 * dm, dm, scale=dm**-0.5), rand(3 * dm, scale=0.02), rand(dm, dm, scale=dm**-0.5), rand(dm, scale=0.02)
    cases = []
    for n in (1024, 500):
        x = rand(n, dm)
        cases.append((f"row 10 f32 N={n}", lambda x=x: F.ffn_fused(x, w1, b1, w2, b2)))
    for t in (512, 250):
        x, mask = rand(2, t, dm), torch.ones(2, t, device="cuda")
        mask[1, t * 3 // 5 :] = 0.0
        cases.append((f"row 8 f32 B=2 T={t}", lambda x=x, mask=mask: A.attention_block(x, wq, bq, wo, bo, mask, heads)))
    for length, k, gelu in ((1999, 3, True), (999, 2, False)):
        x, w = rand(8, length, 512), rand(k, 512, 512, scale=0.04)
        cases.append((f"row 11 f32 B=8 L={length} k={k} gelu={gelu}", lambda x=x, w=w, gelu=gelu: KC.conv_stride2_fused(x, w, gelu)))
    rows = []
    for name, fn in cases:
        row = {"case": name, "device_ms": _device_ms(fn, reps), "call_ms": _event_ms(fn, reps)}
        rows.append(row)
        print(f"{name}: {row['device_ms']:.4f} ms (device), {row['call_ms']:.4f} ms (call)", flush=True)
    print(json.dumps({"f32_rows": rows, "package": str(Path(msa_tpu_torch.__file__).parent),
                      "device": torch.cuda.get_device_name(0)}), flush=True)
    return 0


def attention_bwd_f32_plans(reps: int) -> int:
    """The one-pass f32 attention backward alone: each plan beside the
    planner's, the D-tiled pair and f32 SDPA's autograd backward."""
    from msa_tpu_torch.ops.kernels import attention as A
    from msa_tpu_torch.ops.kernels import attention_bwd_plan as BP

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    g = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    for b, h, t, d in ((8, 12, 512, 64), (8, 12, 250, 64), (2, 12, 749, 64), (2, 4, 40, 24)):
        q, k, v, go = (torch.randn(b, h, t, d, generator=g, device="cuda") for _ in range(4))
        mask = torch.ones(b, t, device="cuda")
        mask[0, t * 3 // 4 :] = 0.0  # a ragged valid length
        o, lse = (x.contiguous() for x in A.mha_attention_plain(q, k, v, mask))
        want = A.attention_bwd_plain(q, k, v, mask, lse, o, go)
        delta = A._delta(o, go)
        outs = [torch.empty_like(q) for _ in range(3)]
        chosen = BP.plan(b, h, t, d)
        cands = {chosen} | {BP.BwdPlan(bk, s_) for bk in BP.KEY_TILES for s_ in (1, 2, 3, 4, 6, 8, 12)
                            if s_ <= BP.query_steps(t)}
        times, errs = {}, {}
        for p in sorted(cands, key=lambda p: (p.bk, p.splits)):
            def one(p=p):
                A.attention_bwd_onepass(q, k, v, go, lse, delta, mask, *outs, None, p)

            one()
            errs[p] = max(((x - w).abs().max() / w.abs().max()).item() for x, w in zip(outs, want))
            times[p] = _device_ms(one, reps, "onepass_f32_kernel")
        best = min(times, key=times.get)

        def pair():
            A.attention_bwd_dq(q, k, v, go, lse, delta, mask, outs[0])
            A.attention_bwd_dkv(q, k, v, go, lse, delta, mask, outs[1], outs[2])

        pair_ms = _device_ms(pair, reps, "simt_d")
        leaves = [x.detach().requires_grad_(True) for x in (q, k, v)]
        bias = torch.where(mask > 0, 0.0, -1e9)[:, None, None, :]
        lib_out = torch.nn.functional.scaled_dot_product_attention(*leaves, attn_mask=bias)
        lib_ms = _device_ms(lambda: torch.autograd.grad(lib_out, leaves, go, retain_graph=True), reps)
        flop = 10 * b * h * t * t * d
        row = {"B": b, "H": h, "T": t, "D": d, "plan": dataclasses.astuple(chosen), "plan_ms": times[chosen],
               "best": dataclasses.astuple(best), "best_ms": times[best], "pair_ms": pair_ms, "sdpa_bwd_ms": lib_ms,
               "bound_ms": 1e3 * max(flop / 67e12, (7 * 4 * b * h * t * d + 8 * b * h * t + 4 * b * t) / 3.35e12),
               "max_rel_err": max(errs.values()), "blocks": chosen.blocks(b, h, t),
               "all": {f"{p.bk}/{p.splits}": ms for p, ms in times.items()}}
        rows.append(row)
        print(f"B={b} H={h} T={t} D={d}: plan {chosen.bk}/{chosen.splits} ({row['blocks']} blocks) {times[chosen]:.4f} ms "
              f"({flop / times[chosen] / 1e9:.1f} TFLOP/s), best {best.bk}/{best.splits} {times[best]:.4f}, the pair "
              f"{pair_ms:.4f}, f32 sdpa backward {lib_ms:.4f}, bound {row['bound_ms']:.5f}, max rel err "
              f"{row['max_rel_err']:.2e}  | " + " ".join(f"{key} {ms:.4f}" for key, ms in row["all"].items()), flush=True)
        del leaves, lib_out
    print(json.dumps({"attention_bwd_f32": rows, "device": torch.cuda.get_device_name(0)}), flush=True)
    return 0


# the full-width shapes of the bf16 rows above D = 128: (B, T, H, D)
WIDE_FWD = ((2, 512, 4, 192), (2, 512, 3, 256))
WIDE_FLASH = ((2, 749, 4, 192),)
WIDE_BWD = ((8, 512, 4, 192), (8, 512, 3, 256))
WIDE_TINY = tuple((2, 100, 2, d) for d in (160, 192, 256))
# above D = 512, where Q's (and the backward's owned) tiles stream by the
# rule: d_model 1280 with 2 heads, 768 and 1024 with one
WIDE_BIG_FWD = ((2, 512, 2, 640), (2, 512, 1, 768), (2, 512, 1, 1024))
WIDE_BIG_BWD = tuple((8, t, h, d) for _, t, h, d in WIDE_BIG_FWD)


def _wide_mask(b: int, t: int) -> torch.Tensor:
    mask = torch.ones(b, t, device="cuda")
    mask[0, t * 3 // 4 :] = 0.0  # a ragged valid length
    return mask


def _rel_err(got, want) -> float:
    got, want = (x if isinstance(x, (tuple, list)) else (x,) for x in (got, want))
    return max(((a.float() - w.float()).abs().max() / w.float().abs().max()).item() for a, w in zip(got, want))


def attention_wide_rows(reps: int) -> int:
    """The bf16 attention rows above D = 128 through their public wrappers
    (any tree of the package): the attention kernels' device ms, the call's
    CUDA-event ms and the largest error against the plain version."""
    import msa_tpu_torch
    from msa_tpu_torch.ops.kernels import attention as A

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    g = torch.Generator(device="cuda").manual_seed(0)
    bf16 = torch.bfloat16

    def rand(*shape, scale=1.0):
        return (torch.randn(*shape, generator=g, device="cuda") * scale).to(bf16)

    rows = []

    def run(name, fn, plain, only, flop):
        try:
            got = fn()
        except ValueError as e:  # a tree whose wrappers refuse this D
            rows.append({"case": name, "refused": str(e)})
            print(f"{name}: refused ({e})", flush=True)
            return
        want = plain()
        row = {"case": name, "device_ms": _device_ms(fn, reps, only), "call_ms": _event_ms(fn, reps),
               "max_rel_err": _rel_err(got, want), "tflops": 0.0}
        row["tflops"] = flop / row["device_ms"] / 1e9
        rows.append(row)
        print(f"{name}: {row['device_ms']:.4f} ms (device, {row['tflops']:.1f} TFLOP/s of the function), "
              f"{row['call_ms']:.4f} ms (call), max rel err {row['max_rel_err']:.2e}", flush=True)

    # the attention kernels' names in either tree: wide_attention_kernel /
    # wide_mma_kernel (forward), simt_d*_kernel / wide_bwd_d*_kernel
    for b, t, h, d in WIDE_FWD + WIDE_TINY + WIDE_BIG_FWD:
        q, k, v = (rand(b, h, t, d) for _ in range(3))
        mask = _wide_mask(b, t)
        qkv = A._to_packed(q, k, v)
        flop = 4 * b * h * t * t * d
        tag = f"B={b} T={t} H={h} D={d}"
        run(f"row 1 fused_attention {tag}", lambda: A.fused_attention_lse(q, k, v, mask),
            lambda: A.fused_attention_plain(q, k, v, mask), "wide_", flop)
        run(f"row 2 mha_attention {tag}", lambda: A.mha_attention(q, k, v, mask),
            lambda: A.mha_attention_plain(q, k, v, mask), "wide_", flop)
        run(f"row 5 packed_qkv_attention_lse {tag}", lambda: A.packed_qkv_attention_lse(qkv, mask),
            lambda: A.packed_qkv_attention_lse_plain(qkv, mask), "wide_", flop)
        dm = -(-h * d // 128) * 128
        if dm == h * d:  # row 8 on d_model = H·D, weights padded to DP; its core alone
            x = rand(b, t, dm)
            wq, bq = rand(3 * dm, dm, scale=dm**-0.5), torch.randn(3 * dm, generator=g, device="cuda") * 0.02
            wo, bo = rand(dm, dm, scale=dm**-0.5), torch.randn(dm, generator=g, device="cuda") * 0.02
            pw, pb, po, _ = (t_ if t_ is None else t_.contiguous() for t_ in A.pad_block_weights(wq, bq, wo, h))
            run(f"row 8 core (attention_block, DP {A.block_head_dim(d)}) {tag}",
                lambda: A.attention_block(x, pw, pb, po, bo, mask, h, d),
                lambda: A.attention_block_plain(x, wq, bq, wo, bo, mask, h), "wide_",
                4 * b * h * t * t * A.block_head_dim(d))
    for b, t, h, d in WIDE_FLASH + tuple((2, 600, 2, d) for d in (160, 192, 256, 640, 768, 1024)):
        qkv = rand(b, t, 3, h, d)
        mask = _wide_mask(b, t)
        run(f"row 6 flash_attention_lse B={b} T={t} H={h} D={d}", lambda: A.flash_attention_lse(qkv, mask),
            lambda: A.flash_attention_lse_plain(qkv, mask), "wide_", 4 * b * h * t * t * d)
    for b, t, h, d in WIDE_BWD + WIDE_TINY + WIDE_BIG_BWD:
        q, k, v, go = (rand(b, h, t, d) for _ in range(4))
        mask = _wide_mask(b, t)
        try:
            o, lse = A.mha_attention(q, k, v, mask)
        except ValueError as e:
            rows.append({"case": f"rows 3 + 4 B={b} T={t} H={h} D={d}", "refused": str(e)})
            print(f"rows 3 + 4 B={b} T={t} H={h} D={d}: refused ({e})", flush=True)
            continue
        lse, delta = lse.contiguous(), A._delta(o, go)
        dq, dk, dv = (torch.empty_like(q) for _ in range(3))
        want = A.attention_bwd_plain(q, k, v, mask, lse, o, go)
        tag = f"B={b} T={t} H={h} D={d}"
        run(f"row 3 attention_bwd_dq {tag}", lambda: A.attention_bwd_dq(q, k, v, go, lse, delta, mask, dq) or dq,
            lambda: want[0], "dq_kernel", 6 * b * h * t * t * d)
        run(f"row 4 attention_bwd_dkv {tag}",
            lambda: A.attention_bwd_dkv(q, k, v, go, lse, delta, mask, dk, dv) or (dk, dv), lambda: want[1:],
            "dkv_kernel", 8 * b * h * t * t * d)
    print(json.dumps({"attention_wide": rows, "package": str(Path(msa_tpu_torch.__file__).parent),
                      "device": torch.cuda.get_device_name(0)}), flush=True)
    return 0


def _sdpa_backend(fn) -> str:
    """The backend scaled_dot_product_attention picked for ``fn``'s call,
    by the names of the kernels it ran."""
    from torch.profiler import ProfilerActivity, profile

    names = ""
    for _ in range(3):  # a trace that recorded no kernel is taken again
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        names = " ".join(e.key for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA).lower()
        if names:
            break
    return ("flash" if "flash" in names else "efficient" if ("fmha" in names or "efficient" in names) else
            "cudnn" if "cudnn" in names else "math")


# the f32 kernels above D = 64 / 128 in either tree: the forward's
# (wide_attention_kernel, then wide_f32_kernel) and the backward's (the
# pair simt_dq/dkv_kernel, then the one pass's kernels)
F32_FWD_KERNELS = ("wide_attention_kernel", "wide_f32_kernel", "fused_f32_kernel")
F32_BWD_KERNELS = ("simt_dq_kernel", "simt_dkv_kernel", "onepass_f32_kernel")
WIDE_F32_BWD = ((8, 512, 4, 192), (8, 512, 3, 256), (8, 512, 6, 128))
# the f32 rows at D = 64 (row 1's f32 core forward, the narrow one pass
# backward), which the wide kernels leave as they were: the control
F32_CONTROL = (2, 512, 12, 64), (8, 512, 12, 64)
WIDE_F32_SMALL = (160, 192, 256, 640, 768, 1024)


def attention_wide_f32_rows(reps: int) -> int:
    """The f32 attention rows above D = 64 / 128 through their public
    wrappers (any tree of the package), beside one f32 SDPA call: the
    attention kernels' device ms, the call's CUDA-event ms, the largest
    error against the plain version and the exact-f32 bound."""
    import torch.nn.functional as F

    import msa_tpu_torch
    from msa_tpu_torch.ops.kernels import attention as A
    from msa_tpu_torch.pipeline import graph as G

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    g = torch.Generator(device="cuda").manual_seed(0)

    def rand(*shape, scale=1.0):
        return torch.randn(*shape, generator=g, device="cuda") * scale

    def bound(nbytes, flop):
        return max(nbytes / 3.35e12, flop / 67e12) * 1e3

    rows = []

    def run(name, fn, plain, only, flop, nbytes, lib=None):
        try:
            got = fn()
        except ValueError as e:  # a tree whose wrappers refuse this D
            rows.append({"case": name, "refused": str(e)})
            print(f"{name}: refused ({e})", flush=True)
            return
        want = plain()
        row = {"case": name, "device_ms": _device_ms(fn, reps, only), "call_ms": _event_ms(fn, reps),
               "max_rel_err": _rel_err(got, want), "bound_ms": bound(nbytes, flop)}
        row["tflops"] = flop / row["device_ms"] / 1e9
        text = ""
        if lib is not None:
            row["sdpa_ms"], row["sdpa_backend"] = _device_ms(lib, reps), _sdpa_backend(lib)
            text = f", f32 sdpa ({row['sdpa_backend']} backend) {row['sdpa_ms']:.4f} ms"
        rows.append(row)
        print(f"{name}: {row['device_ms']:.4f} ms (device, {row['tflops']:.1f} TFLOP/s of the function), "
              f"{row['call_ms']:.4f} ms (call), max rel err {row['max_rel_err']:.2e}, bound {row['bound_ms']:.5f} ms"
              f"{text}", flush=True)

    def sdpa(q, k, v, mask):
        bias = torch.where(mask > 0, 0.0, -1e9)[:, None, None, :]
        return F.scaled_dot_product_attention(q, k, v, attn_mask=bias)

    with G.exact_fp32():
        fwd = [(b, t, h, d, "all") for b, t, h, d in WIDE_FWD] + [(8, 512, 4, 192, "5"), (*F32_CONTROL[0], "5")]
        fwd += [(2, 100, 2, d, "1, 2, 5") for d in WIDE_F32_SMALL] + [(2, 100, 4, d, "8") for d in (160, 192, 256)]
        for b, t, h, d, which in fwd:
            q, k, v = (rand(b, h, t, d) for _ in range(3))
            mask = _wide_mask(b, t)
            qkv = A._to_packed(q, k, v)
            flop, nbytes = 4 * b * h * t * t * d, 4 * (4 * b * h * t * d + b * h * t + b * t)
            tag = f"B={b} T={t} H={h} D={d}"
            lib = lambda: sdpa(q, k, v, mask)  # noqa: E731
            if which != "8":
                run(f"row 5 packed_qkv_attention_lse f32 {tag}", lambda: A.packed_qkv_attention_lse(qkv, mask),
                    lambda: A.packed_qkv_attention_lse_plain(qkv, mask), F32_FWD_KERNELS, flop, nbytes, lib)
            if which in ("all", "1, 2, 5"):
                run(f"row 1 fused_attention f32 {tag}", lambda: A.fused_attention_lse(q, k, v, mask),
                    lambda: A.fused_attention_plain(q, k, v, mask), F32_FWD_KERNELS, flop, nbytes, lib)
                run(f"row 2 mha_attention f32 {tag}", lambda: A.mha_attention(q, k, v, mask),
                    lambda: A.mha_attention_plain(q, k, v, mask), F32_FWD_KERNELS, flop, nbytes, lib)
            dm = h * d
            if which in ("all", "8"):  # rows 8 and 7 on d_model = H·D, weights padded to DP
                dp = A.block_head_dim(d)
                x = rand(b, t, dm)
                wq, bq = rand(3 * dm, dm, scale=dm**-0.5), rand(3 * dm, scale=0.02)
                wo, bo = rand(dm, dm, scale=dm**-0.5), rand(dm, scale=0.02)
                pw, pb, po, _ = (t_ if t_ is None else t_.contiguous() for t_ in A.pad_block_weights(wq, bq, wo, h))
                t_pad = -(-t // 128) * 128
                core_flop = 4 * b * h * t_pad * t_pad * dp
                run(f"row 8 f32 core (attention_block, DP {dp}) {tag}",
                    lambda: A.attention_block(x, pw, pb, po, bo, mask, h, d),
                    lambda: A.attention_block_plain(x, wq, bq, wo, bo, mask, h), F32_FWD_KERNELS, core_flop,
                    4 * (4 * b * h * t_pad * dp + b * t_pad))
                from msa_tpu_torch.ops import quant as Q

                wq_q, sq = Q.quantize_weight_axis(wq, axis=1)
                wo_q, so = Q.quantize_weight_axis(wo, axis=1)
                sq, so = sq[:, 0].contiguous(), so[:, 0].contiguous()
                pwq, pbq, poq, psq = (t_.contiguous() for t_ in A.pad_block_weights(wq_q, bq, wo_q, h, sq))
                run(f"row 7 core on f32 x (attention_block_int8, DP {dp}) {tag}",
                    lambda: A.attention_block_int8(x, pwq, psq, pbq, poq, so, bo, mask, h, d),
                    lambda: A.attention_block_int8_plain(x, wq_q, sq, bq, wo_q, so, bo, mask, h), F32_FWD_KERNELS,
                    core_flop, 4 * (4 * b * h * t_pad * dp + b * t_pad))
        for b, t, h, d in WIDE_FLASH + tuple((2, 600, 2, d) for d in WIDE_F32_SMALL):
            qkv = rand(b, t, 3, h, d)
            mask = _wide_mask(b, t)
            q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
            run(f"row 6 flash_attention_lse f32 B={b} T={t} H={h} D={d}", lambda: A.flash_attention_lse(qkv, mask),
                lambda: A.flash_attention_lse_plain(qkv, mask), F32_FWD_KERNELS, 4 * b * h * t * t * d,
                4 * (4 * b * h * t * d + b * h * t + b * t), lambda: sdpa(q, k, v, mask))
        for b, t, h, d in WIDE_F32_BWD + tuple((2, 100, 2, d) for d in WIDE_F32_SMALL) + F32_CONTROL[1:]:
            q, k, v, go = (rand(b, h, t, d) for _ in range(4))
            mask = _wide_mask(b, t)
            o, lse = A.mha_attention_plain(q, k, v, mask)
            want = A.attention_bwd_plain(q, k, v, mask, lse, o, go)
            leaves = [x.detach().requires_grad_(True) for x in (q, k, v)]
            lib_out = sdpa(*leaves, mask)
            run(f"rows 3 + 4 attention_bwd f32 B={b} T={t} H={h} D={d}", lambda: A.attention_bwd(q, k, v, mask, lse, o, go),
                lambda: want, F32_BWD_KERNELS, 10 * b * h * t * t * d, 4 * (7 * b * h * t * d + 2 * b * h * t + b * t),
                lambda: torch.autograd.grad(lib_out, leaves, go, retain_graph=True))
            del leaves, lib_out
    print(json.dumps({"attention_wide_f32": rows, "package": str(Path(msa_tpu_torch.__file__).parent),
                      "device": torch.cuda.get_device_name(0)}), flush=True)
    return 0


def attention_wide_f32_plans(reps: int) -> int:
    """Every plan of the f32 forward above D = 128 (through
    ``msa_fused_attention``) and of the one-pass backward above D = 64,
    device ms each, the planner's marked, each checked against the plain
    version."""
    from msa_tpu_torch.ops.kernels import attention as A
    from msa_tpu_torch.ops.kernels import attention_bwd_plan as BP
    from msa_tpu_torch.ops.kernels import attention_wide_plan as WP
    from msa_tpu_torch.ops.kernels import build

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    g = torch.Generator(device="cuda").manual_seed(0)
    lib = build.library()
    rows = []
    fwd = WIDE_FWD + ((8, 512, 4, 192),) + tuple((2, 100, 2, d) for d in (160, 192, 256, 640)) + ((2, 600, 2, 192),)
    for b, t, h, d in fwd + WIDE_FLASH:
        q, k, v = (torch.randn(b, h, t, d, generator=g, device="cuda") for _ in range(3))
        mask = _wide_mask(b, t)
        want = A.fused_attention_plain(q, k, v, mask)
        o, lse = torch.empty_like(q), torch.empty(b, h, t, device="cuda")
        chosen = WP.plan(b, h, t, d)
        stream = torch.cuda.current_stream().cuda_stream
        for p in (WP.WidePlan(bq, s) for bq in WP.QUERY_TILES for s in range(1, WP.key_blocks(t) + 1)):
            def one(p=p):
                code, tickets, ws = WP.launch_args(q.device, p, b, h, t, d)
                build.check(lib.msa_fused_attention(q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(),
                                                    o.data_ptr(), lse.data_ptr(), b, t, h, d, 0, code, tickets, ws,
                                                    A._scale(d), stream), "wide f32 forward")
                return o, lse

            err = _rel_err(one(), want)
            ms = _device_ms(one, reps, "wide_f32_kernel")
            rows.append({"kernel": "forward", "shape": [b, t, h, d], "bq": p.bq, "splits": p.splits, "device_ms": ms,
                         "chosen": p == chosen, "max_rel_err": err})
            print(f"forward B={b} T={t} H={h} D={d} bq={p.bq} splits={p.splits} blocks={p.blocks(b, h, t, d)}: "
                  f"{ms:.4f} ms{' (plan)' if p == chosen else ''} err {err:.1e}", flush=True)
    for b, t, h, d in WIDE_F32_BWD + ((2, 100, 2, 192), (2, 100, 2, 640), (2, 749, 4, 192)):
        q, k, v, go = (torch.randn(b, h, t, d, generator=g, device="cuda") for _ in range(4))
        mask = _wide_mask(b, t)
        o, lse = A.mha_attention_plain(q, k, v, mask)
        lse, delta = lse.contiguous(), A._delta(o, go)
        want = A.attention_bwd_plain(q, k, v, mask, lse, o, go)
        outs = [torch.empty_like(q) for _ in range(3)]
        chosen = BP.plan(b, h, t, d)
        for p in (BP.BwdPlan(bk, s) for bk in BP.key_tiles_for(d) for s in range(1, BP.query_steps(t, d) + 1)):
            if p.splits > 8 and p != chosen:
                continue

            def one(p=p):
                A.attention_bwd_onepass(q, k, v, go, lse, delta, mask, *outs, plan=p)
                return outs

            err = _rel_err(one(), want)
            ms = _device_ms(one, reps, "onepass_f32_kernel")
            rows.append({"kernel": "backward", "shape": [b, t, h, d], "bk": p.bk, "splits": p.splits, "device_ms": ms,
                         "chosen": p == chosen, "max_rel_err": err})
            print(f"backward B={b} T={t} H={h} D={d} bk={p.bk} splits={p.splits} blocks={p.blocks(b, h, t, d)}: "
                  f"{ms:.4f} ms{' (plan)' if p == chosen else ''} err {err:.1e}", flush=True)
    print(json.dumps({"attention_wide_f32_plans": rows, "device": torch.cuda.get_device_name(0)}), flush=True)
    return 0


def attention_wide_tiles(reps: int) -> int:
    """The tensor-core forward above D = 128 alone, each rounding order at
    each column tile and at the rule's, beside one SDPA call; then the
    registers and spills of its instances and of the backward pair's."""
    from msa_tpu_torch.ops.kernels import attention as A
    from msa_tpu_torch.ops.kernels import build

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    _, log = build.build(verbose=True)
    lib = build.library()
    g = torch.Generator(device="cuda").manual_seed(0)
    bf16 = torch.bfloat16
    rows = []

    def launched(one):  # the launch's result, or None where the entry refuses the shape
        try:
            return one()
        except RuntimeError as e:
            print(f"  refused: {e}", flush=True)
            return None

    for b, t, h, d in WIDE_FWD + ((8, 512, 4, 192),) + WIDE_FLASH + WIDE_TINY + WIDE_BIG_FWD:
        q, k, v = (torch.randn(b, h, t, d, generator=g, device="cuda").to(bf16) for _ in range(3))
        mask = _wide_mask(b, t)
        qkv = A._to_packed(q, k, v)
        scale = A._scale(d)
        flat = qkv.float().reshape(b, t, 3 * h * d)
        plain = {  # the plain version of each order on [B, H, T, D]
            0: lambda: A.mha_attention_plain(q, k, v, mask)[0],
            1: lambda: A._heads_first(A._attend(flat, mask, h, bf16, scale), h),
            2: lambda: A._heads_first(A.flash_attention_lse_plain(qkv, mask)[0], h),
        }
        bias = torch.where(mask > 0, 0.0, -1e9).to(bf16)[:, None, None, :]
        sdpa_ms = _device_ms(lambda: torch.nn.functional.scaled_dot_product_attention(q, k, v, attn_mask=bias), reps)
        flop = 4 * b * h * t * t * d
        for order in (0, 1, 2):
            want = plain[order]()
            # each column tile with Q resident (1) and streamed (2); above
            # D = 512 the rule's tile only
            for nc, qmode in [(nc, qm) for nc in ((0, 128, 192) if d <= 512 else (0,)) for qm in (1, 2)]:
                o = torch.empty_like(q)
                lse = torch.empty(b, h, t, device="cuda")

                def one(o=o, lse=lse, order=order, nc=nc, qmode=qmode):
                    rc = lib.msa_attention_wide_mma(q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(),
                                                    o.data_ptr(), lse.data_ptr(), b, t, h, d, order, nc, qmode, scale,
                                                    torch.cuda.current_stream().cuda_stream)
                    build.check(rc, "msa_attention_wide_mma")
                    return o

                q_at = "resident" if qmode == 1 else "streamed"
                if launched(one) is None:
                    rows.append({"B": b, "T": t, "H": h, "D": d, "order": order, "nc": nc, "q": q_at, "refused": True})
                    continue
                err = _rel_err(one(), want)
                ms = _device_ms(one, reps, "wide_mma_kernel")
                row = {"B": b, "T": t, "H": h, "D": d, "order": order, "nc": nc, "q": q_at, "ms": ms, "sdpa_ms": sdpa_ms,
                       "max_rel_err": err, "bound_ms": 1e3 * max(flop / 989e12, (4 * b * h * t * d * 2 + 4 * b * t) / 3.35e12)}
                rows.append(row)
                print(f"B={b} T={t} H={h} D={d} order {order} nc {nc or 'rule'} Q {q_at}: {ms:.4f} ms "
                      f"({flop / ms / 1e9:.1f} TFLOP/s of the function), sdpa {sdpa_ms:.4f}, bound {row['bound_ms']:.5f}, "
                      f"max rel err {err:.2e}", flush=True)
        del q, k, v, qkv, flat
    for b, t, h, d in WIDE_BWD + WIDE_BIG_BWD:  # the backward's kernels at each column tile, beside SDPA's backward
        q, k, v, go = (torch.randn(b, h, t, d, generator=g, device="cuda").to(bf16) for _ in range(4))
        mask = _wide_mask(b, t)
        o, lse = (x.contiguous() for x in A.mha_attention(q, k, v, mask))
        delta = A._delta(o, go)
        want = A.attention_bwd_plain(q, k, v, mask, lse, o, go)
        leaves = [x.detach().requires_grad_(True) for x in (q, k, v)]
        bias = torch.where(mask > 0, 0.0, -1e9).to(bf16)[:, None, None, :]
        lib_out = torch.nn.functional.scaled_dot_product_attention(*leaves, attn_mask=bias)
        lib_ms = _device_ms(lambda: torch.autograd.grad(lib_out, leaves, go, retain_graph=True), reps)
        for kernel, ops, outs in (("dq", 6, 1), ("dkv", 8, 2)):
            tiles = ((0, 128) + ((192,) if d <= 192 else ())) if kernel == "dq" and d <= 512 else (0,)
            for nc, omode in [(nc, om) for nc in tiles for om in (1, 2)]:
                got = [torch.empty_like(q) for _ in range(outs)]
                ptrs = [got[0].data_ptr(), 0, 0] if kernel == "dq" else [0, got[0].data_ptr(), got[1].data_ptr()]

                def one(got=got, ptrs=ptrs, nc=nc, omode=omode):
                    rc = lib.msa_attention_bwd_wide(q.data_ptr(), k.data_ptr(), v.data_ptr(), go.data_ptr(),
                                                    lse.data_ptr(), delta.data_ptr(), mask.data_ptr(), *ptrs, b, t, h,
                                                    d, nc, omode, A._scale(d), torch.cuda.current_stream().cuda_stream)
                    build.check(rc, "msa_attention_bwd_wide")
                    return got

                o_at = "resident" if omode == 1 else "streamed"
                if launched(one) is None:
                    rows.append({"B": b, "T": t, "H": h, "D": d, "kernel": kernel, "nc": nc, "owned": o_at, "refused": True})
                    continue
                err = _rel_err(one(), want[:1] if kernel == "dq" else want[1:])
                ms = _device_ms(one, reps, f"wide_bwd_{kernel}_kernel")
                rows.append({"B": b, "T": t, "H": h, "D": d, "kernel": kernel, "nc": nc, "owned": o_at, "ms": ms,
                             "sdpa_bwd_ms": lib_ms, "max_rel_err": err})
                print(f"{kernel} B={b} T={t} H={h} D={d} nc {nc or 'rule'} owned tiles {o_at}: {ms:.4f} ms "
                      f"({ops * b * h * t * t * d / ms / 1e9:.1f} TFLOP/s on {ops}·B·H·T²·D), sdpa backward (dq, dk, dv) "
                      f"{lib_ms:.4f}, max rel err {err:.2e}", flush=True)
        del leaves, lib_out
    cur = None
    for line in log.splitlines():  # -Xptxas -v: each entry's spill line, then its registers
        if "Compiling entry function" in line:
            cur = line.split("'")[1] if "wide_" in line else None
        elif cur and ("spill" in line or "Used" in line):
            print(f"  ptxas {cur}: {line.split('ptxas info    :')[-1].strip()}", flush=True)
    print(json.dumps({"attention_wide_tiles": rows, "device": torch.cuda.get_device_name(0)}), flush=True)
    return 0


# the chains' shapes: (B, T, heads) at d_model 768 (row 9 at N = B·T rows)
CHAIN_SHAPES = ((2, 512, 12), (2, 250, 12), (1, 128, 12), (64, 512, 12), (2, 512, 4))
CHAIN_SPIN_CYCLES = 1_000_000  # about 0.5 ms of spin before each call: its launches all queue behind it


def int8_chains(reps: int) -> int:
    """Rows 7 and 9's int8 chains through their public wrappers (any tree
    of the package): each call queued behind a spin kernel, its span on the
    card, the union of its kernels' busy intervals, its kernels' count; then
    each kernel of the chains timed alone on a direct call."""
    from torch.profiler import ProfilerActivity, profile

    import msa_tpu_torch
    from msa_tpu_torch.ops import quant as Q
    from msa_tpu_torch.ops.kernels import attention as A
    from msa_tpu_torch.ops.kernels import ffn as F
    from msa_tpu_torch.ops.kernels import gemm_s8 as GS
    from msa_tpu_torch.ops.kernels import quant as KQ

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    g = torch.Generator(device="cuda").manual_seed(0)
    dm, dff = 768, 3072

    def rand(*shape, scale=1.0, dtype=torch.float32):
        return (torch.randn(*shape, generator=g, device="cuda") * scale).to(dtype)

    def int8_weight(n, k):
        w, s = Q.quantize_weight_axis(rand(n, k, scale=k**-0.5), axis=1)
        return w, s[:, 0].contiguous()

    def chain_reading(fn, kind):
        """The chains of ``reps`` calls, each behind a spin kernel."""
        fn()
        torch.cuda.synchronize()
        for _ in range(3):  # a trace that lost a kernel of a chain is taken again
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(reps):
                    torch.cuda._sleep(CHAIN_SPIN_CYCLES)
                    fn()
                torch.cuda.synchronize()
            cs = _chains(_device_intervals(prof))[kind]
            if len(cs) == reps:
                break
        if not cs:
            return {"calls": 0}
        n = len(cs)  # medians over the calls: a call the host or the card held up once moves no reading
        return {"calls": n, "span_ms": float(np.median([c["span_us"] for c in cs])) / 1e3,
                "busy_ms": float(np.median([c["busy_us"] for c in cs])) / 1e3,
                "kernels": round(sum(c["kernels"] for c in cs) / n, 2),
                "durations_ms": [round(float(np.median([c["durations_us"][j] for c in cs])) / 1e3, 5)
                                 for j in range(len(_CHAINS[kind]))]}

    rows = []

    def show(row):
        rows.append(row)
        print(json.dumps(row), flush=True)

    for row in _quant_card_state(KQ, reps):  # first, while the card is as idle as the smoke leaves it
        show(row)
    w1, s1 = int8_weight(dff, dm)
    w2, s2 = int8_weight(dm, dff)
    b1, b2 = rand(dff, scale=0.02), rand(dm, scale=0.02)
    for b, t, h in CHAIN_SHAPES:
        d = dm // h
        wq_f, wo_f = rand(3 * dm, dm, scale=dm**-0.5), rand(dm, dm, scale=dm**-0.5)
        bq, bo = rand(3 * dm, scale=0.02), rand(dm, scale=0.02)
        (wq, sq), (wo, so) = (Q.quantize_weight_axis(w, axis=1) for w in (wq_f, wo_f))
        sq, so = sq[:, 0].contiguous(), so[:, 0].contiguous()
        pw, pb, po, ps = (x.contiguous() for x in A.pad_block_weights(wq, bq, wo, h, sq))
        mask = torch.ones(b, t, device="cuda")
        for dt in (torch.bfloat16, torch.float32):
            dn = "bf16" if dt == torch.bfloat16 else "f32"
            x = rand(b, t, dm, dtype=dt)
            row = {"row": 7, "x": dn, "B": b, "T": t, "H": h, "D": d,
                   **chain_reading(lambda: A.attention_block_int8(x, pw, ps, pb, po, so, bo, mask, h, d), "row 7")}
            # the core alone: inside row 8's attention_block, launched in plain order
            wq_c, wo_c = wq_f.to(dt), wo_f.to(dt)
            p8w, p8b, p8o, _ = (x_ if x_ is None else x_.contiguous() for x_ in A.pad_block_weights(wq_c, bq, wo_c, h))
            row["core_alone_ms"] = _device_ms(lambda: A.attention_block(x, p8w, p8b, p8o, bo, mask, h, d), reps, _CORES)
            show(row)
            if h != 12:
                continue
            n = b * t
            xf = rand(n, dm, dtype=dt)
            show({"row": 9, "x": dn, "N": n,
                  **chain_reading(lambda: F.ffn_fused_int8(xf, w1, s1, b1, w2, s2, b2), "row 9")})
    # the kernels alone, each on a direct call in plain stream order
    for n in sorted({b * t for b, t, _ in CHAIN_SHAPES} | {b * (-(-t // 128) * 128) for b, t, _ in CHAIN_SHAPES}):
        for dt in (torch.bfloat16, torch.float32):
            x = rand(n, dm, dtype=dt)
            show({"kernel": "quantize_rows", "x": "bf16" if dt == torch.bfloat16 else "f32", "shape": [n, dm],
                  "ms": _device_ms(lambda: KQ.quantize_rows(x), reps, "quantize_rows"),
                  "bound_ms": (n * dm * (x.element_size() + 1) + 4 * n) / 3.35e9})
        h_ = rand(n, dff)
        # the row kernel from x at the hidden tile's width (the shape chip_smoke.py's kernels line records)
        show({"kernel": "quantize_rows", "x": "f32", "shape": [n, dff],
              "ms": _device_ms(lambda: KQ.quantize_rows(h_), reps, "quantize_rows"),
              "bound_ms": (n * dff * 5 + 4 * n) / 3.35e9})
        amax = h_.abs().amax(dim=1).view(torch.int32).contiguous()
        show({"kernel": "quantize_rows_amax", "shape": [n, dff],
              "ms": _device_ms(lambda: KQ.quantize_rows(h_, amax), reps, "quantize_rows_amax"),
              "bound_ms": (n * dff * 5 + 8 * n) / 3.35e9})
        ones_m = torch.ones(n, device="cuda")
        for name, nn, k in (("QKV", 3 * dm, dm), ("Wo", dm, dm), ("fc_in", dff, dm), ("fc_out", dm, dff)):
            a = torch.randint(-127, 128, (n, k), generator=g, device="cuda", dtype=torch.int8)
            w = torch.randint(-127, 128, (nn, k), generator=g, device="cuda", dtype=torch.int8)
            args = (a, w, ones_m, torch.ones(nn, device="cuda"), torch.zeros(nn, device="cuda"))
            gelu = name == "fc_in"
            show({"kernel": "gemm_s8", "gemm": name, "M": n, "N": nn, "K": k,
                  "ms": _device_ms(lambda: GS.gemm_s8(*args, gelu=gelu), reps, "gemm_s8_kernel")})
    print(json.dumps({"int8_chains": rows, "package": str(Path(msa_tpu_torch.__file__).parent), "card": smi,
                      "device": torch.cuda.get_device_name(0)}), flush=True)
    return 0


_CORES = ("packed_qkv_kernel", "fused_f32_kernel", "wide_mma_kernel", "wide_f32_kernel")
# spin kernels of these many SM cycles (torch.cuda._sleep counts clock64):
# two short ones whose durations give the SM clock, and about 100 ms
CLOCK_PROBE_CYCLES = (20_000, 120_000)
SPIN_100MS_CYCLES = 200_000_000


def _sm_mhz(reps: int = 5) -> float:
    """The SM clock now, in MHz: the cycles between the two probes over
    the µs between their median durations, each probe launched alone."""
    from torch.profiler import ProfilerActivity, profile

    med = []
    for cycles in CLOCK_PROBE_CYCLES:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                torch.cuda._sleep(cycles)
                torch.cuda.synchronize()
        med.append(float(np.median([end - start for start, end, _ in _device_intervals(prof)])))
    return (CLOCK_PROBE_CYCLES[1] - CLOCK_PROBE_CYCLES[0]) / (med[1] - med[0])


def _quant_card_state(KQ, reps: int):
    """The row kernel at bf16 [128 | 1024, 768] and f32 [1024, 3072], and
    the hidden tile's amax form at [1024, 3072], in three states of the
    card, the SM clock read just after each reading: on direct calls each
    launched by the host after the last, as chip_smoke.py times it, after
    the host left the card idle 1 s and right after 100 ms of spin; and
    every call queued behind a spin kernel, so that they run back to back.
    Each on normal values and with every 7th row of the second half zero
    (chip_smoke.py's padding rows)."""
    from torch.profiler import ProfilerActivity, profile

    cases = []
    for dt, n, cols, form in ((torch.bfloat16, 128, 768, "x"), (torch.bfloat16, 1024, 768, "x"),
                              (torch.float32, 1024, 3072, "x"), (torch.float32, 1024, 3072, "amax")):
        for data in ("normal", "zero rows"):
            x = torch.randn(n, cols, device="cuda").to(dt)
            if data == "zero rows":
                x[n // 2 :: 7] = 0
            amax = x.abs().amax(dim=1).view(torch.int32).contiguous() if form == "amax" else None
            cases.append(({"x": "bf16" if dt == torch.bfloat16 else "f32", "shape": [n, cols], "form": form,
                           "data": data}, lambda x=x, amax=amax: KQ.quantize_rows(x, amax)))
    out = []
    for state in ("idle 1 s", "after 100 ms of spin", "queued behind a spin"):
        for case, fn in cases:
            fn()
            torch.cuda.synchronize()
            if state == "queued behind a spin":
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    torch.cuda._sleep(CHAIN_SPIN_CYCLES)
                    for _ in range(reps):
                        fn()
                    torch.cuda.synchronize()
                ms = float(np.mean([e - s for s, e, name in _device_intervals(prof) if "quantize_rows" in name])) / 1e3
            else:
                if state == "idle 1 s":
                    time.sleep(1.0)
                else:
                    torch.cuda._sleep(SPIN_100MS_CYCLES)
                    torch.cuda.synchronize()
                ms = _device_ms(fn, reps, "quantize_rows")
            out.append({"quantize_rows_state": state, **case, "ms": ms, "sm_mhz": _sm_mhz()})
    return out


if __name__ == "__main__":
    sys.exit(main())
