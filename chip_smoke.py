"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (H100).

    python3 chip_smoke.py

Phases, one line each with its seconds:
  1. require CUDA; print the card's name and power limit;
  2. build the hand-written kernels (one nvcc call, from msa_tpu_torch/csrc);
  3. hold each kernel against its plain PyTorch version on the card at the
     main paths' shapes, and time both with CUDA events: the bf16
     attention_block and ffn_fused, the row-quantize kernel (exactly: codes
     and scales equal), attention_block_int8 and ffn_fused_int8, and the
     attention-only kernels packed_qkv_attention and flash_attention (o and
     lse, with a ragged T and a row with no valid key), beside one
     scaled_dot_product_attention call on the same inputs as yardstick;
  4. the bf16 recipe at full width: PipelineModels.initialize(
     quantize="none") → SegmentPipeline.run_host at B=2, at the 512-token and
     the 32-token bucket; check that every shipped checkpoint loaded, the
     [2, 1715] hostpack, the kernels' launch counts (24 each per forward:
     12 text + 12 audio layers), and each encoder's last hidden state and
     each hostpack column group against the port's plain bf16 path (einsum
     attention, dense FFN) on the same weights and inputs, with an f32 run
     of that path as the yardstick of bf16 noise; a planted fault shows
     that the checks can fail;
  5. the int8 recipe, the default: PipelineModels.initialize() with no
     quantize argument → run_host at both buckets; 24 launches of each int8
     kernel per forward (96 of the row-quantize kernel) and none of the
     bf16 ones; the same checks as phase 4, against the same path run
     through the int8 kernels' plain versions, with the f32 run of the same
     masters as yardstick and the last head's V rows zeroed as the fault;
  6. the init: the seconds of the full-size initialize(), and a few of its
     leaves (text word embeddings and layer-0 QKV, audio layer-0 fc_in) and
     the int8 codes derived from one, against the same init run on the CPU;
  7. run_stream at B=1: one packed window at the 128-token bucket, equal to
     run_host on the same window bit for bit, with its carry; 24 launches
     of each int8 kernel per window;
  8. 15 s segments at full width (segment_samples=240_000): run_host at
     B=2, bucket 512, in both recipes; the audio encoder runs at T = 749,
     so each of its 12 layers takes the dense projections and
     flash_attention; 12 flash launches per forward, 12 of the text's
     attention kernel, 24 of the FFN kernel; the same checks as phases 4
     and 5, and the forward's wall and device time;
  9. a custom-width encoder (2 layers, d_model 96, 4 heads, d_ff 256) in
     the bf16 and int8 recipes: 2 packed_qkv_attention launches and the
     dense FFN, held against its plain path; then PipelineModels.tiny() on
     the card, which launches no kernel, against the same models on the CPU;
Phases 4, 5 and 8 also time run_host per forward, phase 7 run_stream per
window. Counts are set to 0 just before each path runs and read just after.
The line before the last is a JSON object with each kernel's numbers; the
last line is the JSON contract line. Any failure exits nonzero.
"""

from __future__ import annotations

import contextlib
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

# dense peaks of an H100 SXM at 700 W (NVIDIA's data sheet)
PEAK = {"bf16": 989e12, "int8": 1979e12, "f32": 67e12}
H100_BYTES_PER_S = 3.35e12  # HBM3

# bf16 bound for a kernel against its plain version: both round at the same
# points, so only f32 summation order can flip a last bit, which the output
# projection carries; 5 bf16 steps (2^-8) of the largest magnitude, + 1e-3.
# The int8 kernels take the same bound: their int32 sums are exact and they
# quantize bit for bit as their plain versions, so what is left is the bf16
# attention core's summation order (one flip can move a row's int8 codes).
KERNEL_RTOL = 5 * 2.0**-8
# each encoder's last hidden state on the main path: the kernel path and
# the port's plain bf16 path (einsum attention, dense FFN) round at
# different points, and a random 12-layer trunk carries each difference
# forward, so the bound is relative to bf16 noise: against an f32 run of the
# same weights, the kernel path's RMS error may be at most
# ENCODER_NOISE_RATIO times the plain bf16 path's. On an H100 (PERF.md),
# with the f32 masters as yardstick, a sound run read at most 1.0181, and a
# planted fault (the last head's output left at zero, as a head loop one
# short would) at least 57.10; the smoke checks that this fault still fails
# the bound.
ENCODER_NOISE_RATIO = 1.25
# the hostpack, column group by column group, by the same measure; a group
# is checked where the plain bf16 path's RMS error is at most
# HOSTPACK_NOISE_SHARE of the group's RMS (the head probabilities on a
# random trunk are noise as large as their values). On an H100 (PERF.md) a
# sound run read at most 1.2796 in a checked group, and the planted head
# fault at least 7.55 in a checked group downstream of an encoder.
HOSTPACK_NOISE_RATIO, HOSTPACK_NOISE_SHARE = 2.0, 0.1
# the int8 path, by the same two measures, against the same path run
# through the int8 kernels' plain versions. Both round at the same points,
# but a flipped code in one layer moves the two runs apart, so at depth
# they differ from each other about as much as each differs from f32. On an
# H100 (PERF.md) a sound run read at most 1.0056 on the encoders and 2.032
# in a checked hostpack group (the audio head's probabilities, whose error
# after the time pool is 0.15% of their values); the planted fault (the
# last head's V rows zeroed before quantization) read at least 20.26 and
# 16.16. The first bounds, 1.1 and 1.5, were set before any reading; the
# hostpack one failed on that 2.032 and is now 3.0, 1.48x the largest sound
# reading and 5.4x under the smallest fault reading.
INT8_ENCODER_RATIO, INT8_HOSTPACK_RATIO = 1.1, 3.0
# the lse of rows 5 and 6 against their plain versions: f32 on both sides
# from the same bf16 scores, so only summation order differs (the CPU tests
# hold the plain versions to JAX's lse at 2e-5 and 3e-5)
LSE_ATOL = 1e-3
# the rebuilt flax init on the card against the same function on the CPU:
# the ulp contract it holds against JAX (tests/test_torch_flax_init.py)
INIT_ULP_BOUND = 4
# PipelineModels.tiny() on the card against the CPU: f32 with TF32 off,
# the BASELINE.json parity contract
TINY_ATOL = 1e-3
SHIPPED = ["audio_head", "face_cnn", "fusion", "landmark", "text_heads"]


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


FAILED = []  # bound checks of the main paths: every reading is printed first


def expect(cond: bool, msg: str) -> None:
    """A check whose failure is reported once the readings are all printed;
    the script then exits nonzero without the result lines."""
    if not cond:
        print(f"  FAILED: {msg}", flush=True)
        FAILED.append(msg)


def phase(label: str, t0: float, **fields) -> None:
    extra = " ".join(f"{k}={v}" for k, v in fields.items())
    print(f"[phase] {label} {time.perf_counter() - t0:.3f}s {extra}".rstrip(), flush=True)


def time_ms(fn, reps: int = 25, warmup: int = 3) -> float:
    """Median of ``reps`` CUDA-event timings of one call each."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
    return statistics.median(times)


def device_ms(fn, reps: int = 20) -> float:
    """Device time of one call: the durations of the kernels that ``reps``
    calls ran, from the profiler's trace, over ``reps``. Unlike
    :func:`time_ms` it leaves out the host's time between launches."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(
        getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0.0)
        for e in prof.key_averages()
        if e.device_type == torch.autograd.DeviceType.CUDA
    )
    check(us > 0, "the profiler recorded no device time")
    return us / reps / 1e3


def bound_ms(nbytes: float, **ops: float):
    """The least time for the work: the larger of the bytes over the memory
    rate and the operations, each type over its own peak, summed."""
    t_ops = sum(n / PEAK[kind] for kind, n in ops.items())
    t_bytes = nbytes / H100_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def rms(t) -> float:
    return t.float().square().mean().sqrt().item()


@contextlib.contextmanager
def swapped(module, **fns):
    """Swap module-level functions (kernel wrappers) for the block."""
    old = {name: getattr(module, name) for name in fns}
    for name, fn in fns.items():
        setattr(module, name, fn)
    try:
        yield
    finally:
        for name, fn in old.items():
            setattr(module, name, fn)


def main() -> int:
    t_all = time.perf_counter()
    # --- 1. the card -------------------------------------------------------
    t0 = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; nothing was run", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    dev = torch.device("cuda", 0)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}", flush=True)
    phase("device", t0, name=torch.cuda.get_device_name(0), count=torch.cuda.device_count())

    from msa_tpu_torch import flax_init
    from msa_tpu_torch.core.config import PipelineConfig, SystemConfig
    from msa_tpu_torch.models import transformer as T
    from msa_tpu_torch.ops import quant as Q
    from msa_tpu_torch.ops.kernels import attention as A
    from msa_tpu_torch.ops.kernels import build
    from msa_tpu_torch.ops.kernels import ffn as F
    from msa_tpu_torch.ops.kernels import quant as KQ
    from msa_tpu_torch.pipeline import graph as G

    counters = {
        "attention_block": A.attention_block,
        "ffn_fused": F.ffn_fused,
        "attention_block_int8": A.attention_block_int8,
        "ffn_fused_int8": F.ffn_fused_int8,
        "quantize_rows": KQ.quantize_rows,
        "packed_qkv_attention": A.packed_qkv_attention,
        "flash_attention": A.flash_attention,
    }

    def reset_counts():
        for fn in counters.values():
            fn.launches = 0

    def counts():
        return {name: fn.launches for name, fn in counters.items()}

    # --- 2. build ------------------------------------------------------------
    t0 = time.perf_counter()
    lib_path, log = build.build(verbose=True)
    build.library()
    for line in log.splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print("  ptxas:", line.strip().split("ptxas info    :")[-1].strip(), flush=True)
    phase("build", t0, library=lib_path.name)

    # --- 3. kernels against their plain versions --------------------------------
    t0 = time.perf_counter()
    g = torch.Generator(device=dev).manual_seed(0)
    bf16, f32 = torch.bfloat16, torch.float32
    dm, heads, dff = 768, 12, 3072

    def rand(*shape, scale=1.0, dtype=bf16):
        return (torch.randn(*shape, generator=g, device=dev) * scale).to(dtype)

    w_qkv, b_qkv = rand(3 * dm, dm, scale=dm**-0.5), rand(3 * dm, scale=0.02, dtype=f32)
    w_out, b_out = rand(dm, dm, scale=dm**-0.5), rand(dm, scale=0.02, dtype=f32)
    w1, b1 = rand(dff, dm, scale=dm**-0.5), rand(dff, scale=0.02)
    w2, b2 = rand(dm, dff, scale=dff**-0.5), rand(dm, scale=0.02)
    results = {}

    def compare(name, got, want):
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        scale = want.float().abs().max().item()
        bound = KERNEL_RTOL * scale + 1e-3
        check(bool(torch.isfinite(got).all()), f"{name}: non-finite output")
        check(err <= bound, f"{name}: max abs err {err:.4e} > bound {bound:.4e}")
        return err, err / scale, bound

    def timings(kernel, plain):
        """Device ms per call (profiler) of the kernel's wrapper and of its
        plain version, and the CUDA-event ms of one call each, which also
        holds the host's time to launch it."""
        return {
            "ms": device_ms(kernel),
            "plain_ms": device_ms(plain),
            "call_ms": time_ms(kernel),
            "plain_call_ms": time_ms(plain),
        }

    def record(name, err, keep, tm, bms, by):
        r = results.setdefault(name, {"max_abs_err": 0.0})
        r["max_abs_err"] = max(r["max_abs_err"], err)
        if keep:
            r.update(ms=tm["ms"], plain_ms=tm["plain_ms"], bound_ms=bms, bound_by=by)

    def timing_text(tm, bms, by):
        return (
            f"kernel_ms={tm['ms']:.4f} plain_ms={tm['plain_ms']:.4f} (device) "
            f"call_ms={tm['call_ms']:.4f} plain_call_ms={tm['plain_call_ms']:.4f} (CUDA events, one call) "
            f"bound_ms={bms:.5f} ({by})"
        )

    def report(label, err, rel, bnd, tm, bms, by):
        print(f"  {label}: max_abs_err={err:.4e} rel={rel:.3e} bound={bnd:.4e} {timing_text(tm, bms, by)}", flush=True)

    def attention_bytes(b, t, w_bytes):
        return 2 * 2 * b * t * dm + w_bytes + 4 * b * t

    for T_ in (32, 250, 512):
        b = 2
        x = rand(b, T_, dm)
        mask = torch.ones(b, T_, device=dev)
        mask[1] = 0.0  # a row with no valid key
        args = (x, w_qkv, b_qkv, w_out, b_out, mask, heads)
        got = A.attention_block(*args)
        err, rel, bnd = compare(f"attention_block T={T_}", got, A.attention_block_plain(*args))
        tm = timings(lambda: A.attention_block(*args), lambda: A.attention_block_plain(*args))
        flops = 2 * b * T_ * dm * 3 * dm + 2 * 2 * b * heads * T_ * T_ * (dm // heads) + 2 * b * T_ * dm * dm
        bms, by = bound_ms(attention_bytes(b, T_, 2 * 4 * dm * dm + 4 * 4 * dm), bf16=flops)
        report(f"attention_block B={b} T={T_} (T_pad={-(-T_ // 128) * 128})", err, rel, bnd, tm, bms, by)
        record("attention_block", err, T_ == 512, tm, bms, by)

    for n in (64, 500, 1024):  # B·T of text at bucket 32, audio, text at 512
        x = rand(n, dm)
        args = (x, w1, b1, w2, b2)
        got = F.ffn_fused(*args)
        err, rel, bnd = compare(f"ffn_fused N={n}", got, F.ffn_plain(*args))
        tm = timings(lambda: F.ffn_fused(*args), lambda: F.ffn_plain(*args))
        bms, by = bound_ms(2 * (2 * n * dm + 2 * dm * dff + dm + dff), bf16=2 * 2 * n * dm * dff)
        report(f"ffn_fused N={n}", err, rel, bnd, tm, bms, by)
        record("ffn_fused", err, n == 1024, tm, bms, by)

    # the row-quantize kernel, exactly: every x the int8 kernels quantize
    # (bf16 [B·T, 768], padded rows zero) and the FFN's f32 hidden tile
    for rows, cols, dtype in [(r, dm, bf16) for r in (64, 128, 250, 256, 500, 512, 1024)] + [
        (r, dff, f32) for r in (64, 128, 250, 500, 1024)
    ]:
        x = rand(rows, cols, dtype=dtype)
        x[rows // 2 :: 7] = 0  # rows of padding: the 1e-8 floor
        q, s = KQ.quantize_rows(x)
        pq, ps = Q.quantize_rows(x)
        torch.cuda.synchronize()
        n_codes, n_scales = (q != pq).sum().item(), (s != ps).sum().item()
        check(n_codes == 0 and n_scales == 0, f"quantize_rows {rows}x{cols} {dtype}: {n_codes} codes, {n_scales} scales differ")
        check(bool(torch.isfinite(s).all()), f"quantize_rows {rows}x{cols}: non-finite scale")
        tm = timings(lambda: KQ.quantize_rows(x), lambda: Q.quantize_rows(x))
        bms, by = bound_ms(rows * cols * (x.element_size() + 1) + 4 * rows, f32=2 * rows * cols)
        print(
            f"  quantize_rows {rows}x{cols} {str(dtype).split('.')[-1]}: codes and scales equal {timing_text(tm, bms, by)}",
            flush=True,
        )
        record("quantize_rows", 0.0, (rows, cols) == (1024, dff), tm, bms, by)

    # int8 weights from f32 masters, as the encoder layers derive them
    def int8_weight(out_f, in_f):
        w_q, s = Q.quantize_weight_axis(rand(out_f, in_f, scale=in_f**-0.5, dtype=f32), axis=1)
        return w_q, s[:, 0].contiguous()

    wqkv_q, s_qkv = int8_weight(3 * dm, dm)
    wout_q, s_out = int8_weight(dm, dm)
    w1_q, s1 = int8_weight(dff, dm)
    w2_q, s2 = int8_weight(dm, dff)
    b1f, b2f = b1.float(), b2.float()
    # B=2 at both buckets and audio; B=1 for the stream (audio, text at 128)
    for b, T_ in ((2, 32), (2, 250), (2, 512), (1, 250), (1, 128)):
        x = rand(b, T_, dm)
        mask = torch.ones(b, T_, device=dev)
        if b == 2:
            mask[1] = 0.0  # a row with no valid key
        args = (x, wqkv_q, s_qkv, b_qkv, wout_q, s_out, b_out, mask, heads)
        got = A.attention_block_int8(*args)
        err, rel, bnd = compare(f"attention_block_int8 B={b} T={T_}", got, A.attention_block_int8_plain(*args))
        tm = timings(lambda: A.attention_block_int8(*args), lambda: A.attention_block_int8_plain(*args))
        bms, by = bound_ms(
            attention_bytes(b, T_, 4 * dm * dm + 4 * 2 * 4 * dm),
            int8=2 * b * T_ * dm * 4 * dm,
            bf16=2 * 2 * b * heads * T_ * T_ * (dm // heads),
        )
        report(f"attention_block_int8 B={b} T={T_} (T_pad={-(-T_ // 128) * 128})", err, rel, bnd, tm, bms, by)
        record("attention_block_int8", err, (b, T_) == (2, 512), tm, bms, by)

    for n in (64, 128, 250, 500, 1024):  # text at 32 (B=2) and 128 (B=1), audio B=1 and 2, text at 512
        x = rand(n, dm)
        args = (x, w1_q, s1, b1f, w2_q, s2, b2f)
        got = F.ffn_fused_int8(*args)
        err, rel, bnd = compare(f"ffn_fused_int8 N={n}", got, F.ffn_int8_plain(*args))
        tm = timings(lambda: F.ffn_fused_int8(*args), lambda: F.ffn_int8_plain(*args))
        bms, by = bound_ms(2 * 2 * n * dm + 2 * dm * dff + 4 * 2 * (dm + dff), int8=2 * 2 * n * dm * dff)
        report(f"ffn_fused_int8 N={n}", err, rel, bnd, tm, bms, by)
        record("ffn_fused_int8", err, n == 1024, tm, bms, by)

    def sdpa(qkv, mask):
        """One PyTorch call computing the same attention (no lse; a row with
        no valid key averages the real keys only): the yardstick."""
        q, k, v = qkv.permute(2, 0, 3, 1, 4).unbind(0)  # [B, H, T, D] views
        bias = torch.where(mask > 0, 0.0, -1e9).to(qkv.dtype)[:, None, None, :]
        return torch.nn.functional.scaled_dot_product_attention(q, k, v, attn_mask=bias)

    # the attention-only kernels: row 5 at the custom-width encoder's shape
    # and the full-width training shape, row 6 at 15 s and 30 s of audio;
    # ragged T everywhere, and a row with no valid key where B=2
    for name, kernel, plain, main_shape, shapes in (
        ("packed_qkv_attention", A.packed_qkv_attention, A.packed_qkv_attention_plain, (2, 40, 4, 24),
         ((2, 40, 4, 24), (2, 512, 12, 64))),
        ("flash_attention", A.flash_attention, A.flash_attention_plain, (2, 749, 12, 64),
         ((2, 749, 12, 64), (1, 1499, 12, 64))),
    ):
        for b, T_, h, d in shapes:
            qkv = rand(b, T_, 3, h, d)
            mask = torch.ones(b, T_, device=dev)
            mask[0, T_ * 2 // 3 :] = 0.0  # a ragged valid length
            if b == 2:
                mask[1] = 0.0  # a row with no valid key
            (o, lse), (po, plse) = kernel(qkv, mask), plain(qkv, mask)
            err, rel, bnd = compare(f"{name} B={b} T={T_} H={h} D={d}", o, po)
            lse_err = (lse - plse).abs().max().item()
            check(bool(torch.isfinite(lse).all()) and lse_err <= LSE_ATOL, f"{name}: lse max abs err {lse_err:.3e} > {LSE_ATOL}")
            tm = timings(lambda: kernel(qkv, mask), lambda: plain(qkv, mask))
            lib_ms, lib_call_ms = device_ms(lambda: sdpa(qkv, mask)), time_ms(lambda: sdpa(qkv, mask))
            nbytes = 2 * 3 * b * T_ * h * d + 4 * b * T_ + 2 * b * T_ * h * d + 4 * b * h * T_
            bms, by = bound_ms(nbytes, bf16=4 * b * h * T_ * T_ * d)
            report(f"{name} B={b} T={T_} (T_pad={-(-T_ // 128) * 128}) H={h} D={d} lse_max_abs_err={lse_err:.3e}", err, rel, bnd, tm, bms, by)
            print(f"    sdpa (library) ms={lib_ms:.4f} (device) call_ms={lib_call_ms:.4f}", flush=True)
            record(name, err, (b, T_, h, d) == main_shape, tm, bms, by)
            if (b, T_, h, d) == main_shape:
                results[name]["library_ms"] = lib_ms
    phase("kernels", t0)

    # --- shared by the two recipes' main paths ----------------------------------
    rng = np.random.default_rng(0)

    def inputs(models, tokens: int, samples: int = SystemConfig().pipeline.segment_samples) -> "G.SegmentInputs":
        inp = G.SegmentInputs.zeros(models, 2, samples=samples, tokens=tokens)
        inp.frames = rng.integers(0, 256, size=inp.frames.shape, dtype=np.uint8)
        inp.audio = (0.1 * rng.standard_normal((2, samples))).astype(np.float32)
        inp.token_ids = rng.integers(1, models.text.cfg.vocab_size, size=(2, tokens)).astype(np.int32)
        inp.token_mask[0] = 1
        if tokens >= 512:
            inp.token_mask[1, :300] = 1
        else:
            inp.text_avail[1] = False  # an empty transcript: its mask row is all zero
        inp.completeness[:] = 0.8
        inp.relevance[:] = 0.1
        return inp

    def drive(label, pipe, runs, expect):
        """run_host over the buckets, counts set to 0 just before and read
        just after; each forward must launch ``expect`` (name → count)."""
        reset_counts()
        for tokens, inp in runs:
            t1 = time.perf_counter()
            before = counts()
            out, carry = pipe.run_host(inp)
            torch.cuda.synchronize()
            got = {k: v - before[k] for k, v in counts().items()}
            phase(f"{label}_run_host_bucket{tokens}", t1, **got)
            check(got == expect, f"{label} bucket {tokens}: launches {got}, expected {expect}")
            pack = out["hostpack"]
            check(tuple(pack.shape) == (2, 1715), f"hostpack shape {tuple(pack.shape)}")
            check(bool(torch.isfinite(pack).all()), f"{label} bucket {tokens}: non-finite hostpack")
            check(carry[0].shape == (478, 3), "landmark carry shape")
        return counts()

    def traced_run(pipeline, inp, patch=None):
        """The hostpack and each encoder's last hidden state (f32) of one
        run_host, with ``patch`` (name → function) swapped into the encoder
        module for the run."""
        got = {}
        ms = pipeline.models
        hooks = [
            enc.register_forward_hook(lambda _m, _i, out, key=key: got.__setitem__(key, out.float()))
            for key, enc in (("text", ms.text.encoder), ("audio", ms.audio.encoder))
        ]
        try:
            with swapped(T, **(patch or {})):
                got["hostpack"] = pipeline.run_host(inp)[0]["hostpack"]
        finally:
            for h in hooks:
                h.remove()
        return got

    def noise_ratios(k, p, r, faulty):
        """RMS errors against the f32 run r: the plain path's, and the kernel
        path's and each fault's over it."""
        e_p = rms(p - r)

        def over(e):
            return e / e_p if e_p else (0.0 if e == 0 else float("inf"))

        return e_p, over(rms(k - r)), {label: over(rms(f - r)) for label, f in faulty.items()}

    def vs_plain(label, runs, kern, plain, exact, faults, fault_key, enc_bound, pack_bound):
        """Hold the kernel path against the plain path, each encoder and each
        hostpack group, in units of the plain path's error against f32.
        ``kern``/``plain``/``exact`` and each fault are (pipeline, patch).
        → {encoder: RMS error of the kernel path against f32} per bucket."""
        errs = {}
        for tokens, inp in runs:
            k_run, p_run, r_run = (traced_run(p, inp, patch) for p, patch in (kern, plain, exact))
            f_runs = {name: traced_run(p, inp, patch) for name, (p, patch) in faults.items()}
            # a row with no valid key (the empty transcript) is left out: the
            # kernels spread its attention over the padded keys too, the
            # einsum path over the real ones only (as in JAX), and the graph
            # discards it
            rows = {"text": torch.as_tensor(inp.token_mask).bool().any(1), "audio": torch.ones(2, dtype=torch.bool)}
            for enc in ("text", "audio"):
                sel = rows[enc].to(dev)
                k, p, r = k_run[enc][sel], p_run[enc][sel], r_run[enc][sel]
                e_p, ratio, fault_ratio = noise_ratios(k, p, r, {n: f[enc][sel] for n, f in f_runs.items()})
                errs[(tokens, enc)] = rms(k - r)
                print(
                    f"  {label} bucket{tokens} {enc} encoder: rms(f32)={rms(r):.4e} rms_err_vs_f32 plain={e_p:.4e} "
                    f"kernel={rms(k - r):.4e} kernel/plain={ratio:.4f} "
                    f"kernel-vs-plain max={(k_run[enc] - p_run[enc]).abs().max().item():.4e} "
                    + " ".join(f"fault:{n}/plain={v:.4f}" for n, v in fault_ratio.items())
                    + f" bound={enc_bound}",
                    flush=True,
                )
                expect(ratio <= enc_bound, f"{label} bucket {tokens} {enc}: kernel/plain noise ratio {ratio:.4f} > {enc_bound}")
                expect(
                    fault_ratio[fault_key] > enc_bound,
                    f"{label} bucket {tokens} {enc}: the planted fault passes the check ({fault_ratio[fault_key]:.4f})",
                )
            for name, cols in G.PACK_SLICES.items():
                k, p, r = k_run["hostpack"][:, cols], p_run["hostpack"][:, cols], r_run["hostpack"][:, cols]
                e_p, ratio, fault_ratio = noise_ratios(k, p, r, {n: f["hostpack"][:, cols] for n, f in f_runs.items()})
                checked = e_p <= HOSTPACK_NOISE_SHARE * rms(r)
                bound = pack_bound * e_p + 1e-4 * rms(r)
                print(
                    f"  {label} bucket{tokens} hostpack {name:15s} rms(f32)={rms(r):.4e} rms_err_vs_f32 plain={e_p:.4e} "
                    f"kernel/plain={ratio:.4f} "
                    + " ".join(f"fault:{n}/plain={v:.4f}" for n, v in fault_ratio.items())
                    + (f" bound={pack_bound}" if checked else " not checked: plain-path noise over 10% of the values"),
                    flush=True,
                )
                if checked:
                    expect(rms(k - r) <= bound, f"{label} bucket {tokens} hostpack {name}: kernel path rms err {rms(k - r):.4e} > {bound:.4e}")
                if checked and e_p:  # downstream of an encoder
                    expect(
                        fault_ratio[fault_key] > pack_bound,
                        f"{label} bucket {tokens} hostpack {name}: the planted fault passes the check ({fault_ratio[fault_key]:.4f})",
                    )
        return errs

    def time_forwards(label, pipe, runs):
        for tokens, inp in runs:
            ms = time_ms(lambda: pipe.run_host(inp), reps=5, warmup=1)
            print(f"  {label} run_host B=2 bucket{tokens}: {ms:.3f} ms/forward (median of 5, CUDA events)", flush=True)

    zero = {name: 0 for name in counters}

    # --- 4. the bf16 recipe at full width ------------------------------------------
    t0 = time.perf_counter()
    models = G.PipelineModels.initialize(seed=0, quantize="none", device=dev)
    torch.cuda.synchronize()
    init_s = {"bf16": time.perf_counter() - t0}
    n_params = sum(p.numel() for m in models.modules() for p in m.parameters())
    phase("initialize_bf16", t0, params=n_params, loaded=",".join(sorted(models.loaded)))
    check(sorted(models.loaded) == SHIPPED, f"shipped checkpoints loaded: {sorted(models.loaded)}, expected {SHIPPED}")
    check(models.text.encoder.cfg.quantize == "none", "quantize='none' did not build the bf16 recipe")
    pipe = G.SegmentPipeline(models)
    runs = [(tokens, inputs(models, tokens)) for tokens in (512, 32)]
    bf16_counts = drive("bf16", pipe, runs, {**zero, "attention_block": 24, "ffn_fused": 24})

    t1 = time.perf_counter()
    plain = G.SegmentPipeline(models.with_encoders(attention_impl="einsum", ffn_impl="dense"))
    exact = G.SegmentPipeline(models.with_encoders(attention_impl="einsum", ffn_impl="dense", compute_dtype="float32"))
    real_attention = A.attention_block

    def skip_last_head(x, w_qkv, b_qkv, w_out, b_out, mask, heads):
        w = w_qkv.clone()
        w[-w.shape[1] // heads:] = 0  # the last head's V rows: its output stays 0
        return real_attention(x, w, b_qkv, w_out, b_out, mask, heads)

    def drop_last_key(x, w_qkv, b_qkv, w_out, b_out, mask, heads):
        m = mask.clone()
        m[:, -1] = 0  # the key-tile tail one short
        return real_attention(x, w_qkv, b_qkv, w_out, b_out, m, heads)

    bf16_errs = vs_plain(
        "bf16", runs, (pipe, None), (plain, None), (exact, None),
        {
            "skip_last_head": (pipe, {"attention_block": skip_last_head}),
            "drop_last_key": (pipe, {"attention_block": drop_last_key}),
        },
        "skip_last_head", ENCODER_NOISE_RATIO, HOSTPACK_NOISE_RATIO,
    )
    phase("bf16_vs_plain_path", t1)
    t1 = time.perf_counter()
    time_forwards("bf16", pipe, runs)
    phase("bf16_forward_timing", t1)
    phase("bf16_main_path", t0)
    del plain, exact

    # --- 5. the int8 recipe, the default ---------------------------------------------
    t0 = time.perf_counter()
    models8 = G.PipelineModels.initialize(seed=0, device=dev)
    torch.cuda.synchronize()
    init_s["int8"] = time.perf_counter() - t0
    phase("initialize_int8", t0, loaded=",".join(sorted(models8.loaded)))
    check(sorted(models8.loaded) == SHIPPED, f"shipped checkpoints loaded: {sorted(models8.loaded)}, expected {SHIPPED}")
    for enc in (models8.text.encoder, models8.audio.encoder):
        check(enc.cfg.quantize == "int8", f"initialize() chose quantize={enc.cfg.quantize!r}, expected the int8 default")
    pipe8 = G.SegmentPipeline(models8)
    runs8 = runs  # the same inputs as the bf16 recipe: its errors stand beside these
    int8_counts = drive(
        "int8", pipe8, runs8, {**zero, "attention_block_int8": 24, "ffn_fused_int8": 24, "quantize_rows": 96}
    )

    t1 = time.perf_counter()
    exact8 = G.SegmentPipeline(models8.with_encoders(attention_impl="einsum", ffn_impl="dense", compute_dtype="float32"))
    real_int8 = A.attention_block_int8

    def zero_last_head_v(x, w_qkv_q, s_qkv, b_qkv, w_out_q, s_out, b_out, mask, heads):
        w = w_qkv_q.clone()
        w[-w.shape[1] // heads:] = 0  # the last head's V rows, zero before quantization: codes 0
        return real_int8(x, w, s_qkv, b_qkv, w_out_q, s_out, b_out, mask, heads)

    int8_errs = vs_plain(
        "int8", runs8, (pipe8, None),
        (pipe8, {"attention_block_int8": A.attention_block_int8_plain, "ffn_fused_int8": F.ffn_int8_plain}),
        (exact8, None),
        {"zero_last_head_v": (pipe8, {"attention_block_int8": zero_last_head_v})},
        "zero_last_head_v", INT8_ENCODER_RATIO, INT8_HOSTPACK_RATIO,
    )
    for (tokens, enc), e8 in int8_errs.items():
        print(
            f"  bucket{tokens} {enc} encoder, kernel path's RMS error against f32 of the same masters: "
            f"int8={e8:.4e} bf16={bf16_errs[(tokens, enc)]:.4e} int8/bf16={e8 / bf16_errs[(tokens, enc)]:.3f}",
            flush=True,
        )
    phase("int8_vs_plain_path", t1)
    del exact8
    t1 = time.perf_counter()
    time_forwards("int8", pipe8, runs8)
    phase("int8_forward_timing", t1)
    phase("int8_main_path", t0)

    # --- 6. the init: the card's leaves against the same function on the CPU ---------------
    t0 = time.perf_counter()
    for recipe, secs in init_s.items():
        print(f"  PipelineModels.initialize() at full width, {recipe} recipe: {secs:.3f} s (the card, build excluded)", flush=True)

    def ulp_distance(a, b):
        def ordered(x):
            i = x.detach().float().contiguous().view(torch.int32).long()
            return torch.where(i < 0, -(i & 0x7FFFFFFF), i)

        return (ordered(a) - ordered(b)).abs()

    def card_leaf(module, path):
        return next((leaf, p) for leaf, p in flax_init.leaves(module) if leaf.path == path)

    cpu_qkv = None
    for label, module, seed, path in (
        ("text word_embeddings", models8.text, 3, ("embeddings", "word_embeddings", "embedding")),
        ("text layer_0 qkv", models8.text, 3, ("encoder", "layer_0", "attention", "qkv", "kernel")),
        ("audio layer_0 fc_in", models8.audio, 2, ("encoder", "layer_0", "fc_in", "kernel")),
    ):
        leaf, p = card_leaf(module, path)
        t1 = time.perf_counter()
        cpu = flax_init.to_port(leaf, flax_init.leaf_values(leaf, seed, "cpu"), p.cpu())
        d = ulp_distance(p.cpu(), cpu)
        print(
            f"  init leaf {label} {tuple(p.shape)}: card vs CPU max {int(d.max())} f32 ulp, "
            f"{int((d > 0).sum())} of {d.numel()} elements differ (CPU {time.perf_counter() - t1:.2f} s)",
            flush=True,
        )
        check(int(d.max()) <= INIT_ULP_BOUND, f"init leaf {label}: {int(d.max())} ulp between the card and the CPU")
        if label == "text layer_0 qkv":
            cpu_qkv = cpu
    q_cpu, s_cpu = Q.quantize_weight_axis(cpu_qkv, axis=1)
    layer0 = models8.text.encoder.layer_0.attention
    n_codes = int((layer0.w_qkv_q.cpu() != q_cpu).sum())
    n_scales = int((layer0.s_qkv.cpu() != s_cpu[:, 0]).sum())
    print(f"  int8 codes of text layer_0 qkv, card vs CPU init: {n_codes} of {q_cpu.numel()} codes and {n_scales} scales differ", flush=True)
    check(n_codes == 0 and n_scales == 0, f"text layer_0 qkv: {n_codes} int8 codes, {n_scales} scales differ from the CPU init")
    phase("init_vs_cpu", t0, initialize_bf16_s=f"{init_s['bf16']:.3f}", initialize_int8_s=f"{init_s['int8']:.3f}")

    # --- 7. run_stream at B=1 -------------------------------------------------------------
    t0 = time.perf_counter()
    s = models8.landmark.cfg.frame_size
    tokens = 128

    def window():
        mask = np.zeros(tokens, np.int32)
        mask[:90] = 1
        return dict(
            frames_u8=rng.integers(0, 256, size=(s, s, 3), dtype=np.uint8),
            audio_i16=(3000 * rng.standard_normal(80_000)).astype(np.int16),
            token_ids=rng.integers(1, models8.text.cfg.vocab_size, size=tokens).astype(np.int32),
            token_mask=mask,
            face_avail=True,
            audio_avail=True,
            text_avail=True,
            completeness=0.7,
            relevance=0.2,
        )

    w = window()
    packed = G.pack_stream_inputs(**w)
    carry0 = (torch.zeros(478, 3, device=dev), torch.tensor(False, device=dev))
    reset_counts()
    out_s, carry_s = pipe8.run_stream(packed, *carry0)
    torch.cuda.synchronize()
    stream_counts = counts()
    phase("run_stream_window", t0, bytes=packed.nbytes, **stream_counts)
    check(
        stream_counts == {**zero, "attention_block_int8": 24, "ffn_fused_int8": 24, "quantize_rows": 96},
        f"run_stream launches {stream_counts}, expected 24 of each int8 kernel",
    )
    host_inp = G.SegmentInputs(
        frames=w["frames_u8"][None],
        audio=w["audio_i16"][None],
        token_ids=w["token_ids"][None],
        token_mask=w["token_mask"][None],
        face_avail=np.array([True]),
        audio_avail=np.array([True]),
        text_avail=np.array([True]),
        completeness=np.array([w["completeness"]], np.float32),
        relevance=np.array([w["relevance"]], np.float32),
        prev_landmarks=carry0[0],
        has_prev=carry0[1],
    )
    out_h, carry_h = pipe8.run_host(host_inp)
    torch.cuda.synchronize()
    diff = (out_s["hostpack"] - out_h["hostpack"]).abs().max().item()
    print(f"  run_stream vs run_host, one window at bucket {tokens}: max abs diff {diff:.3e} (must be 0)", flush=True)
    check(tuple(out_s["hostpack"].shape) == (1, 1715), f"run_stream hostpack shape {tuple(out_s['hostpack'].shape)}")
    check(bool(torch.isfinite(out_s["hostpack"]).all()), "run_stream: non-finite hostpack")
    check(torch.equal(out_s["hostpack"], out_h["hostpack"]), f"run_stream differs from run_host by {diff:.3e}")
    check(carry_s[0].device == dev and tuple(carry_s[0].shape) == (478, 3), "run_stream carry: landmarks")
    check(torch.equal(carry_s[0], carry_h[0]) and bool(carry_s[1]) == bool(carry_h[1]), "run_stream carry differs from run_host's")
    # the next window takes the carry as it stands on the device
    w2 = window()
    reset_counts()
    out_2, carry_2 = pipe8.run_stream(G.pack_stream_inputs(**w2), *carry_s)
    torch.cuda.synchronize()
    c2 = counts()
    check(c2["attention_block_int8"] == 24 and c2["ffn_fused_int8"] == 24, f"second window launches {c2}")
    check(bool(torch.isfinite(out_2["hostpack"]).all()), "run_stream, second window: non-finite hostpack")
    packs = [G.pack_stream_inputs(**window()) for _ in range(4)]
    state = {"carry": carry_2, "i": 0}

    def stream_step():
        state["i"] = (state["i"] + 1) % len(packs)
        state["carry"] = pipe8.run_stream(packs[state["i"]], *state["carry"])[1]

    ms = time_ms(stream_step, reps=10, warmup=2)
    print(f"  run_stream B=1 bucket{tokens}: {ms:.3f} ms/window (median of 10, CUDA events; upload included)", flush=True)
    phase("run_stream", t0)

    # --- 8. 15 s segments at full width: the flash kernel in every audio layer --------------
    t0 = time.perf_counter()
    long_cfg = SystemConfig(pipeline=PipelineConfig(segment_samples=240_000))
    long_runs = [(512, inputs(models, 512, long_cfg.pipeline.segment_samples))]
    real_flash = A.flash_attention

    def flash_skip_last_head(qkv, mask):
        q = qkv.clone()
        q[:, :, 2, -1] = 0  # the last head's V: its output stays 0
        return real_flash(q, mask)

    long_counts = {}
    for label, mods, expect_counts, plain_of, fault_key, fault, enc_bound, pack_bound in (
        (
            "long_bf16", models, {**zero, "attention_block": 12, "flash_attention": 12, "ffn_fused": 24},
            lambda pipe: (G.SegmentPipeline(mods.with_encoders(attention_impl="einsum", ffn_impl="dense"), long_cfg), None),
            "skip_last_head", {"attention_block": skip_last_head, "flash_attention": flash_skip_last_head},
            ENCODER_NOISE_RATIO, HOSTPACK_NOISE_RATIO,
        ),
        (
            "long_int8", models8,
            {**zero, "attention_block_int8": 12, "flash_attention": 12, "ffn_fused_int8": 24, "quantize_rows": 72},
            lambda pipe: (pipe, {
                "attention_block_int8": A.attention_block_int8_plain,
                "ffn_fused_int8": F.ffn_int8_plain,
                "flash_attention": A.flash_attention_plain,
            }),
            "zero_last_head_v", {"attention_block_int8": zero_last_head_v, "flash_attention": flash_skip_last_head},
            INT8_ENCODER_RATIO, INT8_HOSTPACK_RATIO,
        ),
    ):
        t1 = time.perf_counter()
        pipe_l = G.SegmentPipeline(mods, long_cfg)
        got = drive(label, pipe_l, long_runs, expect_counts)
        long_counts = {k: long_counts.get(k, 0) + v for k, v in got.items()}
        exact_l = G.SegmentPipeline(mods.with_encoders(attention_impl="einsum", ffn_impl="dense", compute_dtype="float32"), long_cfg)
        vs_plain(label, long_runs, (pipe_l, None), plain_of(pipe_l), (exact_l, None), {fault_key: (pipe_l, fault)}, fault_key, enc_bound, pack_bound)
        del exact_l
        time_forwards(label, pipe_l, long_runs)
        dev_ms = device_ms(lambda: pipe_l.run_host(long_runs[0][1]), reps=3)
        print(f"  {label} run_host B=2 bucket512 at 15 s: {dev_ms:.3f} ms of device time per forward (profiler)", flush=True)
        phase(label, t1)
    phase("long_segments", t0)

    # --- 9. a custom-width encoder (row 5), then PipelineModels.tiny() --------------------------
    t0 = time.perf_counter()
    x_c = rand(2, 40, 96)
    mask_c = torch.ones(2, 40, device=dev)
    mask_c[1, 25:] = 0.0
    custom_counts = {name: 0 for name in counters}
    for quantize in ("none", "int8"):
        cfg = T.EncoderConfig(
            num_layers=2, d_model=96, num_heads=4, d_ff=256, compute_dtype="bfloat16",
            attention_impl="kernel", ffn_impl="kernel", quantize=quantize,
        )
        with torch.device(dev):
            enc = flax_init.init_module_(T.TransformerEncoder(cfg).eval().requires_grad_(False), 0)
        reset_counts()
        with torch.inference_mode():
            got = enc(x_c, mask_c)
        torch.cuda.synchronize()
        c = counts()
        custom_counts = {k: custom_counts[k] + v for k, v in c.items()}
        check(c == {**zero, "packed_qkv_attention": 2}, f"custom-width encoder ({quantize}): launches {c}, expected 2 packed_qkv_attention")
        with swapped(T, packed_qkv_attention=A.packed_qkv_attention_plain), torch.inference_mode():
            want = enc(x_c, mask_c)
        err, rel, bnd = compare(f"custom-width encoder ({quantize})", got, want)
        print(f"  custom-width encoder d_model 96, quantize={quantize}: launches {c} vs plain path max_abs_err={err:.4e} bound={bnd:.4e}", flush=True)

    tiny_card = G.PipelineModels.tiny(seed=0, device=dev)
    tiny_cpu = G.PipelineModels.tiny(seed=0, device="cpu")
    worst = max(
        int(ulp_distance(a.cpu(), b).max())
        for mc, mh in zip(tiny_card.modules(), tiny_cpu.modules())
        for a, b in zip(mc.parameters(), mh.parameters())
    )
    inp_t = G.SegmentInputs.zeros(tiny_card, 2, samples=8000, tokens=32)
    inp_t.frames = rng.integers(0, 256, size=inp_t.frames.shape, dtype=np.uint8)
    inp_t.audio = (0.1 * rng.standard_normal((2, 8000))).astype(np.float32)
    inp_t.token_ids = rng.integers(1, tiny_card.text.cfg.vocab_size, size=(2, 32)).astype(np.int32)
    inp_t.token_mask[0] = 1
    inp_t.token_mask[1, :20] = 1
    reset_counts()
    out_card, _ = G.SegmentPipeline(tiny_card).run_host(inp_t)
    torch.cuda.synchronize()
    c = counts()
    check(c == zero, f"PipelineModels.tiny() launched kernels: {c}")
    out_cpu, _ = G.SegmentPipeline(tiny_cpu).run_host(inp_t)
    tiny_err = (out_card["hostpack"].cpu() - out_cpu["hostpack"]).abs().max().item()
    print(
        f"  PipelineModels.tiny() on the card: params vs CPU max {worst} f32 ulp; launches {sum(c.values())}; "
        f"hostpack {tuple(out_card['hostpack'].shape)} vs CPU max abs diff {tiny_err:.3e} (bound {TINY_ATOL})",
        flush=True,
    )
    check(worst <= INIT_ULP_BOUND, f"tiny(): parameters {worst} ulp from the CPU's")
    check(bool(torch.isfinite(out_card["hostpack"]).all()) and tiny_err <= TINY_ATOL, f"tiny(): hostpack {tiny_err:.3e} from the CPU's")
    phase("custom_width_and_tiny", t0)

    kernels = [
        {
            "name": name,
            "route": "cuda",
            "source": source,
            "replaces": replaces,
            "launches": launch_counts[name],
            "library_ms": None,
            **results[name],
        }
        for name, source, replaces, launch_counts in (
            ("attention_block", "msa_tpu_torch/csrc/attention.cu", "msa_tpu/ops/pallas/attention.py:819", bf16_counts),
            ("ffn_fused", "msa_tpu_torch/csrc/ffn.cu", "msa_tpu/ops/pallas/ffn.py:89", bf16_counts),
            ("attention_block_int8", "msa_tpu_torch/csrc/attention.cu", "msa_tpu/ops/pallas/attention.py:779", int8_counts),
            ("ffn_fused_int8", "msa_tpu_torch/csrc/ffn.cu", "msa_tpu/ops/pallas/ffn.py:166", int8_counts),
            ("quantize_rows", "msa_tpu_torch/csrc/quant.cu", "msa_tpu/ops/quant.py:47", int8_counts),
            ("packed_qkv_attention", "msa_tpu_torch/csrc/attention_packed.cu", "msa_tpu/ops/pallas/attention.py:489", custom_counts),
            ("flash_attention", "msa_tpu_torch/csrc/attention_flash.cu", "msa_tpu/ops/pallas/attention.py:948", long_counts),
        )
    ]
    phase("total", t_all)
    if FAILED:
        print(f"chip_smoke: {len(FAILED)} check(s) failed:", *FAILED, sep="\n  ", file=sys.stderr)
        return 1
    print(json.dumps({"kernels": kernels}), flush=True)
    print(
        json.dumps(
            {
                "ok": True,
                "device": {
                    "platform": "gpu",
                    "kind": torch.cuda.get_device_name(0),
                    "count": torch.cuda.device_count(),
                },
            }
        ),
        flush=True,
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
