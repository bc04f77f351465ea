"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (H100).

    python3 chip_smoke.py

Phases, one line each with its seconds:
  1. require CUDA; print the card's name and power limit;
  2. build the hand-written kernels (one nvcc call, from msa_tpu_torch/csrc);
  3. hold each kernel against its plain PyTorch version on the card at the
     main paths' shapes, and time both with CUDA events: the bf16
     attention_block and ffn_fused, the row-quantize kernel (exactly: codes
     and scales equal), attention_block_int8 and ffn_fused_int8;
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
  6. run_stream at B=1: one packed window at the 128-token bucket, equal to
     run_host on the same window bit for bit, with its carry; 24 launches
     of each int8 kernel per window;
  7. timings: run_host per forward (both recipes, both buckets) and
     run_stream per window.
Counts are set to 0 just before each path runs and read just after.
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
    phase("kernels", t0)

    # --- shared by the two recipes' main paths ----------------------------------
    rng = np.random.default_rng(0)

    def inputs(models, tokens: int) -> "G.SegmentInputs":
        inp = G.SegmentInputs.zeros(models, 2, samples=80_000, tokens=tokens)
        inp.frames = rng.integers(0, 256, size=inp.frames.shape, dtype=np.uint8)
        inp.audio = (0.1 * rng.standard_normal((2, 80_000))).astype(np.float32)
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

    # --- 6. run_stream at B=1 -------------------------------------------------------------
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
