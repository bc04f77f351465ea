"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (H100).

    python3 chip_smoke.py

Phases, one line each with its seconds:
  1. require CUDA; print the card's name and power limit;
  2. build the hand-written kernels (one nvcc call, from msa_tpu_torch/csrc);
  3. hold each kernel against its plain PyTorch version on the card at the
     main path's shapes (bf16), and time both with CUDA events;
  4. drive the main path at full width: PipelineModels.initialize(
     quantize="none") → SegmentPipeline.run_host at B=2, at the 512-token and
     the 32-token bucket; check that every shipped checkpoint loaded, the
     [2, 1715] hostpack, the kernels' launch counts (24 each per forward:
     12 text + 12 audio layers), and each encoder's last hidden state and
     each hostpack column group against the port's plain bf16 path (einsum
     attention, dense FFN) on the same weights and inputs, with an f32 run
     of that path as the yardstick of bf16 noise; a planted fault shows
     that the checks can fail.
The line before the last is a JSON object with each kernel's numbers; the
last line is the JSON contract line. Any failure exits nonzero.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

H100_BF16_FLOPS = 989e12  # dense tensor-core peak, SXM, 700 W
H100_BYTES_PER_S = 3.35e12  # HBM3

# bf16 bound for a kernel against its plain version: both round at the same
# points, so only f32 summation order can flip a last bit, which the output
# projection carries; 5 bf16 steps (2^-8) of the largest magnitude, + 1e-3.
KERNEL_RTOL = 5 * 2.0**-8
# each encoder's last hidden state on the main path: the kernel path and
# the port's plain bf16 path (einsum attention, dense FFN) round at
# different points, and a random 12-layer trunk carries each difference
# forward, so the bound is relative to bf16 noise: against an f32 run of the
# same weights, the kernel path's RMS error may be at most
# ENCODER_NOISE_RATIO times the plain bf16 path's. On an H100 (PERF.md) a
# sound run read at most 0.989, and a planted fault (the last head's output
# left at zero, as a head loop one short would) read at least 87; the smoke
# checks that this fault still fails the bound.
ENCODER_NOISE_RATIO = 1.25
# the hostpack, column group by column group, by the same measure; a group
# is checked where the plain bf16 path's RMS error is at most
# HOSTPACK_NOISE_SHARE of the group's RMS (the head probabilities on a
# random trunk are noise as large as their values). On an H100 (PERF.md) a
# sound run read at most 1.378 in a checked group, and the planted head
# fault at least 29.3 in a checked group downstream of an encoder.
HOSTPACK_NOISE_RATIO, HOSTPACK_NOISE_SHARE = 2.0, 0.1
SHIPPED = ["audio_head", "face_cnn", "fusion", "landmark", "text_heads"]


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


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


def bound_ms(flops: float, nbytes: float):
    t_ops, t_bytes = flops / H100_BF16_FLOPS, nbytes / H100_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def device() -> torch.device:
    return torch.device("cuda", 0)


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
    dev = device()
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}", flush=True)
    phase("device", t0, name=torch.cuda.get_device_name(0), count=torch.cuda.device_count())

    from msa_tpu_torch.ops.kernels import attention as A
    from msa_tpu_torch.ops.kernels import build
    from msa_tpu_torch.ops.kernels import ffn as F
    from msa_tpu_torch.pipeline import graph as G

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
    bf16 = torch.bfloat16
    dm, heads, dff = 768, 12, 3072

    def rand(*shape, scale=1.0, dtype=bf16):
        return (torch.randn(*shape, generator=g, device=dev) * scale).to(dtype)

    w_qkv, b_qkv = rand(3 * dm, dm, scale=dm**-0.5), rand(3 * dm, scale=0.02, dtype=torch.float32)
    w_out, b_out = rand(dm, dm, scale=dm**-0.5), rand(dm, scale=0.02, dtype=torch.float32)
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

    for T in (32, 250, 512):
        b = 2
        x = rand(b, T, dm)
        mask = torch.ones(b, T, device=dev)
        mask[1] = 0.0  # a row with no valid key
        args = (x, w_qkv, b_qkv, w_out, b_out, mask, heads)
        got = A.attention_block(*args)
        err, rel, bnd = compare(f"attention_block T={T}", got, A.attention_block_plain(*args))
        ms = time_ms(lambda: A.attention_block(*args))
        plain_ms = time_ms(lambda: A.attention_block_plain(*args))
        flops = 2 * b * T * dm * 3 * dm + 2 * 2 * b * heads * T * T * (dm // heads) + 2 * b * T * dm * dm
        nbytes = 2 * (2 * b * T * dm + 4 * dm * dm) + 4 * (4 * dm + b * T)
        bms, by = bound_ms(flops, nbytes)
        print(
            f"  attention_block B={b} T={T} (T_pad={-(-T // 128) * 128}): max_abs_err={err:.4e} rel={rel:.3e} "
            f"bound={bnd:.4e} kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} bound_ms={bms:.5f} ({by})",
            flush=True,
        )
        r = results.setdefault("attention_block", {"max_abs_err": 0.0})
        r["max_abs_err"] = max(r["max_abs_err"], err)
        if T == 512:
            r.update(ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by)

    for n in (64, 500, 1024):  # B·T of text at bucket 32, audio, text at 512
        x = rand(n, dm)
        args = (x, w1, b1, w2, b2)
        got = F.ffn_fused(*args)
        err, rel, bnd = compare(f"ffn_fused N={n}", got, F.ffn_plain(*args))
        ms = time_ms(lambda: F.ffn_fused(*args))
        plain_ms = time_ms(lambda: F.ffn_plain(*args))
        flops = 2 * 2 * n * dm * dff
        nbytes = 2 * (2 * n * dm + 2 * dm * dff + dm + dff)
        bms, by = bound_ms(flops, nbytes)
        print(
            f"  ffn_fused N={n}: max_abs_err={err:.4e} rel={rel:.3e} bound={bnd:.4e} "
            f"kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} bound_ms={bms:.5f} ({by})",
            flush=True,
        )
        r = results.setdefault("ffn_fused", {"max_abs_err": 0.0})
        r["max_abs_err"] = max(r["max_abs_err"], err)
        if n == 1024:
            r.update(ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by)
    phase("kernels", t0)

    # --- 4. the main path at full width ------------------------------------------
    t0 = time.perf_counter()
    models = G.PipelineModels.initialize(seed=0, quantize="none", device=dev)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for m in models.modules() for p in m.parameters())
    phase("initialize", t0, params=n_params, loaded=",".join(sorted(models.loaded)))
    check(sorted(models.loaded) == SHIPPED, f"shipped checkpoints loaded: {sorted(models.loaded)}, expected {SHIPPED}")

    pipe = G.SegmentPipeline(models)
    rng = np.random.default_rng(0)

    def inputs(tokens: int) -> "G.SegmentInputs":
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

    runs = [(tokens, inputs(tokens)) for tokens in (512, 32)]
    A.attention_block.launches = 0
    F.ffn_fused.launches = 0
    outs = []
    for tokens, inp in runs:
        t1 = time.perf_counter()
        a0, f0 = A.attention_block.launches, F.ffn_fused.launches
        out, carry = pipe.run_host(inp)
        torch.cuda.synchronize()
        da, df = A.attention_block.launches - a0, F.ffn_fused.launches - f0
        outs.append(out["hostpack"])
        phase(f"run_host_bucket{tokens}", t1, attention_block=da, ffn_fused=df)
        check(da == 24 and df == 24, f"bucket {tokens}: launches attention_block={da} ffn_fused={df}, expected 24 each")
    launches = {"attention_block": A.attention_block.launches, "ffn_fused": F.ffn_fused.launches}

    for (tokens, inp), pack in zip(runs, outs):
        check(tuple(pack.shape) == (2, 1715), f"hostpack shape {tuple(pack.shape)}")
        check(bool(torch.isfinite(pack).all()), f"bucket {tokens}: non-finite hostpack")
        check(carry[0].shape == (478, 3), "landmark carry shape")

    t1 = time.perf_counter()
    plain = G.SegmentPipeline(models.with_encoders(attention_impl="einsum", ffn_impl="dense"))
    exact = G.SegmentPipeline(
        models.with_encoders(attention_impl="einsum", ffn_impl="dense", compute_dtype="float32")
    )

    def traced_run(pipeline, inp):
        """The hostpack and each encoder's last hidden state (f32) of one run_host."""
        got = {}
        ms = pipeline.models
        hooks = [
            enc.register_forward_hook(lambda _m, _i, out, key=key: got.__setitem__(key, out.float()))
            for key, enc in (("text", ms.text.encoder), ("audio", ms.audio.encoder))
        ]
        try:
            got["hostpack"] = pipeline.run_host(inp)[0]["hostpack"]
        finally:
            for h in hooks:
                h.remove()
        return got

    def skip_last_head(x, w_qkv, b_qkv, w_out, b_out, mask, heads):
        w = w_qkv.clone()
        w[-w.shape[1] // heads:] = 0  # the last head's V rows: its output stays 0
        return real_attention(x, w, b_qkv, w_out, b_out, mask, heads)

    def drop_last_key(x, w_qkv, b_qkv, w_out, b_out, mask, heads):
        m = mask.clone()
        m[:, -1] = 0  # the key-tile tail one short
        return real_attention(x, w_qkv, b_qkv, w_out, b_out, m, heads)

    def rms(t):
        return t.square().mean().sqrt().item()

    from msa_tpu_torch.models import transformer as T

    def noise_ratios(k, p, r, faulty):
        """RMS errors against the f32 run r: the plain path's, and the kernel
        path's and each fault's over it."""
        e_p = rms(p - r)

        def over(e):
            return e / e_p if e_p else (0.0 if e == 0 else float("inf"))

        return e_p, over(rms(k - r)), {label: over(rms(f - r)) for label, f in faulty.items()}

    real_attention = T.attention_block
    for tokens, inp in runs:
        kern, ref, f32 = (traced_run(p, inp) for p in (pipe, plain, exact))
        faults = {}
        for label, fault in (("skip_last_head", skip_last_head), ("drop_last_key", drop_last_key)):
            T.attention_block = fault
            try:
                faults[label] = traced_run(pipe, inp)
            finally:
                T.attention_block = real_attention
        # a row with no valid key (the empty transcript) is left out: the
        # kernel spreads its attention over the padded keys too, the plain
        # path over the real ones only (as in JAX), and the graph discards it
        rows = {"text": torch.as_tensor(inp.token_mask).bool().any(1), "audio": torch.ones(2, dtype=torch.bool)}
        for enc in ("text", "audio"):
            sel = rows[enc].to(dev)
            k, p, r = kern[enc][sel], ref[enc][sel], f32[enc][sel]
            e_p, ratio, fault_ratio = noise_ratios(k, p, r, {label: f[enc][sel] for label, f in faults.items()})
            print(
                f"  bucket{tokens} {enc} encoder: rms(f32)={rms(r):.4e} rms_err_vs_f32 plain_bf16={e_p:.4e} "
                f"kernel/plain={ratio:.4f} kernel-vs-plain max={(k - p).abs().max().item():.4e} "
                + " ".join(f"fault:{label}/plain={v:.4f}" for label, v in fault_ratio.items())
                + f" bound={ENCODER_NOISE_RATIO}",
                flush=True,
            )
            check(ratio <= ENCODER_NOISE_RATIO, f"bucket {tokens} {enc}: kernel/plain noise ratio {ratio:.4f} > {ENCODER_NOISE_RATIO}")
            check(
                fault_ratio["skip_last_head"] > ENCODER_NOISE_RATIO,
                f"bucket {tokens} {enc}: the planted fault passes the check ({fault_ratio['skip_last_head']:.4f})",
            )
        for name, cols in G.PACK_SLICES.items():
            k, p, r = kern["hostpack"][:, cols], ref["hostpack"][:, cols], f32["hostpack"][:, cols]
            e_p, ratio, fault_ratio = noise_ratios(k, p, r, {label: f["hostpack"][:, cols] for label, f in faults.items()})
            checked = e_p <= HOSTPACK_NOISE_SHARE * rms(r)
            bound = HOSTPACK_NOISE_RATIO * e_p + 1e-4 * rms(r)
            print(
                f"  bucket{tokens} hostpack {name:15s} rms(f32)={rms(r):.4e} rms_err_vs_f32 plain_bf16={e_p:.4e} "
                f"kernel/plain={ratio:.4f} "
                + " ".join(f"fault:{label}/plain={v:.4f}" for label, v in fault_ratio.items())
                + (f" bound={HOSTPACK_NOISE_RATIO}" if checked else " not checked: bf16 noise over 10% of the values"),
                flush=True,
            )
            if checked:
                check(rms(k - r) <= bound, f"bucket {tokens} hostpack {name}: kernel path rms err {rms(k - r):.4e} > {bound:.4e}")
            if checked and e_p:  # downstream of an encoder
                check(
                    fault_ratio["skip_last_head"] > HOSTPACK_NOISE_RATIO,
                    f"bucket {tokens} hostpack {name}: the planted fault passes the check ({fault_ratio['skip_last_head']:.4f})",
                )
    phase("vs_plain_path", t1)

    t1 = time.perf_counter()
    for tokens, inp in runs:
        def fwd():
            pipe.run_host(inp)

        ms = time_ms(fwd, reps=5, warmup=1)
        print(f"  run_host B=2 bucket{tokens}: {ms:.3f} ms/forward (median of 5, CUDA events)", flush=True)
    phase("forward_timing", t1)
    phase("main_path", t0)

    kernels = [
        {
            "name": "attention_block",
            "route": "cuda",
            "source": "msa_tpu_torch/csrc/attention.cu",
            "replaces": "msa_tpu/ops/pallas/attention.py:819",
            "launches": launches["attention_block"],
            "library_ms": None,
            **results["attention_block"],
        },
        {
            "name": "ffn_fused",
            "route": "cuda",
            "source": "msa_tpu_torch/csrc/ffn.cu",
            "replaces": "msa_tpu/ops/pallas/ffn.py:89",
            "launches": launches["ffn_fused"],
            "library_ms": None,
            **results["ffn_fused"],
        },
    ]
    phase("total", t_all)
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
