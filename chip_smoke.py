#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py          # from the root of a checkout

1. Builds the port's Hopper kernels from ``src/repro_torch/kernels/csrc``
   (into ``build/kernels/``).
2. Kernel phase: each kernel at the decode path's shapes (B=4, H=9, KV=3,
   Dh=64, D=576, a 513-slot cache after a 512-token prompt; prefill over
   512 tokens), in bf16 and f32, against its plain PyTorch version on the
   same inputs (tolerance 2e-4 in f32, 3e-2 in bf16, as
   tests/test_kernels.py). Times: the kernel, its plain version and, where
   one PyTorch call computes the same function, that call (a yardstick the
   port never uses), each the median of CUDA-event-timed batches of
   launches; the bound is the larger of bytes over 3.35 TB/s and
   operations over the card's peak for their type.
3. Serving phase (the main path): two full-width smollm-135m staged decode
   tasks (HP and LP; 4 stages, batch 4, prompt 512; random weights from
   seed 0) built with ``staged_lm_taskspec`` and served in real time by
   ``ServerConfig.realtime()`` (2 contexts x 2 streams, oversubscription
   2.0, n_units = the card's SM count). Kernel launch counts are reset
   just before and read just after.
4. Output checks: a served task's payload chain gives finite logits of the
   expected shape that match the unstaged ``decode_step``, and a cut-depth
   f32 model run on the card through the kernels matches the same model
   run on the CPU through the plain versions.

It fails (non-zero exit, no result line) without a CUDA device, outside a
checkout of the repo, or when a kernel is out of tolerance or unlaunched,
a plain version ran on a CUDA tensor during the serving phase, a worker
caught an exception, no HP job completed, or an output check failed. The
last line is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12             # H100 SXM data sheet
PEAK_FLOPS = {"bfloat16": 989e12,     # dense tensor-core bf16
              "float32": 67e12}       # f32 outside the tensor cores
ELEMENTWISE_FLOPS = 67e12             # norms compute in f32 on CUDA cores
B, H, KV, DH, D, PROMPT = 4, 9, 3, 64, 576, 512
N_STAGES, HORIZON_MS, JPS = 4, 3000.0, 5.0


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def gpu_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError) as e:
        return f"nvidia-smi unavailable ({e!r})"


def cuda_ms(torch, fn, reps: int = 30, inner: int = 10) -> float:
    """Eager time per call: median over ``reps`` batches of the mean of
    ``inner`` back-to-back calls, timed with CUDA events after warm-up. At
    these sizes it is the host's enqueue rate, not the device's."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(inner):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / inner)
    return statistics.median(times)


def graph_ms(torch, fn, reps: int = 30, inner: int = 20) -> float:
    """Device time per call: ``inner`` calls captured once in a CUDA graph,
    replayed ``reps`` times under CUDA events; median replay / ``inner``.
    The host's per-call cost is out of the picture."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(inner):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / inner)
    return statistics.median(times)


def bound(nbytes: float, ops: float, peak: float):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / peak
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def kernel_cases(torch, F, dtype):
    """(name, kernel call, plain call, library call | None, bytes, ops,
    peak) at the main path's shapes."""
    from repro_torch.kernels import decode_attention as dec
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import rmsnorm as rms

    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(0)

    def rand(*shape):
        return torch.randn(shape, generator=g, device=dev).to(dtype)

    dname = str(dtype).replace("torch.", "")
    x, r, w = rand(B, 1, D), rand(B, 1, D), rand(D)
    cache_k, cache_v = rand(B, PROMPT + 1, KV, DH), rand(B, PROMPT + 1, KV, DH)
    k, v = cache_k.transpose(1, 2), cache_v.transpose(1, 2)   # the model's view
    kv_pos = torch.arange(PROMPT + 1, dtype=torch.int32, device=dev)
    q_pos = torch.full((B,), PROMPT, dtype=torch.int32, device=dev)
    q1 = rand(B, H, DH)
    mask = ((kv_pos[None] >= 0) & (kv_pos[None] <= q_pos[:, None]))[:, None,
                                                                     None]
    qp, kp, vp = (rand(B, PROMPT, n, DH).transpose(1, 2) for n in (H, KV, KV))
    s = PROMPT + 1
    rms_ops = 4 * B * D
    dec_ops = 4 * B * H * s * DH
    fa_ops = 4 * B * H * DH * PROMPT * (PROMPT + 1) // 2

    def sdpa(q, kk, vv, **kw):
        return F.scaled_dot_product_attention(q, kk, vv, enable_gqa=True,
                                              **kw)
    return [
        ("rmsnorm", lambda: rms.rmsnorm(x, w),
         lambda: rms.rmsnorm_plain(x, w),
         lambda: F.rms_norm(x, (D,), w, 1e-6),
         nbytes(x, w, x), rms_ops, ELEMENTWISE_FLOPS),
        ("rmsnorm_residual", lambda: rms.rmsnorm_residual(x, r, w),
         lambda: rms.rmsnorm_residual_plain(x, r, w), None,
         nbytes(x, r, w, x, x), rms_ops + B * D, ELEMENTWISE_FLOPS),
        ("decode_attention", lambda: dec.decode_attention(q1, k, v, kv_pos,
                                                          q_pos),
         lambda: dec.decode_attention_plain(q1, k, v, kv_pos, q_pos),
         lambda: sdpa(q1[:, :, None], k, v, attn_mask=mask),
         nbytes(q1, cache_k, cache_v, kv_pos, q_pos, q1), dec_ops,
         PEAK_FLOPS[dname]),
        ("flash_attention", lambda: fa.flash_attention(qp, kp, vp),
         lambda: fa.flash_attention_plain(qp, kp, vp),
         lambda: sdpa(qp, kp, vp, is_causal=True),
         nbytes(qp, kp, vp, qp), fa_ops, PEAK_FLOPS[dname]),
    ]


SOURCES = {
    "rmsnorm": ("src/repro_torch/kernels/csrc/rmsnorm.cu",
                "src/repro/kernels/rmsnorm.py:41"),
    "rmsnorm_residual": ("src/repro_torch/kernels/csrc/rmsnorm.cu",
                         "src/repro/kernels/rmsnorm.py:70"),
    "decode_attention": ("src/repro_torch/kernels/csrc/decode_attention.cu",
                         "src/repro/kernels/decode_attention.py:64"),
    "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:68"),
}


def kernel_phase(torch, F, failures):
    """Every kernel against its plain version in bf16 and f32; returns the
    bf16 (main path) rows keyed by kernel name."""
    rows = {}
    for dtype in (torch.bfloat16, torch.float32):
        tol = 3e-2 if dtype == torch.bfloat16 else 2e-4
        for name, kern, plain, lib, nb, ops, peak in kernel_cases(torch, F,
                                                                  dtype):
            a, b = kern(), plain()
            torch.cuda.synchronize()
            pairs = list(zip(a, b)) if isinstance(a, tuple) else [(a, b)]
            err = max(float((x.float() - y.float()).abs().max())
                      for x, y in pairs)
            ok = all(torch.allclose(x.float(), y.float(), rtol=tol, atol=tol)
                     for x, y in pairs)
            row = {"name": name, "dtype": str(dtype).replace("torch.", ""),
                   "max_err": err, "tol": tol, "within_tol": ok,
                   "kernel_ms": graph_ms(torch, kern),
                   "plain_ms": graph_ms(torch, plain),
                   "library_ms": None,
                   "kernel_host_ms": cuda_ms(torch, kern),
                   "plain_host_ms": cuda_ms(torch, plain)}
            if lib is not None:
                try:
                    row["library_ms"] = graph_ms(torch, lib)
                    row["library_host_ms"] = cuda_ms(torch, lib)
                except (TypeError, RuntimeError) as e:   # yardstick only
                    row["library_error"] = repr(e)
            row["bound_ms"], row["bound_by"] = bound(nb, ops, peak)
            emit({"kernel_check": row})
            if not ok or not math.isfinite(err):
                failures.append(f"{name} {row['dtype']}: max_err {err} > {tol}")
            if dtype == torch.bfloat16:
                rows[name] = row
    return rows


def serving_phase(torch, failures):
    from repro_torch.api import HP, LP, DeviceModel, ServerConfig
    from repro_torch.configs import get_config
    from repro_torch.kernels import KERNELS, reset_counts
    from repro_torch.models import build_model
    from repro_torch.serving.engine import staged_lm_taskspec

    cfg = get_config("smollm-135m")                       # full width, 30 L
    model = build_model(cfg)
    params = model.init_params(0)
    torch.cuda.synchronize()
    sm = torch.cuda.get_device_properties(0).multi_processor_count

    reset_counts()
    t0 = time.perf_counter()
    specs = [staged_lm_taskspec(model, priority=p, jps=JPS, n_stages=N_STAGES,
                                prompt_len=PROMPT, batch=B, tag=tag,
                                params=params)
             for p, tag in ((HP, "-hp"), (LP, "-lp"))]
    setup_s = time.perf_counter() - t0
    srv = (ServerConfig.realtime()
           .tasks(specs)
           .contexts(2).streams(2).oversubscribe(2.0)
           .device(DeviceModel(n_units=float(sm)))
           .horizon_ms(HORIZON_MS).seed(0)
           .build())
    m = srv.run()
    torch.cuda.synchronize()
    launches = {n: fn.counts.launches for n, fn in KERNELS.items()}
    plain_cuda = {n: fn.counts.plain_cuda_calls for n, fn in KERNELS.items()}
    be = srv.backend
    emit({"serving": {
        "model": cfg.name, "layers": cfg.n_layers, "d_model": cfg.d_model,
        "batch": B, "prompt_len": PROMPT, "stages": N_STAGES, "sm_count": sm,
        "setup_s": setup_s, "horizon_ms": HORIZON_MS,
        "t_alone_ms": {s.name: [st.t_alone_ms for st in s.stages]
                       for s in specs},
        "completed": {"hp": m.completed[HP], "lp": m.completed[LP]},
        "missed": {"hp": m.missed[HP], "lp": m.missed[LP]},
        "rejected": {"hp": m.rejected[HP], "lp": m.rejected[LP]},
        "mean_response_ms": {
            "hp": m.resp_stats(HP)["mean"] if m.response_ms[HP] else None,
            "lp": m.resp_stats(LP)["mean"] if m.response_ms[LP] else None},
        "migrations": m.migrations,
        "worker_exceptions": be.worker_exceptions,
        "last_worker_exception": repr(be.last_worker_exception),
        "stage_times": be.stage_time_summary(),
        "launches": launches, "plain_calls_on_cuda": plain_cuda}})
    for n, c in launches.items():
        if c == 0:
            failures.append(f"{n}: no launch on the main path")
    if any(plain_cuda.values()):
        failures.append(f"plain versions ran on CUDA tensors: {plain_cuda}")
    if be.worker_exceptions:
        failures.append(f"{be.worker_exceptions} worker exception(s), last "
                        f"{be.last_worker_exception!r}")
    if m.completed[HP] == 0:
        failures.append("no HP job completed")
    return model, params, specs[0], launches


def per_step_launches(torch, spec):
    """Kernel launches of one decode step (the 4 stage payloads in turn)."""
    from repro_torch.kernels import KERNELS, reset_counts
    reset_counts()
    state = None
    for st in spec.stages:
        state = st.payload(state)
    torch.cuda.synchronize()
    return state, {n: fn.counts.launches for n, fn in KERNELS.items()}


def profile_step(torch, spec, reps: int = 3):
    """Where one decode step's time goes: ``reps`` steps (the 4 payloads in
    turn, one stream) under torch.profiler; device busy time is the union
    of the CUDA kernels' intervals, against the host wall time."""
    from torch.profiler import ProfilerActivity, profile
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(reps):
                state = None
                for st in spec.stages:
                    state = st.payload(state)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        kern = [e for e in prof.events()
                if e.device_type == torch.autograd.DeviceType.CUDA]
        spans = sorted((e.time_range.start, e.time_range.end) for e in kern)
        busy, end = 0.0, -math.inf
        for a, b in spans:
            if b > end:
                busy += b - max(a, end)
                end = b
        by_name = {}
        for e in kern:
            n, t = by_name.get(e.name, (0, 0.0))
            by_name[e.name] = (n + 1, t + e.time_range.elapsed_us())
        top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:10]
        return {"steps": reps, "wall_ms_per_step": wall_ms / reps,
                "device_busy_ms_per_step": busy / 1e3 / reps,
                "device_idle_share": 1.0 - busy / 1e3 / wall_ms,
                "kernels_per_step": len(kern) / reps,
                "top_kernels_us_per_step": {
                    n[:60]: [c / reps, t / reps] for n, (c, t) in top}}
    except Exception as e:   # noqa: BLE001 — a measurement, not a check
        return {"error": repr(e)}


def output_checks(torch, model, params, spec, failures):
    import numpy as np

    from repro_torch.models import build_model

    state, step = per_step_launches(torch, spec)
    logits = state["hidden"]
    cfg = model.cfg
    shape_ok = tuple(logits.shape) == (B, 1, cfg.vocab_size)
    finite = bool(torch.isfinite(logits).all())
    # the same step unstaged, from the same donor (same tokens, seed 0)
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (B, PROMPT))).cuda()
    _, donor = model.prefill(params, {"tokens": tokens,
                                      "cache": model.init_cache(B, PROMPT + 1)})
    ref, _ = model.decode_step(params, {
        "tokens": torch.zeros((B, 1), dtype=torch.int32, device="cuda"),
        "cache": donor})
    staged_err = float((logits.float() - ref.float()).abs().max())
    staged_ok = torch.allclose(logits.float(), ref.float(), rtol=3e-2,
                               atol=3e-2)

    # cut-depth f32 model: kernels on the card vs plain versions on the CPU
    small = cfg.replace(n_layers=2, dtype="float32", kv_cache_dtype="float32")
    gm, cm = build_model(small), build_model(small, device="cpu")
    gp = gm.init_params(1)

    def to_cpu(t):
        return ({k: to_cpu(v) for k, v in t.items()} if isinstance(t, dict)
                else t.cpu())
    cp = to_cpu(gp)
    toks = np.random.default_rng(1).integers(0, small.vocab_size, (2, 64))
    outs = []
    for mdl, p, dev in ((gm, gp, "cuda"), (cm, cp, "cpu")):
        tk = torch.from_numpy(toks).to(dev)
        pl, cache = mdl.prefill(p, {"tokens": tk,
                                    "cache": mdl.init_cache(2, 65)})
        dl, _ = mdl.decode_step(p, {"tokens": tk[:, :1], "cache": cache})
        outs.append((pl.cpu(), dl.cpu()))
    small_err = max(float((a - b).abs().max()) for a, b in zip(*outs))
    small_ok = all(torch.allclose(a, b, rtol=2e-3, atol=2e-3)
                   for a, b in zip(*outs))
    emit({"output_check": {
        "logits_shape": list(logits.shape), "finite": finite,
        "staged_vs_unstaged_max_err": staged_err, "staged_tol": 3e-2,
        "small_f32_gpu_vs_cpu_max_err": small_err, "small_tol": 2e-3,
        "launches_per_decode_step": step}})
    emit({"decode_step_profile": profile_step(torch, spec)})
    if not (shape_ok and finite):
        failures.append(f"served logits: shape {tuple(logits.shape)}, "
                        f"finite {finite}")
    if not staged_ok:
        failures.append(f"staged vs unstaged decode: max_err {staged_err}")
    if not small_ok:
        failures.append(f"cut-depth f32 GPU vs CPU: max_err {small_err}")
    return step


def main() -> int:
    import torch
    import torch.nn.functional as F
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    try:
        from repro_torch.kernels import _lib
    except ImportError as e:
        print(f"chip_smoke: the port (src/repro_torch) is not beside this "
              f"script: {e!r}", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    card = gpu_line()
    print(card, flush=True)
    emit({"setup": {"torch": torch.__version__, "cuda": torch.version.cuda,
                    "device": name,
                    "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32,
                    "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32}})
    t0 = time.perf_counter()
    _lib.lib()
    build_s = time.perf_counter() - t0
    ptxas = [ln.strip() for ln in _lib.build_log.splitlines()
             if "Used" in ln or "Compiling entry" in ln]
    emit({"build": {"seconds": build_s, "ptxas": ptxas}})

    failures = []
    rows = kernel_phase(torch, F, failures)
    model, params, spec, launches = serving_phase(torch, failures)
    output_checks(torch, model, params, spec, failures)

    kernels = []
    for kname, row in rows.items():
        src, replaces = SOURCES[kname]
        kernels.append({
            "name": kname, "route": "cuda", "source": src,
            "replaces": replaces, "launches": launches[kname],
            "max_abs_err": row["max_err"], "ms": row["kernel_ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"]})
    for f in failures:
        print(f"chip_smoke: FAIL {f}", file=sys.stderr)
    if failures:
        return 1
    print(card, flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
