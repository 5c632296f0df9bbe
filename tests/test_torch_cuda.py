"""The port on the card: each CUDA kernel against its plain version
(flash attention also with keys of their own length), staged LM decode
(dense and ssm) served on per-lane CUDA streams through the kernels, the
moe, hybrid, MLA, gemma2, vlm and encdec families and the int8 KV cache
against the CPU, the staged CNNs (served, and each stage against the
CPU), and the epoch engine with its rate-groups on the contention kernel
(one device, and a reduced cluster fleet).

Every test here is marked ``cuda`` and skips without a CUDA device; on the
card run ``python -m pytest -q -m cuda tests/test_torch_cuda.py``. The file
imports neither jax nor repro, so it runs where only the port is installed.
Tolerances are tests/test_kernels.py's: 2e-4 in f32, 3e-2 in bf16 (5e-4 in
f32 for the SSD scan, whose sums run over a whole chunk); the f64 contention
kernel must return its plain version's bits, the f32 one agree within 2e-6
relative (a few f32 ulps: the plain version rounds on the host).
"""
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import api  # noqa: E402
from repro_torch.configs import get_reduced  # noqa: E402
from repro_torch.kernels import contention_eta as ce  # noqa: E402
from repro_torch.kernels import decode_attention as dec  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import rmsnorm as rms  # noqa: E402
from repro_torch.kernels import ssd_scan  # noqa: E402
from repro_torch.models import BUILDERS, build_model  # noqa: E402
from repro_torch.models.cnn import stage_errors  # noqa: E402
from repro_torch.serving.engine import (staged_cnn_taskspec,  # noqa: E402
                                        staged_lm_taskspec)

DTYPES = {"float32": (torch.float32, 2e-4), "bfloat16": (torch.bfloat16, 3e-2)}


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (chip_smoke.py makes the "
                    "same checks on the card)")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_kernels_match_plain_versions(dtype):
    _need_cuda()
    tdt, tol = DTYPES[dtype]
    g = torch.Generator().manual_seed(0)

    def r(*shape):
        return torch.randn(shape, generator=g).to(tdt).cuda()
    x, res, w = r(37, 96), r(37, 96), r(96)
    torch.testing.assert_close(rms.rmsnorm(x, w), rms.rmsnorm_plain(x, w),
                               rtol=tol, atol=tol)
    for a, b in zip(rms.rmsnorm_residual(x, res, w),
                    rms.rmsnorm_residual_plain(x, res, w)):
        torch.testing.assert_close(a, b, rtol=tol, atol=tol)
    # Dh 64 takes the 16-byte tile loads, Dh 60 the scalar ones
    for dh in (64, 60):
        q, k, v = r(3, 9, 70, dh), r(3, 3, 70, dh), r(3, 3, 70, dh)
        for window in (0, 16):
            torch.testing.assert_close(
                fa.flash_attention(q, k, v, window=window),
                fa.flash_attention_plain(q, k, v, window=window),
                rtol=tol, atol=tol)
        kv_pos = torch.arange(70, dtype=torch.int32).cuda()
        q_pos = torch.tensor([69, 30, 5], dtype=torch.int32).cuda()
        torch.testing.assert_close(
            dec.decode_attention(q[:, :, 0], k, v, kv_pos, q_pos),
            dec.decode_attention_plain(q[:, :, 0], k, v, kv_pos, q_pos),
            rtol=tol, atol=tol)
    # flash attention at the tensor-core instance's head dimensions, through
    # the model's [B, S, H, Dh] layout (a transposed view); bf16 must take
    # the tensor-core instance, f32 the CUDA-core one
    want = "tensor_core" if dtype == "bfloat16" else "cuda_core"
    fa.flash_attention.counts.reset()
    calls = 0
    for dh in (64, 112, 128, 160, 192):
        for s in (70, 512):
            q, k, v = (r(2, s, n, dh).transpose(1, 2) for n in (9, 3, 3))
            assert fa.flash_instance(q, k, v) == want
            for causal in (True, False):
                for window, softcap in ((0, 0.0), (16, 0.0), (0, 30.0)):
                    kw = dict(causal=causal, window=window, softcap=softcap)
                    torch.testing.assert_close(
                        fa.flash_attention(q, k, v, **kw),
                        fa.flash_attention_plain(q, k, v, **kw),
                        rtol=tol, atol=tol)
                    calls += 1
    assert fa.flash_attention.counts.by_instance == {want: calls}
    # MLA's prefill: H = KV, q and k at 192 (nope 128 + rope 64), v zero-
    # padded from 128 to 192; its columns 128 .. 191 come out zero
    for s in (70, 512):
        q, k = (r(2, s, 4, 192).transpose(1, 2) for _ in range(2))
        v = torch.nn.functional.pad(r(2, s, 4, 128), (0, 64)).transpose(1, 2)
        assert fa.flash_instance(q, k, v) == want
        out = fa.flash_attention(q, k, v)
        torch.testing.assert_close(out, fa.flash_attention_plain(q, k, v),
                                   rtol=tol, atol=tol)
        assert not out[..., 128:].any()
    # decode attention split across blocks: one split (S 1), ragged last
    # splits, the path's 513 slots, a long cache; a row that sees no slot.
    # Each call launches the split kernel and the merge, once each; at the
    # path's B 4, KV 3, 513 slots the split kernel's grid fills the card.
    dec.decode_attention.counts.reset()
    calls = 0
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    for s in (1, 70, 513, 4096):
        for b in (1, 4):
            q = r(b, 9, 64)
            k, v = (r(b, s, 3, 64).transpose(1, 2) for _ in range(2))
            fill = max(1, int(0.6 * s))
            kv_pos = torch.where(torch.arange(s) < fill, torch.arange(s),
                                 -1).to(torch.int32).cuda()
            q_pos = torch.tensor([fill - 1, fill // 2, -1, 5][:b],
                                 dtype=torch.int32).cuda()
            for window, softcap in ((0, 0.0), (16, 0.0), (0, 30.0)):
                kw = dict(window=window, softcap=softcap)
                torch.testing.assert_close(
                    dec.decode_attention(q, k, v, kv_pos, q_pos, **kw),
                    dec.decode_attention_plain(q, k, v, kv_pos, q_pos, **kw),
                    rtol=tol, atol=tol)
            none = torch.full((b,), -1, dtype=torch.int32).cuda()
            torch.testing.assert_close(
                dec.decode_attention(q, k, v, kv_pos, none),
                dec.decode_attention_plain(q, k, v, kv_pos, none),
                rtol=tol, atol=tol)
            calls += 4
            grid = dec.decode_attention.counts.grids["split"]
            assert grid == (dec.decode_split(s, b, 3, n_sm)[1], 3, b)
            assert dec.decode_attention.counts.grids["combine"] == (9, b)
            if (s, b) == (513, 4):
                assert grid[0] * grid[1] * grid[2] >= n_sm
    assert dec.decode_attention.counts.by_instance == {"split": calls,
                                                       "combine": calls}
    assert dec.decode_attention.counts.launches == 2 * calls


@pytest.mark.cuda
@pytest.mark.parametrize("dh", fa.TENSOR_CORE_DH)
def test_cuda_flash_tensor_core_plan_and_instances(dh):
    """The built tensor-core kernel at ``dh`` reports ``flash_plan``'s
    numbers; bf16 launches it against the plain version (causal, window,
    softcap; S 70 and 512); the CUDA-core instance at the same shapes on
    request; an explicit instance the inputs do not allow is refused."""
    _need_cuda()
    g = torch.Generator().manual_seed(dh)

    def r(*shape):
        return torch.randn(shape, generator=g).to(torch.bfloat16).cuda()
    plan, card = fa.flash_plan(dh), fa.card_plan(dh)
    assert {k: card[k] for k in plan._fields if k != "dh"} == \
        {k: v for k, v in plan._asdict().items() if k != "dh"}
    assert 1 <= card["resident_blocks_per_sm"] <= plan.blocks_per_sm
    fa.flash_attention.counts.reset()
    for s in (70, 512):
        q, k, v = (r(2, s, n, dh).transpose(1, 2) for n in (8, 2, 2))
        for window, softcap in ((0, 0.0), (16, 0.0), (0, 30.0)):
            kw = dict(window=window, softcap=softcap)
            torch.testing.assert_close(
                fa.flash_attention(q, k, v, **kw),
                fa.flash_attention_plain(q, k, v, **kw),
                rtol=3e-2, atol=3e-2)
    assert fa.flash_attention.counts.by_instance == {"tensor_core": 6}
    # the CUDA-core instance at the same shapes, on request
    torch.testing.assert_close(
        fa.flash_attention(q, k, v, instance="cuda_core"),
        fa.flash_attention_plain(q, k, v), rtol=3e-2, atol=3e-2)
    with pytest.raises(ValueError, match="allow cuda_core"):
        fa.flash_attention(q.float(), k.float(), v.float(),
                           instance="tensor_core")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_flash_attention_keys_of_their_own_length(dtype):
    """Cross-attention on the card: keys and values of their own length
    (ragged, shorter and longer than the queries, whisper's 1500 frames),
    not causal, through both instances; causal with another key length is
    refused."""
    _need_cuda()
    tdt, tol = DTYPES[dtype]
    g = torch.Generator().manual_seed(2)

    def r(*shape):
        return torch.randn(shape, generator=g).to(tdt).cuda()
    for dh in (64, 128, 192, 60):
        for s, s_kv in ((1, 1500), (64, 1500), (70, 33)):
            q = r(2, s, 6, dh).transpose(1, 2)
            k, v = (r(2, s_kv, 3, dh).transpose(1, 2) for _ in range(2))
            torch.testing.assert_close(
                fa.flash_attention(q, k, v, causal=False),
                fa.flash_attention_plain(q, k, v, causal=False),
                rtol=tol, atol=tol)
    with pytest.raises(ValueError, match="causal"):
        fa.flash_attention(q, k, v)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m", [1, 4, 2048])
@pytest.mark.parametrize("d", [576, 2560, 5120])
def test_cuda_rmsnorm_plans_match_plain_versions(dtype, m, d):
    """The paths' widths (smollm 576; mamba2 2560 and 5120) at one row,
    decode batch 4 and prefill's 2048 rows, both norms, each through the
    instance that ``rmsnorm_plan`` names; then a view one element off a
    16-byte boundary (the scalar instance, one CTA a row), a bf16 weight,
    and plus_one."""
    _need_cuda()
    tdt, tol = DTYPES[dtype]
    g = torch.Generator().manual_seed(m * d)

    def r(*shape, dt=tdt):
        return torch.randn(shape, generator=g).to(dt).cuda()
    x, res, w = r(m, d), r(m, d), r(d, dt=torch.float32)
    plan = rms.rmsnorm_plan(m, d, tdt)
    assert plan.vec > 1 and plan == rms.plan_for(x, w, res)
    rms.rmsnorm.counts.reset()
    rms.rmsnorm_residual.counts.reset()
    torch.testing.assert_close(rms.rmsnorm(x, w), rms.rmsnorm_plain(x, w),
                               rtol=tol, atol=tol)
    for a, b in zip(rms.rmsnorm_residual(x, res, w),
                    rms.rmsnorm_residual_plain(x, res, w)):
        torch.testing.assert_close(a, b, rtol=tol, atol=tol)
    want = {plan.instance: 1}
    assert rms.rmsnorm.counts.by_instance == want
    assert rms.rmsnorm_residual.counts.by_instance == want
    assert rms.rmsnorm.counts.grids[plan.instance] == (plan.grid(m),)
    # a misaligned view takes the scalar instance of the same kernel
    xm = r(m * d + 1)[1:].view(m, d)
    scalar = rms.plan_for(xm, w)
    assert scalar.vec == 1 and scalar.instance.endswith("_scalar")
    torch.testing.assert_close(rms.rmsnorm(xm, w), rms.rmsnorm_plain(xm, w),
                               rtol=tol, atol=tol)
    wb = r(d, dt=torch.bfloat16)
    for plus_one in (False, True):
        torch.testing.assert_close(
            rms.rmsnorm(x, wb, plus_one=plus_one),
            rms.rmsnorm_plain(x, wb, plus_one=plus_one), rtol=tol, atol=tol)
    assert rms.rmsnorm.counts.by_instance[scalar.instance] == 1


@pytest.mark.cuda
def test_realtime_staged_ssm_decode_on_cuda_streams():
    _need_cuda()
    from repro_torch.kernels import KERNELS, reset_counts
    model = build_model(get_reduced("mamba2-2.7b").replace(dtype="bfloat16"))
    reset_counts()
    spec = staged_lm_taskspec(model, priority=api.HP, jps=20.0, batch=2,
                              n_stages=3, prompt_len=12)
    srv = (api.ServerConfig.realtime().tasks([spec]).contexts(2).streams(2)
           .oversubscribe(2.0).device(api.DeviceModel(n_units=2.0))
           .horizon_ms(800.0).build())
    m = srv.run()
    assert m.completed[api.HP] > 0
    assert srv.backend.worker_exceptions == 0
    assert KERNELS["ssd"].counts.launches > 0
    assert KERNELS["rmsnorm"].counts.launches > 0
    assert all(fn.counts.plain_cuda_calls == 0 for fn in KERNELS.values())


@pytest.mark.cuda
def test_realtime_staged_lm_decode_on_cuda_streams():
    _need_cuda()
    from repro_torch.kernels import KERNELS, reset_counts
    model = build_model(get_reduced("smollm-135m").replace(n_layers=8,
                                                           dtype="bfloat16"))
    reset_counts()
    spec = staged_lm_taskspec(model, priority=api.HP, jps=20.0, batch=2)
    srv = (api.ServerConfig.realtime().tasks([spec]).contexts(2).streams(2)
           .oversubscribe(2.0).device(api.DeviceModel(n_units=2.0))
           .horizon_ms(800.0).build())
    m = srv.run()
    assert m.completed[api.HP] > 0
    assert srv.backend.worker_exceptions == 0
    dense = ("rmsnorm", "rmsnorm_residual", "decode_attention",
             "flash_attention")
    assert all(KERNELS[k].counts.launches > 0 for k in dense)
    assert all(fn.counts.plain_cuda_calls == 0 for fn in KERNELS.values())


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["smollm-135m", "resnet18"])
def test_stage_programs_replay_on_two_streams(name):
    """Each staged payload is a CUDA graph a stream: two jobs through the
    payloads on two streams, interleaved, equal the functional eager stage
    functions (the LM, whose programs write their cache copy in place,
    bit for bit; the CNN within 2e-4 of the scale); each call after a
    stream's first is one replay, which counts its capture's launches
    again; the captures went into one graph pool a stream."""
    _need_cuda()
    import functools

    from repro_torch.kernels import KERNELS, _lib, reset_counts
    if name == "smollm-135m":
        model = build_model(get_reduced(name).replace(n_layers=8,
                                                      dtype="bfloat16"))
        spec = staged_lm_taskspec(model, priority=api.HP, jps=20.0, batch=2)
        states = [{"hidden": torch.full((2, 1), t, dtype=torch.int32,
                                        device="cuda"), "slices": {}}
                  for t in (3, 7)]
    else:
        model = BUILDERS[name](width=8)
        spec = staged_cnn_taskspec(model, priority=api.HP, jps=20.0,
                                   input_hw=33, batch=2)
        g = torch.Generator().manual_seed(0)
        states = [torch.randn((2, 33, 33, 3), generator=g).cuda()
                  for _ in range(2)]

    def eager(p):
        if isinstance(p, functools.partial):
            return functools.partial(p.func, **{
                **p.keywords, "program": p.keywords["program"].functional})
        return p.functional

    def leaves(t):
        if isinstance(t, dict):
            return [x for v in t.values() for x in leaves(v)]
        if isinstance(t, (list, tuple)):
            return [x for v in t for x in leaves(v)]
        return [t]
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    reset_counts()
    for k, st in enumerate(spec.stages):
        for j in range(2):
            with torch.cuda.stream(streams[k % 2]):
                out = st.payload(states[j])
            torch.cuda.synchronize()
            ref = eager(st.payload)(states[j])
            for a, b in zip(leaves(out), leaves(ref)):
                if name == "smollm-135m":
                    assert torch.equal(a, b)
                else:
                    scale = max(1.0, float(b.abs().max()))
                    assert float((a - b).abs().max()) <= 2e-4 * scale
            states[j] = out
    g = _lib.stage_graphs.snapshot()
    assert g["captures"] == len(spec.stages)          # one a stream
    assert g["pools"] == 2                            # one a stream
    assert g["replays"] == 2 * len(spec.stages)
    launched = sum(fn.counts.launches for fn in KERNELS.values())
    if name == "smollm-135m":
        # a stage's 2 replays count again what its warm-up call and the
        # 2 eager references launch: 5 runs of it in all
        assert g["replayed_launches"] > 0
        assert 2 * launched == 5 * g["replayed_launches"]
    assert all(fn.counts.plain_cuda_calls == 0 for fn in KERNELS.values())


@pytest.mark.cuda
def test_a_stage_call_on_the_card_is_one_launch_between_its_events():
    """On the card a stage program's graph holds its copies and its events:
    a call handed two events enqueues its device work as one launch (steps
    ``nodes``, ``launch``), the events time the graph's work, and the
    outputs equal the eager stage's on the same inputs, call after call
    with new tensors (no call reads another's); an argument laid out
    otherwise (the same shape, other strides) takes an entry of its own;
    an output that is not one dense block comes out contiguous, as
    ``clone`` gives it, and an empty one empty."""
    _need_cuda()
    from repro_torch.serving.stage_graph import StageProgram
    w = torch.randn(64, 64, device="cuda")

    def stage(x):
        return torch.relu(x @ w) + 1.0
    prog = StageProgram(stage, name="mm")
    stream = torch.cuda.Stream()
    events = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    with torch.cuda.stream(stream):
        for ev in events:
            ev.record()
        for i in range(4):
            x = torch.randn(32, 64, device="cuda")
            if i == 3:                            # another layout, same shape
                x = torch.randn(64, 32, device="cuda").t()
            steps = []
            call = prog.prepare(x)
            call.issue(*events, step=lambda name, wall=None:
                       steps.append(name))
            out = call.result()
            stream.synchronize()
            assert steps == ["nodes", "launch"]
            assert events[0].elapsed_time(events[1]) > 0.0
            torch.testing.assert_close(out, stage(x), rtol=1e-5, atol=1e-5)
        view = StageProgram(lambda x: ((x * 2.0)[:, ::2], x[:0] + 1.0),
                            name="view")
        for _ in range(2):
            got, empty = view(torch.ones(8, 8, device="cuda"))
            stream.synchronize()
            assert got.stride() == (4, 1)
            assert torch.equal(got, torch.full((8, 4), 2.0, device="cuda"))
            assert empty.shape == (0, 8)


@pytest.mark.cuda
def test_a_ready_block_made_under_one_lane_stream_launches_on_another():
    """A call made ready under one lane's stream (its output block made
    there, as the backend makes a HP stage's call while the stage before
    it runs) and launched on another lane's stream takes that block and
    gives the stage's values, call after call; once both lanes have run
    the stage, the caching allocator calls the driver no more."""
    _need_cuda()
    from repro_torch.serving.stage_graph import StageProgram
    w = torch.randn(64, 64, device="cuda")

    def stage(x):
        return torch.relu(x @ w) + 1.0, x.sum(0)
    prog = StageProgram(stage, name="hop")
    a, b = torch.cuda.Stream(), torch.cuda.Stream()
    events = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    xs = [torch.randn(32, 64, device="cuda") for _ in range(9)]
    torch.cuda.synchronize()

    def hop(x):
        with torch.cuda.stream(a):
            r = prog.ready(x)
        with torch.cuda.stream(b):
            call = r.call()
            call.issue(*events)
            assert call.block is r.block and r.block is not None
            return call.result()
    for s in (a, b):
        with torch.cuda.stream(s):
            prog(xs[0])
    with torch.cuda.stream(b):
        for ev in events:
            ev.record()
    hop(xs[0])
    torch.cuda.synchronize()
    allocs = torch.cuda.memory_stats()["num_device_alloc"]
    outs = [(x, hop(x)) for x in xs[1:]]
    torch.cuda.synchronize()
    assert torch.cuda.memory_stats()["num_device_alloc"] == allocs
    for x, (y, total) in outs:
        ref_y, ref_total = stage(x)
        torch.testing.assert_close(y, ref_y, rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(total, ref_total, rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
def test_a_ready_call_sets_its_nodes_again_after_another_call_launched():
    """Two calls made ready on one lane's entry, launched in the other
    order: the later-made one's launch points the graph's nodes at its
    tensors, so the earlier-made one's sets them again (``last`` holds its
    input's and its block's pointers after it) and each gives its own
    input's values."""
    _need_cuda()
    from repro_torch.serving.stage_graph import StageProgram
    w = torch.randn(64, 64, device="cuda")

    def stage(x):
        return torch.relu(x @ w) + 1.0
    prog = StageProgram(stage, name="nodes")
    stream = torch.cuda.Stream()
    events = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    x1, x2 = (torch.randn(32, 64, device="cuda") for _ in range(2))
    torch.cuda.synchronize()
    with torch.cuda.stream(stream):
        for ev in events:
            ev.record()
        prog(torch.randn(32, 64, device="cuda"))       # the capture
        r1, r2 = prog.ready(x1), prog.ready(x2)
        c2 = r2.call()
        c2.issue(*events)
        out2 = c2.result()
        burst = c2.static.runner.burst
        assert burst.last[2] == x2.data_ptr()
        c1 = r1.call()
        c1.issue(*events)
        out1 = c1.result()
        assert c1.static is c2.static
        assert burst.last[2] == x1.data_ptr()
        assert burst.last[2 + burst.n_in] == c1.block.data_ptr()
    stream.synchronize()
    torch.testing.assert_close(out1, stage(x1), rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(out2, stage(x2), rtol=1e-5, atol=1e-5)


def _card_ready_backend(name, max_batch=1, ctx_devices=None):
    """A started backend on the card (2 contexts x 1 stream) with one HP
    task of real stage programs: a staged ResNet18 at width 8 (64 x 64
    inputs) or smollm-135m at its full width cut to 4 layers (bf16,
    decode batch 2), its first job's chain made ready at the start.
    Returns the backend, the task and a function of (job, stage) that
    makes the instance."""
    from repro_torch.configs import get_config
    from repro_torch.core.task import StageInstance
    if name == "resnet18":
        spec = staged_cnn_taskspec(BUILDERS[name](width=8), priority=api.HP,
                                   jps=20.0, input_hw=64)
    else:
        model = build_model(get_config(name).replace(n_layers=4,
                                                     dtype="bfloat16"))
        spec = staged_lm_taskspec(model, priority=api.HP, jps=20.0, batch=2,
                                  prompt_len=20)
    cfg = (api.ServerConfig.realtime().tasks([spec]).contexts(2).streams(1)
           .oversubscribe(1.0).device(api.DeviceModel(n_units=4.0)))
    if name == "resnet18":
        cfg = cfg.realtime_io(input_hw=64, batch=1)
    if max_batch > 1:
        cfg = cfg.batching(max_batch=max_batch)
    srv = cfg.build()
    be = srv.backend
    if ctx_devices is not None:
        be.ctx_devices = ctx_devices
    be.bind(srv.core)
    be.start()
    task = srv.scheduler.tasks[0]

    def instance(job, stage):
        job.stage_idx = stage
        return StageInstance(job, enqueue_ms=0.0, virtual_deadline_ms=100.0)
    return be, task, instance


def _card_stage(be, lane, inst):
    """Launch ``inst`` on ``lane``, poll it to its end; its enqueue steps
    and the job's state after it, copied."""
    be.launch(lane, inst)
    while be.has_inflight():
        be.advance(be.now_ms() + 2000.0)
    state = be._job_state.get(inst.job.job_id)
    copy = None if state is None else [t.clone() for t in _leaves(state)]
    return list(be._enqueues)[-1][3], copy


class _Fail:
    """A chaos plan's draw that fails every launch, without a stall."""

    @staticmethod
    def draw_launch():
        return True, 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["resnet18", "smollm-135m"])
@pytest.mark.parametrize("reason", ["cancelled", "killed", "ctx_failed",
                                    "chaos", "batch", "factory"])
def test_each_discarded_ready_call_on_the_card_leaves_its_job_bit_exact(
        reason, name):
    """The card's twin of the stand-in seam's test of each discard
    (``test_torch_inline_dispatch.py``), on real stage programs: each way
    a call made ready ahead stops being its stage's discards the rest of
    the job's chain, each call counted under that reason and no other;
    made = used + left + discarded; the job's later stages resolve at
    their boundary; nothing holds a discarded call's output block once it
    is discarded, and with those blocks handed out again and filled with
    0xff bytes (``poison``) every stage output of the job equals, bit for
    bit, the same job's through the boundary path (the same stage
    programs on the same lane and input, no call made ready)."""
    _need_cuda()
    import gc
    import weakref

    from repro_torch.core.task import Job
    be, task, instance = _card_ready_backend(
        name, max_batch=2 if reason == "batch" else 1)
    discarded, count = [], be._discard

    def discard(chain, why):
        count(chain, why)
        discarded.extend((weakref.ref(r.call.block), r.call.block.nbytes)
                         for r in chain if r.call.block is not None)
    be._discard = discard
    poison, lane = [], (0, 0)

    def job_of():
        return Job(task, 0.0, extra_release_ms=[1.0] if reason == "batch"
                   else [])

    def stages(job, lo, hi):
        """The job's stages ``lo`` to ``hi - 1`` on ``lane``: their steps
        and outputs."""
        return [_card_stage(be, lane, instance(job, k))
                for k in range(lo, hi)]
    n = len(task.spec.stages)
    try:
        if reason == "factory":
            x0 = torch.full_like(be._zeros.made[1], 0.5)
            be.input_factory = lambda j: x0
        # the boundary path first: the same stage programs on the same lane
        # and input, with the start's chain set aside (no call made ready)
        chain = be._ready0.pop(task.index)
        assert len(chain) == n
        ref = stages(job_of(), 0, n)
        assert all("resolve" in st and "lookup" not in st for st, _ in ref)
        be._ready0[task.index] = chain
        del chain
        job = job_of()
        if reason == "chaos":
            be.core._chaos = _Fail
            steps, out = _card_stage(be, lane, instance(job, 0))
            assert "resolve" in steps and out is None   # not committed
            be.core._chaos = None
        if reason in ("killed", "ctx_failed"):
            ghost = (0, 0) if reason == "killed" else (1, 0)
            inst = instance(job, 0)
            be.launch(ghost, inst)
            assert job.job_id in be._ready
            if reason == "killed":
                be.kill_lane(ghost, inst)        # a watchdog's ghost
            else:
                be.cancel_ctx(1)                 # its context failed
            assert job.job_id not in be._ready
            while be.has_inflight():
                be.advance(be.now_ms() + 2000.0)
        got = []
        if reason in ("batch", "factory"):
            got = stages(job, 0, 1)              # its first stage discards
        if reason == "cancelled":
            got = stages(job, 0, 1)              # takes its ready call
            assert "lookup" in got[0][0]
            be.on_job_done(job)                  # retired at the boundary
        gc.collect()
        torch.cuda.synchronize()
        # nothing holds a discarded block: hand them out again, poisoned
        assert discarded and all(r() is None for r, _ in discarded)
        poison += [torch.full((b,), 255, dtype=torch.uint8, device="cuda")
                   for _, b in discarded]
        if reason != "cancelled":
            got += stages(job, len(got), n)
            assert all("resolve" in st and "lookup" not in st
                       for st, _ in got)
    finally:
        be.stop()
    torch.cuda.synchronize()
    assert len(got) == (1 if reason == "cancelled" else n)
    for (_, out), (_, want) in zip(got, ref):
        assert len(out) == len(want) > 0
        assert all(torch.equal(u, v) for u, v in zip(out, want))
    ready = be.ready_summary()
    counts = {r: sum(by.values()) for r, by in ready["discarded"].items()
              if any(by.values())}
    first = reason in ("chaos", "batch", "factory")
    assert counts == {reason: n if first else n - 1}
    assert ready["discarded"][reason] == {"s0": int(first),
                                          "later": n - 1}
    for w in ("s0", "later"):
        assert ready["made"][w] == (ready["used"][w] + ready["left"][w]
                                    + sum(by[w] for by in
                                          ready["discarded"].values()))
    assert be.worker_exceptions == 0 and len(poison) == len(discarded)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["resnet18", "smollm-135m"])
def test_a_move_between_contexts_of_one_card_keeps_the_ready_call(name):
    """``migrated`` is not reachable on one card: with both contexts on
    it (``ctx_devices``), a job's next stage on the other context finds
    its state where it was (``staging.migrate`` hands back the very tree
    where no tensor moves), so the call made ready on that state is the
    stage's: taken (``lookup``), nothing discarded. Moving the state needs
    contexts on two cards."""
    _need_cuda()
    from repro_torch.core.task import Job
    dev = torch.device("cuda", torch.cuda.current_device())
    be, task, instance = _card_ready_backend(name,
                                             ctx_devices={0: dev, 1: dev})
    try:
        job = Job(task, 0.0)
        got = [_card_stage(be, (k % 2, 0), instance(job, k))
               for k in range(len(task.spec.stages))]
    finally:
        be.stop()
    assert be.resharded == len(task.spec.stages) - 1
    assert all("lookup" in st for st, _ in got)
    ready = be.ready_summary()
    assert not any(n for by in ready["discarded"].values()
                   for n in by.values())
    assert ready["used"]["later"] == len(task.spec.stages) - 1


@pytest.mark.cuda
def test_a_backend_stopped_with_stages_in_flight_lets_them_end_first():
    """A HP stage launched on its lane's stream (about 20 ms of products
    into the output block its call was made ready with, under the engine
    thread's stream) and the backend stopped at once: ``stop`` returns
    only once the stage's end event has completed; with the backend
    dropped, the blocks the engine thread's stream hands out next keep
    what is written to them there."""
    _need_cuda()
    import gc

    from repro_torch.core.task import Job, StageInstance
    from repro_torch.serving.stage_graph import StageProgram
    n = 1024
    w = torch.randn(n, n, device="cuda") / n ** 0.5
    spec = api.TaskSpec(name="t", period_ms=100.0, priority=api.HP, stages=[
        api.StageProfile(f"t/s{j}", 1.0, n_sat=1.0, mem_frac=0.0)
        for j in range(2)])

    def fn(x):
        h = x.reshape(1, -1)[:, :1] + w
        for _ in range(200):
            h = torch.tanh(h @ w)
        return h
    for st in spec.stages:
        st.payload = StageProgram(fn, st.name)
    srv = (api.ServerConfig.realtime().tasks([spec]).contexts(2).streams(1)
           .oversubscribe(1.0).device(api.DeviceModel(n_units=4.0))
           .realtime_io(input_hw=2, batch=1)).build()
    be = srv.backend
    be.bind(srv.core)
    be.start()
    chain = be._ready0[0]
    block = chain[0].call.block
    assert block is not None and block.shape == (n, n)
    job = Job(srv.scheduler.tasks[0], 0.0)
    be.launch((0, 0), StageInstance(job, enqueue_ms=0.0,
                                    virtual_deadline_ms=100.0))
    flight = [rec for rec in be._flight.values() if rec.end is not None]
    assert len(flight) == 1 and flight[0].out is chain[0].call.output()
    assert not flight[0].end.query()          # still on the card
    be.stop()
    assert all(rec.end.query() for rec in flight)
    del srv, be, chain, block, flight, job
    gc.collect()
    fills = [torch.full((n, n), float(k), device="cuda") for k in range(8)]
    torch.cuda.synchronize()
    for k, t in enumerate(fills):
        assert bool((t == float(k)).all())


@pytest.mark.cuda
def test_lanes_made_mid_run_capture_while_others_replay():
    """A planned reconfigure adds contexts, and so lanes (4 -> 8), after
    the clock started: the backend read the plan at its start and made
    and warmed 8 streams before the clock started, so the reconfigure's
    lanes take the retired lanes' 4 streams and the 4 made for it, each
    of whose graphs was captured then; nothing is captured or warmed
    after the start, and the caching allocator calls the driver no more
    after the reconfigure. Every payload stage the lanes ran is one
    replay (a warm-up's replays would be counted apart)."""
    _need_cuda()
    model = build_model(get_reduced("smollm-135m").replace(n_layers=8,
                                                           dtype="bfloat16"))
    specs = [staged_lm_taskspec(model, priority=p, jps=40.0, batch=2,
                                tag=tag)
             for p, tag in ((api.HP, "-hp"), (api.LP, "-lp"))]
    srv = (api.ServerConfig.realtime().tasks(specs).contexts(2).streams(2)
           .oversubscribe(2.0).device(api.DeviceModel(n_units=2.0))
           .reconfigure_at(300.0, n_contexts=4)
           .horizon_ms(900.0).build())
    be = srv.backend
    rewarmed, reconfigure = {}, be.on_reconfigure

    def counted():
        reconfigure()
        rewarmed["alloc"] = torch.cuda.memory_stats()["num_device_alloc"]
    be.on_reconfigure = counted
    m = srv.run()
    g = be.graph_summary()
    assert m.completed[api.HP] > 0 and m.reconfigures == 1
    assert be.worker_exceptions == 0
    assert be.rewarm["count"] == 0 and be.rewarm["s"] == 0.0
    assert g["warm_captures"] > 0 and g["streams"] == 8
    assert g["captures"] == g["rewarm_captures"] == 0
    assert g["replays"] == g["stage_runs"] + g["rewarm_replays"]
    assert g["stage_runs"] > 0 and g["rewarm_replays"] == 0
    assert g["pool_stage_runs"] == 0 and not be._pool._threads
    live = [be._streams[ln].cuda_stream for ln in be._live_lanes()]
    assert len(set(live)) == len(live) == 8
    assert (torch.cuda.memory_stats()["num_device_alloc"]
            == rewarmed["alloc"])


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


@pytest.mark.cuda
@pytest.mark.parametrize("arch,replace", [
    ("smollm-135m", {}), ("smollm-135m", {"kv_cache_dtype": "int8"}),
    ("mamba2-2.7b", {}), ("qwen2-moe-a2.7b", {}), ("deepseek-v2-236b", {}),
    ("gemma2-27b", {})],
    ids=["dense", "int8_cache", "ssm", "moe", "mla", "gemma2"])
def test_in_place_stage_programs_equal_the_functional_stages(arch, replace):
    """Every served LM family in bf16: three jobs through the compiled
    payloads (CUDA graphs whose stage functions write their static cache
    copy in place) on two streams equal the functional eager stages bit
    for bit, hidden states, logits and cache slices; the donor cache's
    bytes stay as they were; the captures went into one pool a stream."""
    _need_cuda()
    import functools

    from repro_torch.kernels import _lib, reset_counts
    cfg = get_reduced(arch).replace(dtype="bfloat16", **replace)
    model = build_model(cfg)
    spec = staged_lm_taskspec(model, priority=api.HP, jps=20.0, batch=2,
                              prompt_len=20)
    donors = [[t.clone() for t in _leaves(st.payload.keywords["donor_slice"])]
              for st in spec.stages]
    reset_counts()
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    for job in range(3):
        state = {"hidden": torch.full((2, 1), 5 + job, dtype=torch.int32,
                                      device="cuda"), "slices": {}}
        for k, st in enumerate(spec.stages):
            with torch.cuda.stream(streams[(k + job) % 2]):
                out = st.payload(state)
            torch.cuda.synchronize()
            prog = st.payload.keywords["program"]
            ref = functools.partial(st.payload.func, **{
                **st.payload.keywords, "program": prog.functional})(state)
            assert all(torch.equal(a, b) for a, b in zip(_leaves(out),
                                                         _leaves(ref)))
            state = out
        assert state["hidden"].shape[-1] == cfg.vocab_size
    for st, kept in zip(spec.stages, donors):
        assert all(torch.equal(a, b) for a, b in zip(
            _leaves(st.payload.keywords["donor_slice"]), kept))
    g = _lib.stage_graphs.snapshot()
    # each stage met both streams: a capture on each, a replay a call
    assert g["pools"] == 2 and g["captures"] == 2 * len(spec.stages)
    assert g["replays"] == 3 * len(spec.stages)


@pytest.mark.cuda
def test_a_served_run_keeps_one_graph_pool_a_lane():
    """2 contexts x 2 streams: the captures of both tasks' stage programs
    went into 5 pools (4 lanes and the calibration's stream), which hold
    card memory; every HP job's response parts sum to its response."""
    _need_cuda()
    from repro_torch.kernels import reset_counts
    model = build_model(get_reduced("smollm-135m").replace(n_layers=8,
                                                           dtype="bfloat16"))
    reset_counts()
    specs = [staged_lm_taskspec(model, priority=p, jps=40.0, batch=2,
                                tag=tag)
             for p, tag in ((api.HP, "-hp"), (api.LP, "-lp"))]
    srv = (api.ServerConfig.realtime().tasks(specs).contexts(2).streams(2)
           .oversubscribe(2.0).device(api.DeviceModel(n_units=2.0))
           .horizon_ms(600.0).build())
    m = srv.run()
    g = srv.backend.graph_summary()
    assert m.completed[api.HP] > 0 and srv.backend.worker_exceptions == 0
    assert g["replays"] == g["stage_runs"] > 0
    assert g["run_pools"] == 4 and g["pools"] == 5 and g["pool_gb"] > 0
    parts = srv.backend.hp_response_parts()
    assert parts["jobs"] == len(m.response_ms[api.HP])
    assert parts["sum_err_ms"] <= 0.01


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["resnet18", "smollm-135m"])
def test_served_stages_equal_the_functional_stages_with_inputs_made_ahead(
        name):
    """ResNet18 at width 8 and staged smollm-135m (reduced, 8 layers,
    bf16) served on 2 x 2 lanes, the default input made before the clock
    and each call resolved from its program's plan: every harvested
    stage's output equals its functional stage on the same input (the LM
    bit for bit, the CNN within 2e-4 of the scale), each job's first
    stage took the one zero input made at the start, which stays zeros;
    one graph pool a lane; no CUDA event made and no driver allocation
    after the clock started; each HP job's parts sum to its response."""
    _need_cuda()
    import functools

    from repro_torch.kernels import reset_counts
    from repro_torch.serving.engine import lm_stage
    reset_counts()
    tasks = ((api.HP, "-hp"), (api.LP, "-lp"))
    if name == "resnet18":
        model = BUILDERS[name](width=8)
        specs = [staged_cnn_taskspec(model, priority=p, jps=20.0,
                                     input_hw=64, tag=tag)
                 for p, tag in tasks]
    else:
        model = build_model(get_reduced(name).replace(n_layers=8,
                                                      dtype="bfloat16"))
        specs = [staged_lm_taskspec(model, priority=p, jps=40.0, batch=2,
                                    tag=tag) for p, tag in tasks]
    cfg = (api.ServerConfig.realtime().tasks(specs).contexts(2).streams(2)
           .oversubscribe(2.0).device(api.DeviceModel(n_units=2.0))
           .horizon_ms(800.0))
    if name == "resnet18":
        cfg = cfg.realtime_io(input_hw=64)
    srv = cfg.build()
    be = srv.backend
    taken, pairs, at_start = {}, [], {}
    stage_input, harvest, start = be._stage_input, be._harvest, be.start

    def take(inst, lane):
        x = stage_input(inst, lane)
        job = inst.job
        taken[(job.job_id, job.stage_idx)] = (inst.profile.payload, x)
        return x

    def harvested(rec):
        c = harvest(rec)
        job = rec.inst.job
        got = taken.pop((job.job_id, job.stage_idx), None)
        if c is not None and not rec.failed and len(pairs) < 96:
            pairs.append((job.stage_idx, *got, be._job_state[job.job_id]))
        return c

    def started():
        start()
        at_start.update(torch.cuda.memory_stats())
    be._stage_input, be._harvest, be.start = take, harvested, started
    m = srv.run()
    torch.cuda.synchronize()
    stats = torch.cuda.memory_stats()
    assert m.completed[api.HP] > 0 and be.worker_exceptions == 0
    zero = be._zeros.made[1]
    assert be._zeros.blocks == 1 and not zero.any()
    assert {k for k, *_ in pairs} == set(range(len(specs[0].stages)))
    for stage, payload, x, out in pairs:
        if stage == 0:
            assert x is zero
        if name == "resnet18":
            ref = payload.functional(x)
            scale = max(1.0, float(ref.abs().max()))
            assert float((out - ref).abs().max()) <= 2e-4 * scale
        else:
            prog = payload.keywords["program"]
            ref = functools.partial(lm_stage, **{
                **payload.keywords, "program": prog.functional})(x)
            a, b = _leaves(out), _leaves(ref)
            assert len(a) == len(b)
            assert all(torch.equal(u, v) for u, v in zip(a, b))
    g = be.graph_summary()
    assert g["replays"] == g["stage_runs"] > 0
    assert g["run_pools"] == 4 and g["pools"] == 5
    assert g["events_in_run"] == 0
    for k in ("num_device_alloc", "num_alloc_retries"):
        assert stats.get(k, 0) == at_start.get(k, 0), k
    # the HP stages past the first took the calls their chains made ready
    # on the output the stage before gave, and no call was discarded
    ready = be.ready_summary()
    assert ready["used"]["s0"] > 0 and ready["used"]["later"] > 0
    assert not any(n for by in ready["discarded"].values()
                   for n in by.values())
    parts = be.hp_response_parts()
    assert parts["jobs"] == len(m.response_ms[api.HP])
    assert parts["sum_err_ms"] <= 0.01


def _chip_smoke():
    """The repo's ``chip_smoke.py`` as a module (its host readings)."""
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke_module", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.cuda
def test_a_served_run_reports_what_the_host_gave_the_engine_thread():
    """Staged smollm-135m (reduced, 8 layers, bf16) served on 2 x 2 lanes
    with ``chip_smoke.py``'s host readings around the run: every stage
    enqueued is harvested or still in flight at the end, every harvested
    HP stage's output equals its functional stage's bit for bit, and the
    readings are all there: the engine thread's CPU seconds read on the
    thread that started the backend, its switches (None where the host
    does not count them), the cgroup's limit and throttling or the
    reason they cannot be read, and the backend's polls and end-event
    queries."""
    _need_cuda()
    import functools
    import threading

    from repro_torch.kernels import reset_counts
    from repro_torch.serving.engine import lm_stage
    smoke = _chip_smoke()
    reset_counts()
    model = build_model(get_reduced("smollm-135m").replace(
        n_layers=8, dtype="bfloat16"))
    specs = [staged_lm_taskspec(model, priority=p, jps=40.0, batch=2,
                                tag=tag)
             for p, tag in ((api.HP, "-hp"), (api.LP, "-lp"))]
    srv = (api.ServerConfig.realtime().tasks(specs).contexts(2).streams(2)
           .oversubscribe(2.0).device(api.DeviceModel(n_units=2.0))
           .horizon_ms(800.0).build())
    be = srv.backend
    taken, pairs, count, before = {}, [], [0, 0], {}
    stage_input, harvest, enqueue, start = (be._stage_input, be._harvest,
                                            be._enqueue, be.start)

    def take(inst, lane):
        x = stage_input(inst, lane)
        job = inst.job
        taken[(job.job_id, job.stage_idx)] = (inst.profile.payload, x)
        return x

    def enqueued(rec, stream):
        count[0] += 1
        return enqueue(rec, stream)

    def harvested(rec):
        count[1] += 1
        c = harvest(rec)
        job = rec.inst.job
        got = taken.pop((job.job_id, job.stage_idx), None)
        if (c is not None and not rec.failed and len(pairs) < 64
                and job.task.priority == api.HP):
            pairs.append((*got, be._job_state[job.job_id]))
        return c

    def started():
        start()
        before.update(ident=threading.get_ident(), cgroup=smoke.cgroup_cpu()[0],
                      usage=smoke.thread_usage(smoke.switches_counted()))
    be._stage_input, be._harvest, be._enqueue, be.start = (
        take, harvested, enqueued, started)
    m = srv.run()
    host = smoke.run_host(before, before.pop("ident"), be)
    torch.cuda.synchronize()
    assert m.completed[api.HP] > 0 and be.worker_exceptions == 0
    assert count[1] + len(be._flight) == count[0]
    assert pairs
    for payload, x, out in pairs:
        prog = payload.keywords["program"]
        ref = functools.partial(lm_stage, **{
            **payload.keywords, "program": prog.functional})(x)
        a, b = _leaves(out), _leaves(ref)
        assert len(a) == len(b)
        assert all(torch.equal(u, v) for u, v in zip(a, b))
    eng = host["engine_thread"]
    assert eng["on_engine_thread"] and eng["cpu_s"] >= 0.0
    assert (eng["voluntary_switches"] is None) == (
        eng["involuntary_switches"] is None) == (not eng["switches_counted"])
    cg, reason = host["cgroup"], host["cgroup_reason"]
    assert cg is not None or reason
    if cg is not None:
        assert set(smoke.CGROUP_COUNTS) <= set(cg)
        assert (cg["nr_throttled"] is None) == (reason is not None)
    polls = host["poll_counts"]
    assert polls == be.poll_counts
    assert polls["polls"] > 0 and polls["queries"] >= count[1]


def _to_cpu(tree):
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_cpu(v) for v in tree]
    return tree.cpu()


@pytest.mark.cuda
@pytest.mark.parametrize("arch,replace", [
    ("qwen2-moe-a2.7b", {"n_experts": 20}), ("zamba2-7b", {}),
    ("qwen1.5-32b", {"kv_cache_dtype": "int8"}), ("deepseek-v2-236b", {}),
    ("gemma2-27b", {}), ("pixtral-12b", {}), ("whisper-tiny", {})],
    ids=["moe_capacity", "hybrid", "int8_cache", "mla", "gemma2", "vlm",
         "encdec"])
def test_new_families_on_the_card_match_the_cpu(arch, replace):
    """The moe family (capacity path), the hybrid, the int8 cache, MLA,
    gemma2, the vlm and whisper's encoder-decoder in f32: prefill and one
    decode step through the kernels on the card against the plain versions
    on the CPU, from the same parameters. An int8 code may land one step
    apart where the card's f32 projection rounds differently: 1e-3 on the
    logits."""
    _need_cuda()
    cfg = get_reduced(arch).replace(dtype="float32", **replace)
    gm, cm = build_model(cfg), build_model(cfg, device="cpu")
    gp = gm.init_params(0)
    cp = _to_cpu(gp)
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, cfg.vocab_size, (2, 16))
    frames = rng.standard_normal((2, cfg.encoder_frames or 1, cfg.d_model))
    outs = []
    for m, p, dev in ((gm, gp, "cuda"), (cm, cp, "cpu")):
        tk = torch.from_numpy(tokens).to(dev)
        batch, step = {"tokens": tk, "cache": m.init_cache(2, 17)}, {}
        if cfg.family == "encdec":
            batch["frames"] = torch.from_numpy(frames).float().to(dev)
            step["enc_out"] = m.encode(p, batch["frames"])
        pl, cache = m.prefill(p, batch)
        dl, _ = m.decode_step(p, {"tokens": tk[:, :1], "cache": cache,
                                  **step})
        outs.append((pl.cpu(), dl.cpu()))
    for a, b in zip(*outs):
        torch.testing.assert_close(a, b, rtol=1e-3, atol=1e-3)


@pytest.mark.cuda
def test_moe_capacity_prefill_repeats_its_bits_on_the_card():
    """The capacity path combines a token's expert outputs without
    atomics, so two prefills give the same bits (a served MoE task's donor
    cache and its check's)."""
    _need_cuda()
    m = build_model(get_reduced("qwen2-moe-a2.7b").replace(
        n_experts=20, dtype="bfloat16"))
    p = m.init_params(0)
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, m.cfg.vocab_size, (4, 64))).cuda()
    (a, ca), (b, cb) = (m.prefill(p, {"tokens": tokens,
                                      "cache": m.init_cache(4, 65)})
                        for _ in range(2))
    assert torch.equal(a, b)
    assert torch.equal(ca["layers"]["k"], cb["layers"]["k"])


@pytest.mark.cuda
def test_realtime_staged_cnn_on_cuda_streams():
    """A staged CNN served on the card: every lane's stream is made and
    warmed before the clock, and no port kernel runs (cuDNN does the
    convolutions)."""
    _need_cuda()
    from repro_torch.kernels import KERNELS, reset_counts
    model = BUILDERS["resnet18"](width=8)
    reset_counts()
    specs = [staged_cnn_taskspec(model, priority=p, jps=20.0, input_hw=64,
                                 tag=tag)
             for p, tag in ((api.HP, "-hp"), (api.LP, "-lp"))]
    srv = (api.ServerConfig.realtime().tasks(specs).contexts(2).streams(2)
           .oversubscribe(2.0).device(api.DeviceModel(n_units=2.0))
           .horizon_ms(800.0).realtime_io(input_hw=64).build())
    m = srv.run()
    assert m.completed[api.HP] > 0
    assert srv.backend.worker_exceptions == 0
    assert srv.backend.warm_s > 0 and len(srv.backend._streams) == 4
    assert all(fn.counts.launches == 0 and fn.counts.plain_cuda_calls == 0
               for fn in KERNELS.values())


def _served_resnet18(chaos=None):
    """ResNet18 at width 8 served 800 ms on 2 x 2 lanes (with ``chaos``
    where given); returns the server, its metrics, the instances the
    worker pool was handed and, for each stage begun on the engine
    thread, the ms from its launch to its begin."""
    from repro_torch.kernels import reset_counts
    model = BUILDERS["resnet18"](width=8)
    reset_counts()
    specs = [staged_cnn_taskspec(model, priority=p, jps=20.0, input_hw=64,
                                 tag=tag)
             for p, tag in ((api.HP, "-hp"), (api.LP, "-lp"))]
    cfg = (api.ServerConfig.realtime().tasks(specs).contexts(2).streams(2)
           .oversubscribe(2.0).device(api.DeviceModel(n_units=2.0))
           .horizon_ms(800.0).realtime_io(input_hw=64))
    if chaos is not None:
        cfg = cfg.chaos(chaos)
    srv = cfg.build()
    pooled, submit = [], srv.backend._pool.submit

    def counted(fn, lane, inst):
        if inst is not None:
            pooled.append(inst)
        return submit(fn, lane, inst)
    srv.backend._pool.submit = counted
    late, begin = [], srv.backend._begin

    def begun(rec):
        late.append((time.perf_counter() - rec.t0) * 1000.0)
        return begin(rec)
    srv.backend._begin = begun
    return srv, srv.run(), pooled, late


@pytest.mark.cuda
def test_served_stages_are_enqueued_on_the_engine_thread():
    """Every payload stage of a served ResNet18 is enqueued on the engine
    thread and harvested by polling its end event: none goes to the worker
    pool, each is one replay, one graph pool a lane, and each HP job's
    parts sum to its response."""
    _need_cuda()
    srv, m, pooled, late = _served_resnet18()
    be = srv.backend
    g = be.graph_summary()
    assert m.completed[api.HP] > 0 and be.worker_exceptions == 0
    assert pooled == [] and g["pool_stage_runs"] == 0
    assert g["stage_runs"] == g["replays"] == len(late) > 0
    assert g["run_pools"] == 4 and g["pools"] == 5
    parts = be.hp_response_parts()
    assert parts["jobs"] == len(m.response_ms[api.HP])
    assert parts["sum_err_ms"] <= 0.01


@pytest.mark.cuda
def test_stalled_stages_on_the_card_start_late_on_the_engine_thread():
    """A chaos stall on about half the launches: the engine thread
    enqueues each such stage once its stall has passed, and no stage goes
    to the worker pool; every stage is still one replay, and the HP jobs'
    parts (a stall within the stream wait) still sum to their responses."""
    _need_cuda()
    srv, m, pooled, late = _served_resnet18(
        api.ChaosPlan(seed=3, stall_rate=0.5, stall_ms=2.0))
    be = srv.backend
    g = be.graph_summary()
    assert m.completed[api.HP] > 0 and be.worker_exceptions == 0
    assert pooled == [] and g["pool_stage_runs"] == 0
    assert not be._pool._threads
    assert g["stage_runs"] == g["replays"] == len(late) > 0
    # the stalled ones begun by the poll, the stall after their launch
    assert 0 < sum(1 for ms in late if ms >= 2.0) < len(late)
    assert be.hp_response_parts()["sum_err_ms"] <= 0.01


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(BUILDERS))
def test_cnn_stages_on_the_card_match_the_cpu(name, monkeypatch):
    """Every stage at width 8 and input 65 (odd maps, asymmetric SAME
    padding): the card within 1e-3 of each output's scale of the CPU
    (``stage_errors``, which chip_smoke.py's output check calls too), in
    f32: building on the card turns cuDNN's TF32 off (torch's default lets
    cuDNN take TF32, which misses this tolerance)."""
    _need_cuda()
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    model = BUILDERS[name](width=8, seed=1)
    assert not torch.backends.cudnn.allow_tf32
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (2, 65, 65, 3)).astype(np.float32))
    errs = stage_errors(model, x)
    assert len(errs) == 4 and all(e <= 1e-3 for e in errs), errs


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(2, 128, 4, 16, 1, 16, 32),
                                   (1, 192, 6, 64, 2, 128, 96),
                                   (2, 512, 8, 64, 1, 128, 256),
                                   (2, 512, 8, 64, 2, 64, 128),
                                   (4, 512, 80, 64, 1, 128, 256)])
def test_cuda_ssd_matches_plain_version(dtype, shape):
    """B, L, H, P, G, N, chunk: ragged tiles (chunk 96), G = 2, the full
    model's P 64 / N 128 / chunk 256, four chunks at N 64, the donor
    prefill's full shapes, each without and with a non-zero initial state,
    through the instance ``ssd_instance`` names (bf16 at P 64, N 64 or 128
    and a chunk a multiple of 64: ``tensor_core``, its state pass and its
    output kernel a call; ``cuda_core``, one kernel a call)."""
    _need_cuda()
    tdt, tol = DTYPES[dtype]
    tol = max(tol, 5e-4)
    b_, ln, h, p, g, n, chunk = shape
    rng = np.random.default_rng(7)

    def r(*s):
        return torch.from_numpy(rng.standard_normal(s, np.float32)).to(
            tdt).cuda()
    x, bm, cm = r(b_, ln, h, p), r(b_, ln, g, n), r(b_, ln, g, n)
    dt = torch.from_numpy(rng.uniform(0.001, 0.1, (b_, ln, h)).astype(
        np.float32)).cuda()
    a_log = torch.from_numpy(rng.uniform(-0.5, 1.5, h).astype(
        np.float32)).to(tdt).cuda()
    s0 = torch.from_numpy(rng.standard_normal((b_, h, p, n), np.float32)
                          ).cuda()
    want = ("tensor_core" if dtype == "bfloat16" and p == 64
            and n in (64, 128) and chunk % 64 == 0 else "cuda_core")
    assert ssd_scan.ssd_instance(x, bm, chunk, cm) == want
    ssd_scan.ssd.counts.reset()
    for init in (None, s0):
        ya, sa = ssd_scan.ssd(x, dt, a_log, bm, cm, chunk, init)
        yb, sb = ssd_scan.ssd_plain(x, dt, a_log, bm, cm, chunk, init)
        torch.testing.assert_close(ya.float(), yb.float(), rtol=tol, atol=tol)
        torch.testing.assert_close(sa, sb, rtol=tol, atol=tol)
    kernels = ssd_scan.INSTANCE_KERNELS[want]
    assert ssd_scan.ssd.counts.by_instance == {k: 2 for k in kernels}
    assert ssd_scan.ssd.counts.launches == 2 * len(kernels)
    if want == "tensor_core":
        nc = ln // chunk
        assert ssd_scan.ssd.counts.grids == {
            "tensor_core/states": (b_ * h,),
            "tensor_core/out": (chunk // 64, nc, b_ * h)}


# around the shared-memory limits (5,792 lanes in f64, 11,616 in f32 on the
# H100: ce.resident_max) and past both (the tiled instance)
CONTENTION_MS = [1, 17, 129, 4096, 5792, 5793, 11616, 11617, 12289]


@pytest.mark.cuda
@pytest.mark.parametrize("m", CONTENTION_MS)
def test_cuda_contention_eta_matches_plain_version(m):
    _need_cuda()
    rng = np.random.default_rng(m)
    for dm in (api.DeviceModel(), api.DeviceModel(n_units=1e6,
                                                  l2_pressure=0.0)):
        cols = [rng.uniform(0.2, 4.0, m), rng.uniform(5.0, 40.0, m),
                rng.uniform(0.05, 0.9, m), rng.uniform(0.1, 8.0, m)]
        u, ns, mf, rem = (c.tolist() for c in cols)
        for comp in (True, False):
            ce.fused.counts.reset()
            want_rates = ce.rates_plain(dm, u, ns, mf, compensated=comp)
            assert ce.rates(dm, u, ns, mf, compensated=comp) == want_rates
            assert ce.rates(dm, *cols[:3], compensated=comp) == want_rates
            want = ce.fused_plain(dm, 3.5, u, ns, mf, rem, compensated=comp)
            for got in (ce.fused(dm, 3.5, u, ns, mf, rem, compensated=comp),
                        ce.fused(dm, 3.5, *cols, compensated=comp)):
                assert all(np.array_equal(a, b) for a, b in zip(got, want))
            inst = ce.contention_instance(m, torch.float64)
            assert ce.fused.counts.by_instance == {inst: 4}
        ce.fused_f32.counts.reset()
        want = ce.fused_f32_plain(dm, 3.5, u, ns, mf, rem)
        for got in (ce.fused_f32(dm, 3.5, u, ns, mf, rem),
                    ce.fused_f32(dm, 3.5, *cols)):
            for a, b in zip(got, want):
                np.testing.assert_allclose(a, b, rtol=2e-6, atol=0)
        assert ce.fused_f32.counts.by_instance == {
            ce.contention_instance(m, torch.float32): 2}


@pytest.mark.cuda
def test_cuda_contention_limit_and_probe():
    """The card grants the shared memory the limits assume, and the latency
    probe reads a plausible number of cycles an add."""
    _need_cuda()
    assert ce.smem_optin(torch.device("cuda")) == ce.H100_SMEM_OPTIN
    for dtype in (torch.float64, torch.float32):
        for mode in ce.PROBE_MODES:
            cycles = ce.chain_cycles(dtype, mode)
            assert 1.0 <= cycles < 200.0, (dtype, mode, cycles)


@pytest.mark.cuda
def test_epoch_engine_rate_groups_on_the_kernel(monkeypatch):
    """Threshold 1: every rate-group through the CUDA f64 kernel, and the
    run is the heap engine's, decision for decision."""
    _need_cuda()
    specs = [api.TaskSpec(name=f"t{i}", period_ms=20.0 + 5 * i,
                          priority=api.HP if i == 0 else api.LP,
                          stages=[api.StageProfile(f"t{i}/s{j}", 3.0 + j,
                                                   n_sat=20.0, mem_frac=0.4)
                                  for j in range(2)])
             for i in range(4)]

    def run(engine):
        cfg = (api.ServerConfig.sim().tasks(specs).contexts(2).streams(2)
               .oversubscribe(2.0).horizon_ms(400.0).seed(1)
               .record_decisions().engine(engine))
        srv = cfg.build()
        m = srv.run()
        return srv.decisions, m.summary()
    heap = run("heap")
    monkeypatch.setenv("DARIS_EPOCH_KERNEL_MIN", "1")
    ce.fused.counts.reset()
    assert run("epoch") == heap
    assert ce.fused.counts.launches > 0
    assert ce.fused.counts.plain_cuda_calls == 0


def diurnal_trace(rng, base_per_ms, horizon_ms):
    """benchmarks/perf_engine.py's thinning draw of a diurnal Poisson
    trace (peak 1.8x base, one sine cycle over the horizon)."""
    peak = base_per_ms * 1.8
    times, t = [], 0.0
    while True:
        t += float(rng.exponential(1.0 / peak))
        if t >= horizon_ms:
            return times
        lam = base_per_ms * (1.0 + 0.8 * np.sin(
            2.0 * np.pi * t / horizon_ms))
        if float(rng.uniform()) * peak < lam:
            times.append(t)


@pytest.mark.cuda
def test_reduced_fleet_on_the_kernel(monkeypatch):
    """The 64-device diurnal fleet cut to 8 devices and 300 ms, on a
    cluster server: at threshold 1 every rate-group (one device's lanes,
    that device's model) goes through the CUDA f64 kernel, and the run is
    the heap engine's, bit for bit."""
    _need_cuda()
    from repro_torch.serving.profiles import device
    horizon, specs = 300.0, [
        api.TaskSpec(name=f"svc{i:03d}", period_ms=24.0, priority=api.LP,
                     stages=[api.StageProfile(f"svc{i:03d}/s{j}", 2.0,
                                              n_sat=20.0, mem_frac=0.3)
                             for j in range(2)])
        for i in range(8 * 3)]

    def run(engine):
        cfg = (api.ServerConfig.cluster(8).tasks(specs).contexts(4)
               .streams(1).oversubscribe(4.0).device(device())
               .horizon_ms(horizon).seed(0).record_decisions().engine(engine))
        for i, s in enumerate(specs):
            cfg.arrival(s.name, api.TraceArrival(diurnal_trace(
                np.random.default_rng(9000 + i), 1.0 / 24.0, horizon)))
        srv = cfg.build()
        m = srv.run()
        return (srv.decisions, m.summary(),
                {k: [v.hex() for v in vs] for k, vs in m.response_ms.items()})
    heap = run("heap")
    monkeypatch.setenv("DARIS_EPOCH_KERNEL_MIN", "1")
    ce.fused.counts.reset()
    assert run("epoch") == heap
    assert ce.fused.counts.launches > 0
    assert ce.fused.counts.plain_cuda_calls == 0
