"""The port's dry-run, roofline and the kernel operators' fake shapes and
FLOP formulas.

* The reference's tiny-mesh dry-run cells (``tests/test_staging_and_
  sharding.py``'s ``DRYRUN_CELLS``) give status ``ok`` and FLOPs > 0 on
  fake tensors over the ``"fake"`` process group (the train cell is in
  ``test_torch_dryrun_train.py``, a file of its own for its minutes).
* On one rank (``unit`` mesh) the dry-run's FLOPs a device equal
  ``FlopCounterMode``'s count of the same step run on real CPU tensors
  (reduced configs), as the card's run must equal it on the H100.
* A train cell of more microbatches than ``ACCUM_RUNS`` measured from
  two short accumulations gives the whole run's artifact, seconds aside;
  a shorter one and a serving cell run whole.
* ``roofline_row`` equals the reference's with the reference's three
  peaks patched to the H100's.
* Each operator's fake kernel gives its plain version's output shapes and
  dtypes, and its FLOP formula a hand count.
"""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import shape_by_name  # noqa: E402
from repro_torch.kernels import decode_attention as dec  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import rmsnorm as rms  # noqa: E402
from repro_torch.kernels import ssd_scan  # noqa: E402
from repro_torch.launch import dryrun, roofline  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
DRYRUN_CELLS = [("qwen2-moe-a2.7b", "decode_32k", "tiny"),
                ("mamba2-2.7b", "prefill_32k", "tiny-multi")]


def run_cli(args, out):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               PYTHONWARNINGS="ignore", OMP_NUM_THREADS="1")
    res = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun",
                          *args, "--out", str(out)], env=env,
                         capture_output=True, text=True, timeout=900)
    assert res.returncode == 0, res.stdout[-2000:] + res.stderr[-2000:]
    return res.stdout


@pytest.mark.parametrize("arch,shape,mesh", DRYRUN_CELLS)
def test_dryrun_tiny_mesh_subprocess(arch, shape, mesh, tmp_path):
    run_cli(["--arch", arch, "--shape", shape, "--mesh", mesh], tmp_path)
    art = json.loads((tmp_path / f"{arch}__{shape}__{mesh}.json")
                     .read_text())
    assert art["status"] == "ok"
    assert art["flops_per_device"] > 0
    assert art["cost_per_device"]["flops"] == art["flops_per_device"]
    assert art["n_chips"] == 8
    assert art["model_flops"] > 0 and art["peak_bytes_per_device"] > 0
    assert art["collectives_per_device"]["total_bytes"] > 0
    for key in ("mesh_shape", "param_counts", "analytic_hbm_bytes_global",
                "fits_80gb"):
        assert key in art


@pytest.mark.parametrize("arch,shape", [
    ("smollm-135m", "prefill_32k"), ("smollm-135m", "decode_32k"),
    ("smollm-135m", "train_4k"), ("qwen2-moe-a2.7b", "decode_32k"),
    ("mamba2-2.7b", "prefill_32k")])
def test_unit_mesh_flops_equal_a_real_run(arch, shape):
    """The dry-run's FLOPs at mesh 1 x 1 are ``FlopCounterMode``'s count of
    the same step run for real (CPU tensors, reduced config, cut cell)."""
    from torch.utils.flop_counter import FlopCounterMode
    extra = {"reduced": True, "global_batch": 2, "accum": 2,
             "remat": "dots", "q_chunk": 0}
    seq = {"train_4k": 64, "prefill_32k": 256, "decode_32k": 32}[shape]
    cell = dataclasses.replace(shape_by_name(shape), seq_len=seq,
                               global_batch=2)
    orig = dryrun.shape_by_name
    dryrun.shape_by_name = lambda name: cell
    try:
        art = dryrun.run_cell(arch, shape, "unit", extra=extra)
        mesh = dryrun.fake_mesh("unit")
        built = dryrun.build_cell(arch, shape, mesh, extra=extra)
    finally:
        dryrun.shape_by_name = orig
    # the same step on real tensors: parameters, optimizer state, batch
    # and cache made for real at the local shapes the dry-run used

    def real(tree):
        if isinstance(tree, dict):
            return {k: real(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [real(v) for v in tree]
        if tree.dtype in (torch.int32, torch.int64):
            return torch.zeros(tree.shape, dtype=tree.dtype)
        return torch.randn(tree.shape).to(tree.dtype) * 0.02
    model, params = built["model"], real(built["params"])
    batch = real(built["batch"])
    if "cache" in batch:               # an empty cache, as the card's run
        from repro_torch.models import transformer
        batch["cache"] = transformer.init_cache(
            model.cfg, cell.global_batch, cell.seq_len, torch.device("cpu"))
    grad = torch.enable_grad if cell.kind == "train" else torch.no_grad
    with grad(), FlopCounterMode(display=False) as fc:
        if cell.kind == "train":
            from repro_torch.training.optimizer import (AdamWConfig,
                                                        adamw_init)
            from repro_torch.training.train_step import make_train_step
            step = make_train_step(model, AdamWConfig(), q_chunk=0,
                                   remat="dots", accum=2)
            step(params, adamw_init(params, AdamWConfig()), batch)
        elif cell.kind == "prefill":
            model.prefill(params, batch, q_chunk=0)
        else:
            model.decode_step(params, batch)
    assert art["status"] == "ok"
    assert fc.get_total_flops() == art["flops_per_device"] > 0


def _cut_train_cell(monkeypatch, accum: int) -> dict:
    """A reduced smollm-135m train_4k cell cut to 64 tokens, 4 sequences
    a microbatch on each of the mesh's data ranks, ``accum`` microbatches;
    returns its ``extra``."""
    cell = dataclasses.replace(shape_by_name("train_4k"), seq_len=64,
                               global_batch=4 * accum)
    monkeypatch.setattr(dryrun, "shape_by_name", lambda name: cell)
    return {"reduced": True, "global_batch": 4 * accum, "accum": accum,
            "remat": "dots", "q_chunk": 0}


TIMES = ("build_s", "run_s", "accum_run")


@pytest.mark.parametrize("mesh,accum", [("tiny", 8), ("2x2", 6)])
def test_a_long_train_cell_from_two_short_accumulations_equals_it_whole(
        mesh, accum, monkeypatch):
    """A train cell of more microbatches than ``ACCUM_RUNS`` is measured
    at those two accumulations and extrapolated: its artifact equals the
    whole run's in every key but the seconds and ``accum_run`` (FLOPs,
    collective bytes and calls by kind, peak and resident bytes, its own
    ``accum``)."""
    extra = _cut_train_cell(monkeypatch, accum)
    short = dryrun.run_cell("smollm-135m", "train_4k", mesh, extra=extra)
    whole = dryrun.run_cell("smollm-135m", "train_4k", mesh, extra=extra,
                            whole=True)
    assert short["accum_run"] == list(dryrun.ACCUM_RUNS)
    assert whole["accum_run"] == [accum] == [short["accum"]]
    coll = whole["collectives_per_device"]
    assert {"all-gather", "reduce-scatter", "all-reduce"} <= set(
        coll["counts"])
    for k in TIMES:
        short.pop(k), whole.pop(k)
    assert short == whole


def test_a_short_train_cell_and_a_serving_cell_run_whole(monkeypatch):
    """A train cell of no more microbatches than ``ACCUM_RUNS``' last runs
    every one of them, and a serving cell its one step: ``accum_run`` is
    the cell's own ``accum``."""
    extra = _cut_train_cell(monkeypatch, max(dryrun.ACCUM_RUNS))
    art = dryrun.run_cell("smollm-135m", "train_4k", "2x2", extra=extra)
    assert art["accum_run"] == [art["accum"]] == [max(dryrun.ACCUM_RUNS)]
    mesh = dryrun.fake_mesh("2x2")
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode():
        built = dryrun.build_cell("smollm-135m", "train_4k", mesh,
                                  extra=dict(extra, accum=2))
        seen = []
        run_with = built["run_with"]
        built["run_with"] = lambda n: seen.append(n) or run_with(n)
        m = dryrun.measure_cell(built)
    assert m["accum_run"] == [2] and seen == []
    monkeypatch.undo()
    art = dryrun.run_cell("smollm-135m", "decode_32k", "2x2",
                          extra={"reduced": True, "global_batch": 2})
    assert art["accum_run"] == [1] == [art["accum"]]


def test_roofline_row_matches_reference_with_h100_peaks(monkeypatch):
    jrl = pytest.importorskip("repro.launch.roofline")
    monkeypatch.setattr(jrl, "PEAK_FLOPS", roofline.PEAK_FLOPS)
    monkeypatch.setattr(jrl, "HBM_BW", roofline.HBM_BW)
    monkeypatch.setattr(jrl, "LINK_BW", roofline.LINK_BW)
    ref_art = {"arch": "a", "shape": "s", "mesh": "single", "n_chips": 256,
               "cost_per_device": {"flops": 3.0e13,
                                   "bytes accessed": 1.0e9},
               "hlo_cost_per_device": {"flops": 4.0e13,
                                       "coll_total_bytes": 2.0e9},
               "collectives_per_device": {"total_bytes": 1.5e9},
               "analytic_hbm_bytes_global": 5.0e12, "model_flops": 6.0e15,
               "peak_bytes_per_device": 3 * 2 ** 30, "fits_16gb": True}
    assert roofline.roofline_row(ref_art) == jrl.roofline_row(ref_art)
    port_art = {"arch": "b", "shape": "s", "mesh": "single", "n_chips": 8,
                "cost_per_device": {"flops": 2.0e12},
                "collectives_per_device": {"total_bytes": 7.0e8},
                "analytic_hbm_bytes_global": 1.0e11, "model_flops": 1.0e13,
                "peak_bytes_per_device": 2 ** 34, "fits_80gb": True}
    ours, ref = roofline.roofline_row(port_art), jrl.roofline_row(port_art)
    assert ours.pop("fits") is True and ref.pop("fits") is None
    assert ours == ref
    assert roofline.fmt_table([roofline.roofline_row(ref_art)])


def _fake(shape, dtype=torch.bfloat16):
    return torch.empty(shape, dtype=dtype)


def test_operators_fake_shapes_and_flop_formulas():
    """Fake tensors: each operator's outputs have its plain version's
    shapes and dtypes (real CPU tensors of the same shapes), no launch,
    no plain call; its count under FlopCounterMode is the hand count."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils.flop_counter import FlopCounterMode
    b, h, kv, s, dh = 2, 4, 2, 128, 16
    cases = {
        # causal: query tile 0 reads 64 keys, tile 1 reads 128
        "flash": (lambda t: fa.flash_attention(t((b, h, s, dh)),
                                               t((b, kv, s, dh)),
                                               t((b, kv, s, dh))),
                  4 * b * h * dh * (64 * 64 + 64 * 128)),
        # keys of their own length, not causal: every query reads all 100
        "flash_cross": (lambda t: fa.flash_attention(
            t((b, h, 10, dh)), t((b, kv, 100, dh)), t((b, kv, 100, dh)),
            causal=False), 4 * b * h * dh * 10 * 100),
        # a window of 64 at S 192: tile 2 starts at key 64
        "flash_window": (lambda t: fa.flash_attention(
            t((b, h, 192, dh)), t((b, kv, 192, dh)), t((b, kv, 192, dh)),
            window=64), 4 * b * h * dh * 64 * (64 + 128 + 128)),
        "decode": (lambda t: dec.decode_attention(
            t((b, h, dh)), t((b, kv, 40, dh)), t((b, kv, 40, dh)),
            torch.zeros(40, dtype=torch.int32) if t is torch.randn
            else torch.empty(40, dtype=torch.int32),
            torch.zeros(b, dtype=torch.int32) if t is torch.randn
            else torch.empty(b, dtype=torch.int32)),
                   4 * b * h * 40 * dh),
        "rmsnorm": (lambda t: rms.rmsnorm(t((6, 32)), t((32,))), 0),
        "rmsnorm_residual": (lambda t: rms.rmsnorm_residual(
            t((6, 32)), t((6, 32)), t((32,))), 0),
        # 2 chunks of 32, 4 heads, P 8, N 16: per chunk and head
        # 2 Q^2 N + 2 Q^2 P + 4 Q N P
        "ssd": (lambda t: ssd_scan.ssd(
            t((1, 64, 4, 8)), t((1, 64, 4)).float().abs(),
            t((4,)).float(), t((1, 64, 1, 16)), t((1, 64, 1, 16)), 32),
                1 * 4 * 2 * (2 * 32 * 32 * 16 + 2 * 32 * 32 * 8
                             + 4 * 32 * 16 * 8)),
    }
    for name, (call, want) in cases.items():
        real = call(lambda shape: torch.randn(shape).to(torch.bfloat16))
        with FakeTensorMode(), FlopCounterMode(display=False) as fc:
            got = call(_fake)
        real = real if isinstance(real, tuple) else (real,)
        got = got if isinstance(got, tuple) else (got,)
        for r, g in zip(real, got):
            assert tuple(g.shape) == tuple(r.shape), name
            assert g.dtype == r.dtype, name
        assert fc.get_total_flops() == want, name
    assert fa.visited_keys(128, 128, True, 0) == 64 * 64 + 64 * 128
