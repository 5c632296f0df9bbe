"""Staged payloads with AFET-style calibration: the paper's CNNs and LM
decode.

Counterpart of ``staged_cnn_taskspec`` and ``staged_lm_taskspec`` in
src/repro/serving/engine.py. As the reference jits each stage function
once, each stage here is a ``StageProgram`` (``serving/stage_graph.py``):
on the card a CUDA graph a stream, captured at its first call on that
stream into the lane's graph pool and replayed for every later job; on
the CPU the stage function called eagerly. A payload runs on whatever
stream is current, which the realtime backend sets to the lane's own; the
calibration's stream is one more lane. An LM stage program writes its
static copy of the cache slice in place (``make_lm_stage_fns(...,
in_place=True)``); the donor's slices are views it only copies from.
``t_alone`` per stage is one timed call after one warm-up call (on the
card the warm-up captures, so the timed call is a replay, as the
reference times its jitted call after the compile call), ended by a
stream synchronize.
"""
from __future__ import annotations

import functools
import time
from typing import Optional

import numpy as np
import torch

from ..core.task import StageProfile, TaskSpec
from ..device import DeviceLike, resolve_device, synchronize
from ..models.cnn import StagedCNN
from .stage_graph import Constant, StageProgram
from .staging import make_lm_stage_fns, slice_cache

__all__ = ["LmStage", "lm_stage", "staged_cnn_taskspec", "staged_lm_taskspec"]


def _calibrate(payloads, state, dev) -> list:
    """ms of one call of each payload in turn, after a warm-up call (on
    the card the stage program's capture, into the pool of the current
    stream's lane, so the timed call is a replay)."""
    times = []
    for fn in payloads:
        fn(state)                                 # warm-up
        synchronize(dev)
        t0 = time.perf_counter()
        out = fn(state)
        synchronize(dev)
        times.append((time.perf_counter() - t0) * 1000.0)
        state = out
    return times


def _resolve_model_device(model, device: DeviceLike) -> torch.device:
    dev = resolve_device(device)
    if model.device != dev:
        raise ValueError(f"the model lives on {model.device}, the payloads "
                         f"were asked to run on {dev}")
    return dev


def staged_cnn_taskspec(model: StagedCNN, *, priority: int, jps: float,
                        input_hw: int = 64, batch: int = 1,
                        tag: str = "", calibrate: bool = True,
                        n_sat: float = 40.0, mem_frac: float = 0.4,
                        device: DeviceLike = None,
                        params: Optional[dict] = None) -> TaskSpec:
    """Wrap a StagedCNN into a TaskSpec whose stage payloads are its stage
    functions, each a ``StageProgram``; ``t_alone`` is measured on this
    device (AFET-style) from an NHWC zero input of ``batch x input_hw x
    input_hw x 3``, or 1.0 ms a stage with ``calibrate=False``.

    Everything runs on the card unless ``device`` names another device,
    which must be the model's (``BUILDERS[name](device=...)``); there the
    payloads compute in f32, since a builder given the card turns cuDNN's
    TF32 off. ``params`` defaults to ``model.params``."""
    dev = _resolve_model_device(model, device)
    if params is None:
        params = model.params
    payloads = [StageProgram(lambda s, st=st: st(params, s),
                             name=f"{model.name}/s{j}")
                for j, st in enumerate(model.stages)]
    if calibrate:
        x0 = torch.zeros((batch, input_hw, input_hw, 3), dtype=torch.float32,
                         device=dev)
        times = _calibrate(payloads, x0, dev)
    else:
        times = [1.0] * len(payloads)
    stages = [StageProfile(name=f"{model.name}/s{j}", t_alone_ms=t,
                           n_sat=n_sat, mem_frac=mem_frac, overhead_ms=0.05,
                           payload=payloads[j])
              for j, t in enumerate(times)]
    return TaskSpec(name=f"{model.name}{tag}", period_ms=1000.0 / jps,
                    priority=priority, stages=stages, batch=batch)


def _lm_inputs(state, stage: int, donor_slice, fresh: torch.Tensor):
    """A staged LM state (a fresh job's made from ``fresh``) and stage
    ``stage``'s cache slice: the job's own where it has one, else the
    donor's."""
    if state is None or not isinstance(state, dict):
        state = {"hidden": fresh, "slices": {}}
    sl = state["slices"].get(stage)
    return state, (donor_slice if sl is None else sl)


def _lm_output(slices: dict, stage: int, out) -> dict:
    h, new_sl = out
    return {"hidden": h, "slices": {**slices, stage: new_sl}}


def lm_stage(state, *, stage: int, program, donor_slice: dict,
             fresh: torch.Tensor) -> dict:
    """Stage ``stage`` of a staged LM decode step: the job's hidden state
    (a fresh job's: one new token a sequence, ``fresh``) and this stage's
    cache slice (the job's own where it has one, else the donor's)
    through ``program``; the updated slice joins the job's state, so a
    migration moves hidden AND cache."""
    state, sl = _lm_inputs(state, stage, donor_slice, fresh)
    return _lm_output(state["slices"], stage, program(state["hidden"], sl))


class LmStage(functools.partial):
    """A staged LM payload, ``functools.partial(lm_stage, ...)`` whose
    program is a ``StageProgram``: its donor slice is resolved once (a
    ``Constant``), and a call (``prepare``, which the realtime backend
    enqueues alone between the stage's events, or the payload called)
    takes the job's hidden state and that, with ``lm_stage``'s dict work
    before it and after it (``StageCall.then``). ``ready`` is the lane-free
    part of ``prepare`` (the dict work before, ``then`` and the program's
    ``ready``), which the backend may take ahead of the stage's launch."""

    def __new__(cls, *args, **keywords):
        self = super().__new__(cls, *args, **keywords)
        if "donor_slice" in self.keywords:    # not so as a copy is restored
            self.donor = Constant(self.keywords["donor_slice"])
        return self

    def ready(self, state):
        kw = self.keywords
        state, sl = _lm_inputs(state, kw["stage"], self.donor, kw["fresh"])
        return kw["program"].ready(
            state["hidden"], sl,
            then=functools.partial(_lm_output, state["slices"], kw["stage"]))

    def prepare(self, state, lane=None):
        return self.ready(state).call(lane)

    def __call__(self, state):
        call = self.prepare(state)
        call.issue()
        return call.result()


def staged_lm_taskspec(model, *, priority: int, jps: float,
                       n_stages: int = 4, prompt_len: int = 16,
                       batch: int = 2, tag: str = "",
                       n_sat: float = 40.0, mem_frac: float = 0.5,
                       device: DeviceLike = None,
                       params: Optional[dict] = None) -> TaskSpec:
    """Wrap a staged LM decode step into a TaskSpec with real payloads.

    Each job is ONE decode step split across ``n_stages`` stage programs
    (``serving.staging.make_lm_stage_fns``, each a ``StageProgram``; each
    payload an ``LmStage``, a partial of ``lm_stage``). The inter-stage
    state is the hidden activation plus the KV-cache slices touched so
    far: each stage takes its layer slice of a prefilled donor cache
    (``serving.staging.slice_cache``) and threads the updated slice
    forward, so a migration moves hidden AND cache. The programs' stage
    functions write the new slots (or SSM state) into the program's
    static copy of the slice (``in_place=True``); each program's
    ``functional`` is the stage with the reference's functional update.

    Everything runs on the card unless ``device`` names another device,
    which must be the model's (``build_model(cfg, device=...)``).
    ``params`` defaults to ``model.init_params(0)``."""
    cfg = model.cfg
    dev = _resolve_model_device(model, device)
    if params is None:
        params = model.init_params(0)
    stage_fns = make_lm_stage_fns(model, n_stages=n_stages, in_place=True)
    functional = make_lm_stage_fns(model, n_stages=n_stages)
    # prefill a donor cache once with the model's own forward; every job
    # then decodes one token against (its own copy of) that cache
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (batch, prompt_len))).to(dev)
    _, donor = model.prefill(
        params, {"tokens": tokens,
                 "cache": model.init_cache(batch, prompt_len + 1)})
    pos = torch.tensor([prompt_len], dtype=torch.int32, device=dev)
    fresh = torch.zeros((batch, 1), dtype=torch.int32, device=dev)
    payloads = [LmStage(
        lm_stage, stage=i, fresh=fresh,
        donor_slice=slice_cache(cfg, donor, i, n_stages),
        program=StageProgram(
            lambda h, sl, fn=fn: fn(params, h, sl, pos),
            name=f"{cfg.name}/lm-s{i}",
            functional=lambda h, sl, fn=ffn: fn(params, h, sl, pos)))
        for i, (fn, ffn) in enumerate(zip(stage_fns, functional))]
    times = _calibrate(payloads, None, dev)
    stages = [StageProfile(name=f"{cfg.name}/lm-s{j}", t_alone_ms=t,
                           n_sat=n_sat, mem_frac=mem_frac,
                           overhead_ms=0.05, payload=payloads[j])
              for j, t in enumerate(times)]
    return TaskSpec(name=f"{cfg.name}{tag}", period_ms=1000.0 / jps,
                    priority=priority, stages=stages, batch=batch)
