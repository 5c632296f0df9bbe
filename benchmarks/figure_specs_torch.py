"""Named, analyzable figure scenarios: spec -> unbuilt ServerConfig.

The schedcheck CLI (``python -m repro.analysis.schedcheck --figure NAME``)
and the differential oracle resolve scenario names through this registry.
Each factory returns an **unbuilt** ``ServerConfig`` mirroring one cell of
the fig4_6 / fig12 / fig13 benchmark sweeps (smoke-sized horizons, seed
0), so the static analyzer and the simulator see the exact same
configuration object.

``*_light`` scenarios are intentionally under-loaded so their HP verdict
is GUARANTEED — they give the oracle a non-vacuous finite bound to
falsify and CI a shipped config that must stay GUARANTEED.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Tuple

from repro_torch.api import ServerConfig, TraceArrival
from repro_torch.serving.profiles import device, make_task
from repro_torch.serving.requests import table2_taskset

SMOKE_HORIZON_MS = 2000.0


def _base(specs, nc: int, os_: float,
          horizon: float = SMOKE_HORIZON_MS) -> ServerConfig:
    return (ServerConfig.sim()
            .tasks(specs)
            .contexts(nc).streams(1).oversubscribe(os_)
            .device(device())
            .horizon_ms(horizon).seed(0))


def _light_specs(n_hp: int = 2, n_lp: int = 2, jps: float = 30.0):
    return ([make_task("resnet18", priority=0, jps=jps, tag=f"-hp{i}")
             for i in range(n_hp)]
            + [make_task("resnet18", priority=1, jps=jps, tag=f"-lp{i}")
               for i in range(n_lp)])


# ------------------------------------------------------------------ fig4_6
def fig4_6_light() -> ServerConfig:
    """Under-loaded MPS 2x1 os=2 cell: HP GUARANTEED, finite bound."""
    return _base(_light_specs(), 2, 2.0)


def fig4_6_resnet18_mps6() -> ServerConfig:
    """The paper's headline RN18 MPS 6x1 os=6 cell at full Table II load
    (150% offered): LP is overloaded by design -> CONDITIONAL."""
    return _base(table2_taskset("resnet18"), 6, 6.0)


def fig4_6_unet_mps6() -> ServerConfig:
    return _base(table2_taskset("unet"), 6, 2.0)


def fig4_6_inceptionv3_mps8() -> ServerConfig:
    return _base(table2_taskset("inceptionv3"), 8, 8.0)


# ------------------------------------------------------------------ fig12
def fig12_diurnal() -> ServerConfig:
    """Timed reconfigure ramp (fig12 run_diurnal shape, smoke horizon)."""
    h = SMOKE_HORIZON_MS
    return (_base(table2_taskset("resnet18"), 4, 4.0, h)
            .reconfigure_at(h * 0.25, n_contexts=6, oversubscription=6.0)
            .reconfigure_at(h * 0.60, n_contexts=8, oversubscription=8.0)
            .reconfigure_at(h * 0.85, n_contexts=3, oversubscription=3.0))


def fig12_chaos() -> ServerConfig:
    """Fault + scale-out + repartition in one run (fig12 run_chaos)."""
    h = SMOKE_HORIZON_MS
    return (_base(table2_taskset("resnet18"), 6, 6.0, h)
            .fail_context_at(0, h * 0.3)
            .scale_out_at(h * 0.5)
            .reconfigure_at(h * 0.7, n_contexts=6, oversubscription=5.0))


def fig12_step() -> ServerConfig:
    """Offered load doubles mid-run via per-task step traces (the
    analyzer treats each trace as sporadic at its min release gap)."""
    h = SMOKE_HORIZON_MS
    specs = _light_specs()
    cfg = _base(specs, 3, 3.0, h)
    half = h / 2.0
    for i, spec in enumerate(specs):
        t = (i / len(specs)) * spec.period_ms
        times: List[float] = []
        while t <= h:
            times.append(t)
            t += spec.period_ms if t < half else spec.period_ms / 2.0
        cfg.arrival(spec.name, TraceArrival(times))
    return cfg


# ------------------------------------------------------------------ fig13
def _fleet_taskset(n_gpus: int, load_scale: float):
    import dataclasses
    out = []
    for g in range(n_gpus):
        for spec in table2_taskset("resnet18", load_scale=load_scale):
            out.append(dataclasses.replace(spec, name=f"g{g}-{spec.name}"))
    return out


def _cluster(n_gpus: int, specs, **cluster_kw) -> ServerConfig:
    return (ServerConfig.cluster(n_gpus, **cluster_kw)
            .tasks(specs)
            .contexts(4).streams(1).oversubscribe(4.0)
            .device(device())
            .horizon_ms(SMOKE_HORIZON_MS).seed(0))


def fig13_light() -> ServerConfig:
    """Under-loaded 2-GPU fleet: a light HP/LP set per device keeps the
    cluster bound finite (non-vacuous oracle coverage)."""
    import dataclasses
    specs = []
    for g in range(2):
        for spec in _light_specs(n_hp=1, n_lp=1):
            specs.append(dataclasses.replace(spec, name=f"g{g}-{spec.name}"))
    return (ServerConfig.cluster(2)
            .tasks(specs)
            .contexts(2).streams(1).oversubscribe(2.0)
            .device(device())
            .horizon_ms(SMOKE_HORIZON_MS).seed(0))


def fig13_homo_2gpu() -> ServerConfig:
    return _cluster(2, _fleet_taskset(2, 0.5))


def fig13_fail_1of4() -> ServerConfig:
    return (_cluster(4, _fleet_taskset(4, 0.5))
            .fail_device_at(1, SMOKE_HORIZON_MS * 0.3))


def fig13_hetero() -> ServerConfig:
    return _cluster(
        4, _fleet_taskset(4, 0.5),
        device_models=["a100", "v100", "rtx2080ti", "l4"])


_REGISTRY: Dict[str, Callable[[], ServerConfig]] = {
    "fig4_6_light": fig4_6_light,
    "fig4_6_resnet18_mps6": fig4_6_resnet18_mps6,
    "fig4_6_unet_mps6": fig4_6_unet_mps6,
    "fig4_6_inceptionv3_mps8": fig4_6_inceptionv3_mps8,
    "fig12_diurnal": fig12_diurnal,
    "fig12_chaos": fig12_chaos,
    "fig12_step": fig12_step,
    "fig13_light": fig13_light,
    "fig13_homo_2gpu": fig13_homo_2gpu,
    "fig13_fail_1of4": fig13_fail_1of4,
    "fig13_hetero": fig13_hetero,
}

ORACLE_SMOKE = ("fig4_6_light", "fig4_6_resnet18_mps6", "fig12_diurnal",
                "fig12_chaos", "fig12_step", "fig13_light",
                "fig13_fail_1of4")


def names() -> List[str]:
    return sorted(_REGISTRY)


def scenario(name: str) -> ServerConfig:
    try:
        return _REGISTRY[name]()
    except KeyError:
        raise KeyError(
            f"unknown figure scenario {name!r}; known: {', '.join(names())}"
        ) from None


def oracle_suite(names_: Tuple[str, ...] = ORACLE_SMOKE
                 ) -> List[Tuple[str, ServerConfig]]:
    """(label, unbuilt config) pairs for the differential oracle."""
    return [(n, scenario(n)) for n in names_]
