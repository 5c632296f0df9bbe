# Copy of src/repro/core/partition.py; only this line differs (tests/test_torch_isolation.py checks it).
"""Spatial partitioning with oversubscription (paper Eq. 9).

N_SM = ceil_even(OS * N_SM,max / N_c), 1 <= OS <= N_c. Units are SMs on the
paper's GPU and chips on a TPU pod slice (DESIGN.md §2) — the geometry is
identical. With OS > 1 the wrap-around allocation makes contexts overlap,
so idle capacity in one context is usable by its neighbours (the core
oversubscription benefit the paper measures).

Device-relative indices: a context index is whatever key its scheduler
assigned — a plain int on a single device, a ``(device, k)`` tuple under
the cluster layer (repro/cluster). Nothing in the geometry depends on the
key shape; ``ContextTable`` keeps both usages working through one type.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Hashable, List, Set

CtxKey = Hashable   # int (single device) | (device, int) (cluster layer)


def ceil_even(x: float) -> int:
    v = math.ceil(x)
    return v + (v % 2)if v % 2 else v


@dataclasses.dataclass
class Context:
    index: CtxKey
    units: Set[int]                 # unit ids (overlapping when OS > 1)
    n_streams: int
    alive: bool = True

    @property
    def cap(self) -> float:
        return float(len(self.units))


class ContextTable(dict):
    """Context registry keyed by context index.

    Historically ``DarisScheduler.contexts`` was a list whose positions
    doubled as indices; the cluster layer namespaces indices as
    ``(device, k)`` tuples, which no list can hold. This table keeps both
    call styles alive: it *indexes* like a mapping (``table[key]``) and
    *iterates* like the historic list (``for ctx in table`` yields
    ``Context`` objects in insertion order, which is creation order).
    ``in`` tests keys, as for any mapping."""

    def __iter__(self):
        return iter(self.values())

    def append(self, ctx: Context) -> None:
        """List-style registration: key the context by its own index."""
        self[ctx.index] = ctx


def make_contexts(n_contexts: int, n_streams: int, oversubscription: float,
                  n_units: int) -> List[Context]:
    """Eq. 9 allocation. OS=1 -> disjoint partitions; OS=N_c -> full
    sharing; intermediate values overlap neighbours (wrap-around)."""
    os_v = min(max(oversubscription, 1.0), float(n_contexts))
    per_ctx = min(ceil_even(os_v * n_units / n_contexts), n_units)
    out = []
    stride = n_units / n_contexts
    for k in range(n_contexts):
        start = int(round(k * stride)) % n_units
        units = {(start + i) % n_units for i in range(per_ctx)}
        out.append(Context(index=k, units=units, n_streams=n_streams))
    return out


def reconfigure(n_contexts: int, n_streams: int, oversubscription: float,
                n_units: int, base_index: int = 0) -> List[Context]:
    """Eq. 9 re-derivation for a new partition shape.

    Returns fresh ``Context`` objects carrying the wrap-around geometry of
    ``make_contexts`` but indexed from ``base_index``: a live scheduler
    retires its old contexts in place (their indices stay addressable for
    in-flight work) and appends these, so an online reshape never reuses
    an index and every queued/running stage keeps a valid home.
    """
    if n_contexts < 1:
        raise ValueError(f"need >= 1 context, got {n_contexts}")
    out = make_contexts(n_contexts, n_streams, oversubscription, n_units)
    for ctx in out:
        ctx.index += base_index
    return out


def overlap_matrix(contexts: List[Context]) -> List[List[int]]:
    n = len(contexts)
    return [[len(contexts[a].units & contexts[b].units) for b in range(n)]
            for a in range(n)]


# ------------------------------------------------------------ introspection
# (static analysis — repro.analysis.schedcheck — reads oversubscription
# interference through these instead of re-deriving Eq. 9 on its own)

def unit_residency(contexts: List[Context]) -> Dict[int, int]:
    """unit id -> number of the given contexts whose Eq. 9 allocation
    includes it (1 everywhere at OS=1; grows with oversubscription)."""
    res: Dict[int, int] = {}
    for c in contexts:
        for u in c.units:
            res[u] = res.get(u, 0) + 1
    return res


def max_coresidency(contexts: List[Context]) -> int:
    """Worst-case unit sharing: the max number of contexts co-resident on
    any single unit — the interference degree the oversubscribed wrap-
    around allocation creates (1 = disjoint partitions)."""
    res = unit_residency(contexts)
    return max(res.values()) if res else 0


def interference_sets(contexts: List[Context]) -> Dict[CtxKey, List[CtxKey]]:
    """ctx index -> indices of the other given contexts sharing at least
    one unit with it (the co-resident set whose busy lanes contend for
    the same SMs under OS > 1)."""
    out: Dict[CtxKey, List[CtxKey]] = {}
    for a in contexts:
        out[a.index] = [b.index for b in contexts
                        if b.index != a.index and a.units & b.units]
    return out
