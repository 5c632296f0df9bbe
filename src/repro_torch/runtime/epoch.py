# Copy of src/repro/runtime/epoch.py; only this line differs (tests/test_torch_isolation.py checks it).
"""Array-programmed epoch engine: vectorized lane-state simulation.

``EpochSimBackend`` is the fleet-scale twin of ``SimBackend``
(runtime/backend.py). The heap engine keeps per-lane state in Python
lists and a versioned prediction heap; every running-set change costs
O(m log m) Python bytecode (one heappush per moved prediction, one
scalar rate assignment per lane). This engine keeps the hot per-lane
state — remaining work, rate, predicted ETA, integrated work, straggler
constants — in preallocated NumPy float64 columns indexed by a stable
lane-slot table, and advances the simulation in *epochs*:

  * ``advance`` computes every running lane's ETA in one array pass and
    pops the minimal-timestamp entry of the cohort (ties broken by a
    monotone prediction stamp — see the cohort-order contract below);
  * work integration (``rem -= rate*dt``, ``work += rate*dt``) is one
    vectorized pass instead of a per-lane Python loop;
  * rate recomputation re-derives only the *dirty rate-groups* (the
    devices whose running set actually changed) through the existing
    bit-exact ``rates_seq`` kernel, and above ``KERNEL_MIN`` lanes per
    group through the jitted JAX contention+ETA kernel
    (kernels/contention_eta.py).

Bit-exactness contract (locked by tests/test_epoch_engine.py)
-------------------------------------------------------------
The epoch path produces bit-identical metrics/digests to the heap path:

  * ``launch_values`` (backend.py) is the single shared per-launch
    scalar pipeline — both engines draw the same rng values in the same
    order (the module-level draw-order invariant).
  * Work integration applies the identical per-lane float sequence
    (``done = rate*dt; rem -= done; snap; work += done``) — vectorized
    elementwise IEEE-754 ops are the same ops.
  * Rates go through ``rates_seq`` per rate-group with the group built
    in the same order (lane insertion order), so every reduction sums
    the same floats left-to-right.
  * Cohort-order contract: the heap pops predictions by ``(eta, seq)``
    where ``seq`` is the push-order tie counter. Here every lane whose
    ETA *moved* during a prediction pass gets a fresh monotone stamp, in
    insertion order — exactly the order the heap engine pushes them —
    and ``advance`` breaks ETA ties by minimal stamp. Unmoved ETAs keep
    their old stamp, mirroring the heap's skip-if-unchanged incremental
    re-prediction (predict_eps=0.0).
  * Per-device dirty tracking is exact because a device's rates are a
    pure function of its own running set and its contexts' caps, which
    are immutable after creation (``add_context`` appends, an online
    ``reconfigure`` retires old Context objects in place and installs
    brand-new ones). Brownout edges and reconfigures conservatively
    mark every device dirty, exactly like the heap's global dirty bit.

Lazy work accounting: ``inst.work_done`` is only materialized from the
slot arrays when someone actually reads it — at stage completion, and
through the ``DarisScheduler.work_sync`` hook before a
``predicted_finish`` backlog scan. All other readers observe it after
one of those flush points (the watchdog/straggler kill paths reset it
to 0.0 *after* the lane left this backend, so the flush never
resurrects stale progress).
"""
from __future__ import annotations

import math
import os
from typing import Dict, List, Optional

import numpy as np

from ..core.mret import StageMret
from ..core.task import Job, StageInstance
from .engine_core import Completion, EngineCore
from .backend import launch_values

# EpochSimBackend.running entry layout (mirrors the sanitizer contract:
# entry[0] is the StageInstance):
#   [0] inst    StageInstance
#   [1] slot    row index into the per-lane state columns
#   [2] pos     position in the insertion-order table (_order/_alive)
_E_INST, _E_SLOT, _E_POS = range(3)


class EpochSimBackend:
    """Vectorized fluid-rate discrete-event substrate (virtual time).

    Drop-in twin of ``SimBackend`` behind ``ServerConfig.engine`` — see
    the module docstring for the layout and the bit-exactness contract.
    """

    EPS = 1e-6              # ms; snap-to-zero tolerance (same as SimBackend)
    KERNEL_MIN = 2048       # lanes per rate-group before the JAX kernel wins
    _ORDER_COMPACT_MIN = 64
    virtual_time = True

    def __init__(self, noise_sigma: float = 0.06,
                 rng: Optional[np.random.Generator] = None):
        self.noise_sigma = noise_sigma
        self.rng = rng
        self.core: Optional[EngineCore] = None
        self.now = 0.0
        self.running: Dict[tuple, list] = {}   # lane -> [inst, slot, pos]
        env = os.environ.get("DARIS_EPOCH_KERNEL_MIN", "")
        self._kernel_min = int(env) if env else self.KERNEL_MIN
        # per-lane state columns (slot-indexed, capacity-doubling)
        self._cap = 0
        self._rem = self._rate = self._eta = np.empty(0)
        self._work = self._start = self._cost = np.empty(0)
        self._floor = self._xfer = np.empty(0)
        self._stamp = np.empty(0, dtype=np.int64)
        self._dev = np.empty(0, dtype=np.int64)
        self._inst: List[Optional[StageInstance]] = []
        self._lane: List[Optional[tuple]] = []
        self._smret: List[Optional[StageMret]] = []
        self._eff_ns: List[float] = []      # effective profile columns as
        self._eff_mf: List[float] = []      # python floats (rates_seq input)
        self._cfail: List[bool] = []
        self._free: List[int] = []
        self._n = 0                          # slot high-water mark
        # stable insertion-order table: position -> slot, alive mask
        self._order = np.empty(0, dtype=np.int64)
        self._alive = np.empty(0, dtype=bool)
        self._order_n = 0
        self._live = 0
        # dirty rate-groups: device ids whose running set changed
        self._dirty: set = set()
        self._dirty_all = True
        self._next_stamp = 1
        # per-context lane index for the lazy work_done flush
        self._by_ctx: Dict[object, Dict[tuple, int]] = {}
        self._n_workers = -1

    # ----------------------------------------------------------- lifecycle
    def bind(self, core: EngineCore) -> None:
        self.core = core
        if self.rng is None:
            self.rng = core.rng   # shared stream: offsets then noise draws
        self._install_work_sync()

    def _install_work_sync(self) -> None:
        """Hook the lazy work_done flush into every scheduler that can
        run a ``predicted_finish`` backlog scan (cluster workers each
        run their own)."""
        sched = self.core.sched
        sched.work_sync = self._sync_ctx
        workers = getattr(sched, "workers", None)
        if workers is not None:
            for w in workers.values():
                w.work_sync = self._sync_ctx
            self._n_workers = len(workers)

    def start(self) -> None:
        self.now = 0.0

    def stop(self) -> None:
        pass

    def now_ms(self) -> float:
        return self.now

    def has_inflight(self) -> bool:
        return bool(self.running)

    # ------------------------------------------------------------- storage
    def _grow(self, cap: int) -> None:
        def f64(a):
            out = np.empty(cap)
            out[:self._n] = a[:self._n]
            return out
        self._rem, self._rate, self._eta = map(
            f64, (self._rem, self._rate, self._eta))
        self._work, self._start, self._cost = map(
            f64, (self._work, self._start, self._cost))
        self._floor, self._xfer = map(f64, (self._floor, self._xfer))
        stamp = np.empty(cap, dtype=np.int64)
        stamp[:self._n] = self._stamp[:self._n]
        self._stamp = stamp
        dev = np.empty(cap, dtype=np.int64)
        dev[:self._n] = self._dev[:self._n]
        self._dev = dev
        pad = cap - len(self._inst)
        self._inst.extend([None] * pad)
        self._lane.extend([None] * pad)
        self._smret.extend([None] * pad)
        self._eff_ns.extend([0.0] * pad)
        self._eff_mf.extend([0.0] * pad)
        self._cfail.extend([False] * pad)
        self._cap = cap

    def _alloc_slot(self) -> int:
        if self._free:
            return self._free.pop()
        if self._n == self._cap:
            self._grow(max(16, 2 * self._cap))
        s = self._n
        self._n += 1
        return s

    def _append_order(self, slot: int) -> int:
        n = self._order_n
        if n == self._order.size:
            cap = max(32, 2 * self._order.size)
            order = np.empty(cap, dtype=np.int64)
            order[:n] = self._order[:n]
            alive = np.zeros(cap, dtype=bool)
            alive[:n] = self._alive[:n]
            self._order, self._alive = order, alive
        self._order[n] = slot
        self._alive[n] = True
        self._order_n = n + 1
        self._live += 1
        return n

    def _compact_order(self) -> None:
        """Squeeze dead positions out of the insertion-order table
        (relative order of live slots — the cohort order — is
        preserved; running entries' positions are re-pointed)."""
        n = self._order_n
        live = self._order[:n][self._alive[:n]]
        k = live.size
        self._order[:k] = live
        self._alive[:k] = True
        self._alive[k:n] = False
        self._order_n = k
        for p, s in enumerate(live.tolist()):
            self.running[self._lane[s]][_E_POS] = p

    def maybe_compact(self) -> None:
        """Housekeeping hook (EngineCore pump pause path): same contract
        as SimBackend.maybe_compact — bound the dead fraction of the
        hot-path table while the daemon idles."""
        if (self._order_n > self._ORDER_COMPACT_MIN
                and 2 * self._live < self._order_n):
            self._compact_order()

    def _live_idx(self) -> np.ndarray:
        """Live slots in insertion order — the epoch cohort ordering."""
        self.maybe_compact()
        n = self._order_n
        return self._order[:n][self._alive[:n]]

    # ---------------------------------------------------------------- time
    def _integrate(self, t: float) -> None:
        """Advance the fluid integration to ``t`` in one array pass —
        the identical per-lane float sequence as SimBackend._advance_to,
        without materializing ``inst.work_done`` (lazy flush).

        Operates on the contiguous slot prefix ``[:n]`` instead of a
        live-index gather: dead slots carry rate 0.0 (``_remove``), so
        their update is an exact no-op and the pass needs no fancy
        indexing (a gather + scatter costs ~3x on these sizes)."""
        dt = t - self.now
        n = self._n
        if dt > 0 and n:
            done = self._rate[:n] * dt
            rem = self._rem[:n] - done
            self._rem[:n] = np.where(rem >= self.EPS, rem, 0.0)
            self._work[:n] += done
        self.now = t

    def advance(self, cap_ms: float) -> List[Completion]:
        n = self._n
        if self.running and n:
            self.maybe_compact()
            # dead and not-yet-predicted slots hold NaN etas; fmin's
            # reduce skips NaN without the nanmin all-NaN warning, and a
            # NaN result (no live prediction) fails the < test below
            tmin = np.fmin.reduce(self._eta[:n])
            if tmin < cap_ms:
                ties = np.flatnonzero(self._eta[:n] == tmin)
                if ties.size > 1:
                    # cohort-order contract: the heap pops equal
                    # timestamps in push order (its seq tie-break)
                    s = int(ties[np.argmin(self._stamp[ties])])
                else:
                    s = int(ties[0])
                t = float(tmin)
                self._integrate(t)
                inst = self._inst[s]
                cfail = self._cfail[s]
                # flush the completing lane's integrated work: the
                # finish hook divides transfer_ms by it
                inst.work_done = float(self._work[s])
                lane = self._lane[s]
                self._remove(lane)
                return [Completion(lane, inst, t - inst.start_ms,
                                   cfail)]
        self._integrate(cap_ms)
        return []

    def peek_eta(self) -> float:
        n = self._n
        if not self.running or n == 0:
            return math.inf
        tmin = float(np.fmin.reduce(self._eta[:n]))
        return math.inf if math.isnan(tmin) else tmin

    # ----------------------------------------------------------- execution
    @staticmethod
    def _dev_of(lane: tuple) -> int:
        # cluster lane keys are ((dev, ctx), slot); single-device keys
        # are (ctx, slot) on device 0 — same convention as the heap
        # engine's brownout lookup
        return lane[0][0] if isinstance(lane[0], tuple) else 0

    def launch(self, lane: tuple, inst: StageInstance) -> None:
        if lane in self.running:        # relaunch over a dead occupant
            self._remove(lane)
        work, eff, smret, cost, floor, xfer, cfail = launch_values(
            self.core, lane, inst, self.rng, self.noise_sigma)
        s = self._alloc_slot()
        self._rem[s] = work
        self._rate[s] = 0.0
        self._eta[s] = math.nan          # no live prediction yet
        self._work[s] = 0.0
        self._start[s] = inst.start_ms
        self._cost[s] = cost
        self._floor[s] = floor
        self._xfer[s] = xfer
        self._stamp[s] = 0
        dev = self._dev_of(lane)
        self._dev[s] = dev
        self._inst[s] = inst
        self._lane[s] = lane
        self._smret[s] = smret
        self._eff_ns[s] = eff.n_sat
        self._eff_mf[s] = eff.mem_frac
        self._cfail[s] = cfail
        pos = self._append_order(s)
        self.running[lane] = [inst, s, pos]
        self._by_ctx.setdefault(lane[0], {})[lane] = s
        self._dirty.add(dev)

    def _remove(self, lane: tuple) -> None:
        e = self.running.pop(lane, None)
        if e is None:
            return
        s, pos = e[_E_SLOT], e[_E_POS]
        self._alive[pos] = False
        self._live -= 1
        # dead slots must be inert under the contiguous [:n] passes:
        # rate 0.0 makes _integrate a no-op, NaN eta drops out of the
        # fmin reduce and the == tmin tie scan
        self._rate[s] = 0.0
        self._eta[s] = math.nan
        self._inst[s] = None
        self._smret[s] = None
        self._lane[s] = None
        self._free.append(s)
        ctx = self._by_ctx.get(lane[0])
        if ctx is not None:
            ctx.pop(lane, None)
        self._dirty.add(int(self._dev[s]))

    def cancel_ctx(self, ctx_idx) -> None:
        for lane in [ln for ln in self.running if ln[0] == ctx_idx]:
            self._remove(lane)

    def kill_lane(self, lane: tuple, inst: StageInstance) -> None:
        self._remove(lane)

    def on_job_done(self, job: Job) -> None:
        pass

    def on_chaos_edge(self) -> None:
        # a brownout window opened/closed on some device: every rate may
        # shift — conservatively recompute all groups (exactly the heap
        # engine's global dirty bit)
        self._dirty_all = True

    def on_reconfigure(self) -> None:
        self._dirty_all = True

    # -------------------------------------------------- lazy work_done sync
    def _sync_ctx(self, k) -> None:
        """Flush integrated work into ``inst.work_done`` for every lane
        of context ``k`` — called (via DarisScheduler.work_sync) right
        before a ``predicted_finish`` backlog scan reads them."""
        lanes = self._by_ctx.get(k)
        if not lanes:
            return
        work = self._work
        for lane, s in lanes.items():
            self.running[lane][_E_INST].work_done = float(work[s])

    # ------------------------------------------------------------- predict
    def _check_stragglers(self) -> None:
        """Straggler mitigation — same policy and float sequence as
        SimBackend._check_stragglers, with a vectorized prefilter: the
        kill threshold is >= floor + xfer/rate, so ``projected <= that``
        proves survival without touching the MRET estimator. Candidates
        (normally none) re-run the exact scalar comparison in insertion
        order — the heap engine's dict order."""
        sched = self.core.sched
        kappa = sched.cfg.straggler_kappa
        if not kappa:
            return
        n = self._n
        if n == 0 or not self.running:
            return
        # contiguous prefilter: dead slots carry rate 0.0, so ``pos``
        # drops them and no gather is needed
        rate = self._rate[:n]
        pos = rate > 0
        if not pos.any():
            return
        now = self.now
        safe = np.maximum(rate, 1e-6)
        projected = (now - self._start[:n]) + self._rem[:n] / safe
        cand = pos & (projected > self._floor[:n] + self._xfer[:n] / safe)
        if not cand.any():
            return
        # candidates are rare; replay them in insertion order — the
        # heap engine's dict iteration order decides the kill sequence
        cset = set(np.flatnonzero(cand).tolist())
        killed = False
        for s in self._live_idx().tolist():
            if s not in cset:
                continue
            inst = self._inst[s]
            if inst is None:
                continue
            rate_s = float(self._rate[s])
            projected_s = ((now - inst.start_ms)
                           + float(self._rem[s]) / max(rate_s, 1e-6))
            mret = self._smret[s].value() * float(self._cost[s])
            thresh = (max(kappa * mret, float(self._floor[s]))
                      + float(self._xfer[s]) / max(rate_s, 1e-6))
            if projected_s > thresh and len(self.running) > 1:
                lane = self._lane[s]
                self._remove(lane)
                sched.lanes[lane] = None
                inst.work_done = 0.0
                inst.lane = None
                old = inst.job.ctx
                if inst.task.fixed_ctx:
                    tgt = inst.task.ctx
                else:
                    cands = [c.index for c in sched.live_contexts()]
                    tgt = min(cands, key=lambda k:
                              sched.migration_eta(k, self.now, old,
                                                  inst.job))
                    if tgt != old:
                        sched.migrations += 1
                if inst.job in sched.active_jobs.get(old, {}):
                    del sched.active_jobs[old][inst.job]
                    sched.active_jobs[tgt][inst.job] = None
                inst.job.ctx = tgt
                sched.queues[tgt].push(inst)
                self.core.metrics.stragglers += 1
                killed = True
        if killed:
            self.core._dispatch()

    def _rates_for(self, contention, u, ns, mf) -> List[float]:
        """Rate-group kernel dispatch: the shared bit-exact
        ``rates_seq`` path below ``KERNEL_MIN`` lanes, the jitted JAX
        contention kernel above it (fleet-scale sweeps)."""
        if len(u) >= self._kernel_min:
            from ..kernels import contention_eta as _ck
            if _ck.available():
                return _ck.rates(contention.device, u, ns, mf)
        return contention.rates_seq(u, ns, mf)

    def _group_update(self, contention, contexts, group) -> None:
        """Recompute one rate-group — identical float sequence (and
        group order) to the heap engine's dirty-rates block."""
        ctx_active: Dict[object, int] = {}
        for lane, _ in group:
            ctx_active[lane[0]] = ctx_active.get(lane[0], 0) + 1
        u: List[float] = []
        ns: List[float] = []
        mf: List[float] = []
        for lane, s in group:
            u.append(contexts[lane[0]].cap / max(ctx_active[lane[0]], 1))
            ns.append(self._eff_ns[s])
            mf.append(self._eff_mf[s])
        rates = self._rates_for(contention, u, ns, mf)
        ch = self.core._chaos
        browned = ch is not None and bool(ch.plan.brownouts)
        for (lane, s), r in zip(group, rates):
            if browned:
                f = ch.brownout_factor(self._dev_of(lane), self.now)
                if f > 1.0:
                    r = r / f
            self._rate[s] = r if r > 1e-6 else 1e-6

    def running_set_changed(self) -> None:
        if not self.running:
            return
        self._check_stragglers()
        if not self.running:
            return
        sched = self.core.sched
        workers = getattr(sched, "workers", None)
        if workers is not None and len(workers) != self._n_workers:
            self._install_work_sync()     # elastic scale-out added a GPU
        idx = self._live_idx()
        if self._dirty_all or self._dirty:
            if self._dirty_all or workers is None:
                sel = idx      # single device: any dirt covers the group
            else:
                d = self._dev[idx]
                mask = None    # OR of == masks beats np.isin's sort path
                for dv in self._dirty:
                    m = d == dv
                    mask = m if mask is None else mask | m
                sel = idx[mask]
            entries = [(self._lane[s], s) for s in sel.tolist()]
            for contention, contexts, group in sched.rate_groups(entries):
                self._group_update(contention, contexts, group)
            self._dirty.clear()
            self._dirty_all = False
        # prediction pass: one vectorized ETA computation; fresh stamps
        # only for lanes whose ETA moved (heap: skip-if-unchanged), in
        # insertion order (heap: dict push order) — the cohort contract
        eta_new = self.now + self._rem[idx] / self._rate[idx]
        changed = ~(eta_new == self._eta[idx])   # NaN old -> changed
        ch_idx = idx[changed]
        k = ch_idx.size
        if k:
            self._eta[ch_idx] = eta_new[changed]
            self._stamp[ch_idx] = np.arange(
                self._next_stamp, self._next_stamp + k, dtype=np.int64)
            self._next_stamp += k
