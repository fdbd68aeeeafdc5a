"""ctypes bindings for the port's copy of the native scheduler
(``triton_dist_tpu_torch/csrc/megakernel_scheduler.cc``; counterpart of
``triton_dist_tpu/megakernel/scheduler.py``).

The library is built with g++ by :mod:`triton_dist_tpu_torch.utils.build`
on first use into ``build/torch_kernels/``; Python only marshals arrays.
"""

from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import numpy as np

from triton_dist_tpu_torch.utils import build

SOURCE = "megakernel_scheduler.cc"
_LIB = None


def _load_lib():
    global _LIB
    if _LIB is not None:
        return _LIB
    lib = build.load(SOURCE)
    i32p = ctypes.POINTER(ctypes.c_int32)
    i64p = ctypes.POINTER(ctypes.c_int64)
    i32 = ctypes.c_int32
    lib.tdt_schedule.restype = i32
    lib.tdt_schedule.argtypes = [i32, i32p, i32p, i32, i32, i32, i32p, i32p,
                                 i32p, i32p, i32p]
    lib.tdt_prune_deps.restype = i32
    lib.tdt_prune_deps.argtypes = [i32, i32p, i32p, i32]
    lib.tdt_schedule_mc.restype = i32
    lib.tdt_schedule_mc.argtypes = [
        i32, i32p, i32p, i32, i32, i32, i32p, i32p, i32, i32p, i32p, i32p,
        i32p, i32p, i32p, i32p, i32p, i32p]
    lib.tdt_schedule_dyn.restype = i32
    lib.tdt_schedule_dyn.argtypes = [
        i32, i32p, i32p, i32, i32, i32p, i32p, i32p, i32p, i32, i32p, i32p,
        i32p, i32p, i32p, i32p, i32p, i32p, i32p, i64p]
    lib.tdt_sim_static.restype = i32
    lib.tdt_sim_static.argtypes = [i32, i32p, i32p, i32, i32p, i32, i32,
                                   i32p, i64p]
    _LIB = lib
    return lib


def _as_i32(a):
    return np.ascontiguousarray(np.asarray(a, np.int32))


def _ptr(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def _i64ptr(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def _check(rc: int, what: str = "scheduler") -> None:
    if rc == -1:
        raise ValueError("dependency cycle in task graph")
    if rc != 0:
        raise ValueError(f"{what} error {rc}")


def prune_deps(n_tasks: int, src: Sequence[int], dst: Sequence[int]
               ) -> Tuple[np.ndarray, np.ndarray]:
    """Drop edge (a, c) when a path a -> b -> c of kept edges exists."""
    lib = _load_lib()
    s, d = _as_i32(src), _as_i32(dst)
    kept = lib.tdt_prune_deps(n_tasks, _ptr(s), _ptr(d), len(s))
    return s[:kept], d[:kept]


def schedule(n_tasks: int, src: Sequence[int], dst: Sequence[int], *,
             num_cores: int = 1, strategy: str = "round_robin",
             dep_opt: bool = True):
    """Topological order packed onto ``num_cores`` queues: a dict with the
    order, core, pos and cross-core dependency arrays."""
    lib = _load_lib()
    s, d = _as_i32(src), _as_i32(dst)
    if dep_opt and len(s):
        s, d = prune_deps(n_tasks, s, d)
    order = np.zeros(n_tasks, np.int32)
    core = np.zeros(n_tasks, np.int32)
    pos = np.zeros(n_tasks, np.int32)
    nxdeps = np.zeros(n_tasks, np.int32)
    xdeps = np.zeros(max(len(s), 1), np.int32)
    _check(lib.tdt_schedule(n_tasks, _ptr(s), _ptr(d), len(s), num_cores,
                            1 if strategy == "zig_zag" else 0, _ptr(order),
                            _ptr(core), _ptr(pos), _ptr(nxdeps),
                            _ptr(xdeps)))
    n_x = int(nxdeps.sum())
    return {"order": order, "core": core, "pos": pos,
            "n_cross_deps": nxdeps, "cross_deps": xdeps[:n_x]}


def _edge_tables(n_tasks: int, n_deps: int):
    n = max(n_tasks, 1)
    e = max(n_deps, 1)
    return {name: np.zeros(size, np.int32) for name, size in (
        ("wait_start", n), ("wait_count", n), ("wait_edges", e),
        ("sig_start", n), ("sig_count", n), ("sig_edges", e),
        ("sig_cores", e))}


def _trim(tab: dict) -> dict:
    nw, ns = int(tab["wait_count"].sum()), int(tab["sig_count"].sum())
    tab["wait_edges"] = tab["wait_edges"][:nw]
    tab["sig_edges"] = tab["sig_edges"][:ns]
    tab["sig_cores"] = tab["sig_cores"][:ns]
    return tab


def schedule_mc(n_tasks: int, src: Sequence[int], dst: Sequence[int], *,
                num_cores: int, strategy: str = "round_robin",
                task_cost: Sequence[int] = None,
                pin_core: Sequence[int] = None, dep_opt: bool = True):
    """Per-core queues padded with -1 NOOP slots so that the merged
    (q-major) order respects every dependency, plus the cross-core
    wait/signal tables. strategy: "round_robin" | "zig_zag" |
    "cost_lpt"."""
    lib = _load_lib()
    s, d = _as_i32(src), _as_i32(dst)
    if dep_opt and len(s):
        s, d = prune_deps(n_tasks, s, d)
    strat = {"round_robin": 0, "zig_zag": 1, "cost_lpt": 2}[strategy]
    cost = _as_i32(task_cost if task_cost is not None
                   else np.ones(n_tasks))
    pin = _as_i32(pin_core if pin_core is not None
                  else -np.ones(n_tasks))
    qlen_cap = 2 * n_tasks + num_cores
    queue = np.zeros(qlen_cap * num_cores, np.int32)
    tab = _edge_tables(n_tasks, len(s))
    meta = np.zeros(2, np.int32)
    _check(lib.tdt_schedule_mc(
        n_tasks, _ptr(s), _ptr(d), len(s), num_cores, strat, _ptr(cost),
        _ptr(pin), qlen_cap, _ptr(queue), _ptr(tab["wait_start"]),
        _ptr(tab["wait_count"]), _ptr(tab["wait_edges"]),
        _ptr(tab["sig_start"]), _ptr(tab["sig_count"]),
        _ptr(tab["sig_edges"]), _ptr(tab["sig_cores"]), _ptr(meta)))
    qlen, n_edges = int(meta[0]), int(meta[1])
    out = _trim(tab)
    out["queue"] = queue[:qlen * num_cores].reshape(qlen, num_cores)
    out["n_edges"] = n_edges
    return out


def schedule_dyn(n_tasks: int, src: Sequence[int], dst: Sequence[int],
                 *, num_cores: int, priority: Sequence[int] = None,
                 bucket: Sequence[int] = None,
                 task_cost: Sequence[int] = None,
                 pin_core: Sequence[int] = None, dep_opt: bool = True):
    """One priority-ordered claim list (claim ``i`` binds to core
    ``i % num_cores``; ``-1`` entries are holes), with ``claim_of``,
    ``bucket``, the task-indexed wait/signal tables, ``n_claims``,
    ``n_edges``, ``num_cores`` and the timed model's ``idle_units`` and
    ``makespan``."""
    lib = _load_lib()
    s, d = _as_i32(src), _as_i32(dst)
    if dep_opt and len(s):
        s, d = prune_deps(n_tasks, s, d)
    prio = _as_i32(priority if priority is not None
                   else np.zeros(n_tasks))
    bkt = _as_i32(bucket if bucket is not None else np.zeros(n_tasks))
    cost = _as_i32(task_cost if task_cost is not None
                   else np.ones(n_tasks))
    pin = _as_i32(pin_core if pin_core is not None
                  else -np.ones(n_tasks))
    cap = n_tasks * num_cores + num_cores
    order = np.zeros(max(cap, 1), np.int32)
    claim_of = np.zeros(max(n_tasks, 1), np.int32)
    tab = _edge_tables(n_tasks, len(s))
    meta = np.zeros(4, np.int64)
    _check(lib.tdt_schedule_dyn(
        n_tasks, _ptr(s), _ptr(d), len(s), num_cores, _ptr(prio),
        _ptr(bkt), _ptr(cost), _ptr(pin), cap, _ptr(order),
        _ptr(claim_of), _ptr(tab["wait_start"]), _ptr(tab["wait_count"]),
        _ptr(tab["wait_edges"]), _ptr(tab["sig_start"]),
        _ptr(tab["sig_count"]), _ptr(tab["sig_edges"]),
        _ptr(tab["sig_cores"]), _i64ptr(meta)))
    n_claims, n_edges = int(meta[0]), int(meta[1])
    out = _trim(tab)
    out.update({
        "claim_order": order[:n_claims], "claim_of": claim_of,
        "bucket": bkt, "num_cores": num_cores,
        "n_claims": n_claims, "n_edges": n_edges,
        "idle_units": int(meta[2]), "makespan": int(meta[3]),
    })
    return out


def simulate_static(n_tasks: int, src: Sequence[int],
                    dst: Sequence[int], queue, *,
                    task_cost: Sequence[int] = None) -> dict:
    """Timed replay of a :func:`schedule_mc` queue under the dynamic
    schedule's cost model: {"idle_units", "makespan"}. Pass the same
    (possibly pruned) edges the schedule was built from."""
    lib = _load_lib()
    s, d = _as_i32(src), _as_i32(dst)
    qarr = _as_i32(queue)
    qlen, cores = qarr.shape
    cost = _as_i32(task_cost if task_cost is not None
                   else np.ones(n_tasks))
    meta = np.zeros(2, np.int64)
    _check(lib.tdt_sim_static(
        n_tasks, _ptr(s), _ptr(d), len(s), _ptr(qarr.reshape(-1)),
        qlen, cores, _ptr(cost), _i64ptr(meta)), "simulator")
    return {"idle_units": int(meta[0]), "makespan": int(meta[1])}
