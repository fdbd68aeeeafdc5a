"""Dependency graph and comm-aware claim priority (counterpart of
``triton_dist_tpu/megakernel/graph.py``).

:class:`Graph` infers the same dependencies as the JAX ``Graph``: a task
depends on the most recent writer of every region it reads, and on the
most recent writers and readers of every region it writes (RAW, WAW,
WAR). Regions are ``(offset, rows)`` spans of the arena, keyed exactly
as the JAX package keys them, so overlapping keys written earlier stay
in the tables just as they do there. The JAX version scans every key for
every access; here an index by start row and size class answers the
overlap query, so a 36-layer Qwen3-8B graph (about 12,000 tasks) builds
in seconds and gives the identical dependency lists.
"""

from __future__ import annotations

import bisect
from typing import Dict, List, Sequence, Tuple

from triton_dist_tpu_torch.megakernel.task import (COLLECTIVE_TYPES, Task,
                                                   TaskType)

Region = Tuple[int, int]


def _overlap(a: Region, b: Region) -> bool:
    return a[0] < b[0] + b[1] and b[0] < a[0] + a[1]


class _RegionIndex:
    """Every region key ever recorded, found by overlap: keys of size
    class ``c`` (``rows.bit_length() == c``) overlapping ``[a, a + s)``
    start in ``(a - 2**c, a + s)``, a bisect on a list sorted by start."""

    def __init__(self):
        self._by_class: Dict[int, List[Region]] = {}
        self._seen = set()

    def add(self, key: Region) -> None:
        if key not in self._seen:
            self._seen.add(key)
            bisect.insort(self._by_class.setdefault(key[1].bit_length(), []),
                          key)

    def overlapping(self, region: Region) -> List[Region]:
        a, s = region
        out = []
        for c, keys in self._by_class.items():
            lo = bisect.bisect_left(keys, (a - (1 << c) + 1,))
            hi = bisect.bisect_left(keys, (a + s,))
            out.extend(k for k in keys[lo:hi] if _overlap(k, region))
        return out


class Graph:
    """Records tasks and infers their dependencies from arena data flow."""

    def __init__(self):
        self.tasks: List[Task] = []
        self._last_writer: Dict[Region, int] = {}
        self._readers: Dict[Region, List[int]] = {}
        self._index = _RegionIndex()

    def add(self, task_type: TaskType, args, *, reads, writes,
            layer: int = -1, expert: int = -1) -> Task:
        """reads/writes: lists of (offset, rows) arena regions."""
        t = Task(task_id=len(self.tasks), task_type=task_type,
                 args=tuple(int(a) for a in args), layer=layer,
                 expert=expert)
        deps = set()
        for region in reads:
            key = self._key(region)
            for k in self._index.overlapping(key):
                if k in self._last_writer:
                    deps.add(self._last_writer[k])
            self._readers.setdefault(key, []).append(t.task_id)
            self._index.add(key)
        for region in writes:
            key = self._key(region)
            for k in self._index.overlapping(key):
                if k in self._last_writer:
                    deps.add(self._last_writer[k])          # WAW
                deps.update(self._readers.get(k, ()))      # WAR
            self._last_writer[key] = t.task_id
            self._readers[key] = []
            self._index.add(key)
        t.deps = sorted(d for d in deps if d != t.task_id)
        self.tasks.append(t)
        return t

    @staticmethod
    def _key(region) -> Region:
        return (int(region[0]), int(region[1]))

    def edges(self):
        src, dst = [], []
        for t in self.tasks:
            for d in t.deps:
                src.append(d)
                dst.append(t.task_id)
        return src, dst


# Priority layout: comm weight in the high bits, critical path in the
# low 15.
_CP_BITS = 15
N_PRIORITY_BUCKETS = 3


def comm_priority(tasks: Sequence[Task], *, n_ranks: int = 1,
                  task_cost: Sequence[int] = None,
                  expert_load: Sequence[float] = None):
    """Claim priority for the dynamic schedule, as the JAX package
    computes it: ``priority[t]`` is (distinct collective descendants of
    t) x (n_ranks - 1) in the high bits with the cost-weighted critical
    path to a sink in the low bits; ``bucket[t]`` is 0 for collectives
    and their direct predecessors, 1 for tasks with a collective
    downstream, 2 for the local-only tail. ``expert_load`` scales the
    cost of tasks tagged with ``Task.expert``. Task ids must be in
    topological order (``Graph.add`` guarantees it).

    Returns ``(priority, bucket, n_buckets)``."""
    n = len(tasks)
    cost = list(task_cost) if task_cost is not None else [1] * n
    if expert_load is not None:
        load = [max(float(v), 0.0) for v in expert_load]
        mean = (sum(load) / len(load)) if load else 0.0
        if mean > 0:
            for t in tasks:
                if 0 <= t.expert < len(load):
                    scale = 1.0 + load[t.expert] / mean
                    cost[t.task_id] = max(
                        int(round(cost[t.task_id] * scale)), 1)
    succ: List[List[int]] = [[] for _ in range(n)]
    for t in tasks:
        for d in t.deps:
            succ[d].append(t.task_id)

    bit = {}
    for t in tasks:
        if t.task_type in COLLECTIVE_TYPES:
            bit[t.task_id] = len(bit)
    mask = [0] * n
    cp = [0] * n
    for tid in reversed(range(n)):
        m = (1 << bit[tid]) if tid in bit else 0
        best = 0
        for s in succ[tid]:
            m |= mask[s]
            if cp[s] > best:
                best = cp[s]
        mask[tid] = m
        cp[tid] = best + max(int(cost[tid]), 0)

    max_cp = max(cp) if cp else 1
    peers = max(n_ranks - 1, 0)
    pre_comm = set()
    for t in tasks:
        if t.task_type in COLLECTIVE_TYPES:
            pre_comm.update(t.deps)

    priority, bucket = [], []
    for t in tasks:
        tid = t.task_id
        unblocks = bin(mask[tid]).count("1") * peers
        cp_scaled = (cp[tid] * ((1 << _CP_BITS) - 1)) // max(max_cp, 1)
        priority.append((unblocks << _CP_BITS) + cp_scaled)
        if t.task_type in COLLECTIVE_TYPES or tid in pre_comm:
            bucket.append(0)
        elif mask[tid]:
            bucket.append(1)
        else:
            bucket.append(2)
    return priority, bucket, N_PRIORITY_BUCKETS
