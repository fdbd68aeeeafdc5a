// Megakernel task scheduler: the port's own copy of the native core of
// the JAX package's megakernel runtime (the algorithms and the extern "C"
// interface are unchanged, so the port's tables equal the JAX package's
// on the same graph).
//
// Host code only: built with g++ by triton_dist_tpu_torch/utils/build.py
// and bound with ctypes in triton_dist_tpu_torch/megakernel/scheduler.py.
//
// Responsibilities:
//  - validate the dependency graph (cycle detection via Kahn's
//    algorithm),
//  - produce a dependency-respecting execution order,
//  - prune transitive dependencies,
//  - pack tasks onto `num_cores` queues (round-robin, zig-zag or
//    cost-balanced) or emit one priority-ordered claim list,
//  - emit the cross-core wait/signal encoding of each schedule.
// The Hopper megakernel (csrc/megakernel.cu) consumes the resulting
// order as its claim list and the pruned edges as each task's
// predecessors.

#include <algorithm>
#include <cstdint>
#include <functional>
#include <queue>
#include <tuple>
#include <vector>

extern "C" {

// Returns 0 on success, -1 on cycle, -2 on bad input.
// out_order:  execution order (task ids), length n_tasks.
// out_core:   core id per task (indexed by task id), length n_tasks.
// out_pos:    position within its core's queue, length n_tasks.
// out_nxdeps: number of cross-core predecessors per task.
// out_xdeps:  flat cross-core predecessor ids (capacity n_deps).
int tdt_schedule(int32_t n_tasks, const int32_t* dep_src,
                 const int32_t* dep_dst, int32_t n_deps,
                 int32_t num_cores, int32_t strategy,
                 int32_t* out_order, int32_t* out_core,
                 int32_t* out_pos, int32_t* out_nxdeps,
                 int32_t* out_xdeps) {
  if (n_tasks < 0 || n_deps < 0 || num_cores < 1) return -2;
  std::vector<std::vector<int32_t>> succ(n_tasks);
  std::vector<std::vector<int32_t>> pred(n_tasks);
  std::vector<int32_t> indeg(n_tasks, 0);
  for (int32_t e = 0; e < n_deps; ++e) {
    int32_t s = dep_src[e], d = dep_dst[e];
    if (s < 0 || s >= n_tasks || d < 0 || d >= n_tasks) return -2;
    succ[s].push_back(d);
    pred[d].push_back(s);
    ++indeg[d];
  }

  // Kahn's algorithm; FIFO keeps build order among ready tasks, which
  // preserves the builder's layer-by-layer locality.
  std::queue<int32_t> ready;
  for (int32_t t = 0; t < n_tasks; ++t)
    if (indeg[t] == 0) ready.push(t);

  std::vector<int32_t> core_fill(num_cores, 0);
  int32_t emitted = 0;
  int32_t rr = 0;   // round-robin cursor
  int32_t dir = 1;  // zig-zag direction
  while (!ready.empty()) {
    int32_t t = ready.front();
    ready.pop();
    out_order[emitted] = t;

    // Core assignment (reference round_robin / zig_zag).
    int32_t core;
    if (strategy == 1 && num_cores > 1) {  // zig-zag
      core = rr;
      rr += dir;
      if (rr == num_cores) { rr = num_cores - 1; dir = -1; }
      else if (rr < 0) { rr = 0; dir = 1; }
    } else {  // round-robin
      core = rr;
      rr = (rr + 1) % num_cores;
    }
    out_core[t] = core;
    out_pos[t] = core_fill[core]++;
    ++emitted;

    for (int32_t s : succ[t])
      if (--indeg[s] == 0) ready.push(s);
  }
  if (emitted != n_tasks) return -1;  // cycle

  // Scoreboard: predecessors on a different core must be waited on.
  int32_t xcursor = 0;
  for (int32_t t = 0; t < n_tasks; ++t) {
    int32_t count = 0;
    for (int32_t p : pred[t]) {
      if (out_core[p] != out_core[t]) {
        out_xdeps[xcursor + count] = p;
        ++count;
      }
    }
    out_nxdeps[t] = count;
    xcursor += count;
  }
  return 0;
}

// Transitive-reduction style dependency pruning (reference
// enable_dep_opt, core/graph.py): drop edge (a, c) when a path
// a -> b -> c of retained edges exists. Returns the new edge count.
//
// When every edge points to a higher task id (the builders' graphs: a
// task depends only on tasks recorded before it), ids are a topological
// order, so such a path ends at some other predecessor b of c with
// a < b, and never leaves the ids (a, b]: the search from a is bounded by
// c's largest other predecessor and stops at any predecessor of c. That
// keeps a 48-layer MoE graph (~190k tasks, most edges within one expert's
// chain) to a fraction of a second where a whole-graph search per edge
// takes hours. Any other edge list gets the unbounded search. Both give
// the same edges. Visit marks are stamped with the edge index instead of
// a fresh array per edge.
int32_t tdt_prune_deps(int32_t n_tasks, int32_t* dep_src,
                       int32_t* dep_dst, int32_t n_deps) {
  std::vector<std::vector<int32_t>> succ(n_tasks), pred(n_tasks);
  bool forward = true;
  for (int32_t e = 0; e < n_deps; ++e) {
    succ[dep_src[e]].push_back(dep_dst[e]);
    pred[dep_dst[e]].push_back(dep_src[e]);
    if (dep_src[e] >= dep_dst[e]) forward = false;
  }
  std::vector<int32_t> seen(n_tasks, -1), target(n_tasks, -1), queue;

  // Is `to` reachable from `from` other than by the direct edge?
  auto redundant = [&](int32_t e, int32_t from, int32_t to) {
    int32_t bound = n_tasks - 1;
    if (forward) {
      bound = -1;
      for (int32_t b : pred[to]) {
        if (b == from) continue;
        target[b] = e;
        bound = std::max(bound, b);
      }
      if (bound <= from) return false;
    } else {
      target[to] = e;
    }
    queue.clear();
    for (int32_t s : succ[from]) {
      if (s == to || s > bound || seen[s] == e) continue;  // skip direct edge
      seen[s] = e;
      queue.push_back(s);
    }
    for (std::size_t h = 0; h < queue.size(); ++h) {
      const int32_t u = queue[h];
      if (target[u] == e) return true;
      for (int32_t s : succ[u])
        if (s <= bound && seen[s] != e) { seen[s] = e; queue.push_back(s); }
    }
    return false;
  };

  int32_t kept = 0;
  for (int32_t e = 0; e < n_deps; ++e) {
    if (!redundant(e, dep_src[e], dep_dst[e])) {
      dep_src[kept] = dep_src[e];
      dep_dst[kept] = dep_dst[e];
      ++kept;
    }
  }
  return kept;
}

}  // extern "C"

extern "C" {

// Multi-core schedule with a sequential-safety guarantee.
//
// Produces per-core queues padded with NOOP slots (-1) such that every
// task's merged index (pos * num_cores + core) exceeds the merged index
// of ALL its predecessors. Consequences:
//  - on a true multi-core part (TPU megacore, CORE_PARALLEL grid dim)
//    cores run concurrently and cross-core edges are enforced by the
//    edge semaphores emitted below;
//  - on a single-core part (or interpret mode), executing slots in
//    merged (q-major) order can never wait on a signal that hasn't
//    been issued yet — no deadlock, by construction.
//
// Reference analogue: core/scheduler.py per-SM work queues + scoreboard
// tensors; the padding plays the role of the reference's safe static
// packing, the edge semaphores the scoreboard waits.
//
// strategy: 0 = round_robin, 1 = zig_zag, 2 = cost_lpt (greedy
// longest-processing-time onto the least-loaded core using task_cost —
// the static analogue of the reference's runtime scheduler's load
// balancing; enable_runtime_scheduler has no TPU form because cores
// share no atomic queue head).
//
// pin_core[t] >= 0 forces task t onto that core (collectives must stay
// on core 0 so the SPMD comm order matches across chips).
//
// Outputs:
//  out_queue:    (qlen_cap * num_cores) task id or -1, slot-major
//                (q * num_cores + core); returns needed qlen via
//                out_meta[0]. Returns -3 if qlen_cap too small.
//  out_wait_start/out_wait_count (per task id): range into
//  out_wait_edges (edge ids this task must wait on).
//  out_sig_start/out_sig_count: range into out_sig_edges /
//  out_sig_cores (edge id + consumer core to signal on completion).
//  out_meta: [qlen, n_cross_edges].
int tdt_schedule_mc(int32_t n_tasks, const int32_t* dep_src,
                    const int32_t* dep_dst, int32_t n_deps,
                    int32_t num_cores, int32_t strategy,
                    const int32_t* task_cost, const int32_t* pin_core,
                    int32_t qlen_cap, int32_t* out_queue,
                    int32_t* out_wait_start, int32_t* out_wait_count,
                    int32_t* out_wait_edges, int32_t* out_sig_start,
                    int32_t* out_sig_count, int32_t* out_sig_edges,
                    int32_t* out_sig_cores, int32_t* out_meta) {
  if (n_tasks < 0 || n_deps < 0 || num_cores < 1) return -2;
  std::vector<std::vector<int32_t>> succ(n_tasks), pred(n_tasks);
  std::vector<int32_t> indeg(n_tasks, 0);
  for (int32_t e = 0; e < n_deps; ++e) {
    int32_t s = dep_src[e], d = dep_dst[e];
    if (s < 0 || s >= n_tasks || d < 0 || d >= n_tasks) return -2;
    succ[s].push_back(d);
    pred[d].push_back(s);
    ++indeg[d];
  }

  std::queue<int32_t> ready;
  for (int32_t t = 0; t < n_tasks; ++t)
    if (indeg[t] == 0) ready.push(t);

  std::vector<int32_t> fill(num_cores, 0);   // next free pos per core
  std::vector<int64_t> load(num_cores, 0);   // cost_lpt accumulated cost
  std::vector<int32_t> core_of(n_tasks, 0), pos_of(n_tasks, 0);
  int32_t emitted = 0, rr = 0, dir = 1;
  while (!ready.empty()) {
    int32_t t = ready.front();
    ready.pop();

    int32_t core;
    if (pin_core && pin_core[t] >= 0) {
      core = pin_core[t] % num_cores;
    } else if (strategy == 2) {  // cost_lpt: least-loaded core
      core = 0;
      for (int32_t c = 1; c < num_cores; ++c)
        if (load[c] < load[core]) core = c;
    } else if (strategy == 1 && num_cores > 1) {  // zig-zag
      core = rr;
      rr += dir;
      if (rr == num_cores) { rr = num_cores - 1; dir = -1; }
      else if (rr < 0) { rr = 0; dir = 1; }
    } else {  // round-robin
      core = rr;
      rr = (rr + 1) % num_cores;
    }

    // Earliest position satisfying the merged-order constraint.
    int64_t need = -1;
    for (int32_t p : pred[t]) {
      int64_t mi = (int64_t)pos_of[p] * num_cores + core_of[p];
      if (mi > need) need = mi;
    }
    int32_t pos = fill[core];
    while ((int64_t)pos * num_cores + core <= need) ++pos;
    core_of[t] = core;
    pos_of[t] = pos;
    fill[core] = pos + 1;
    load[core] += task_cost ? task_cost[t] : 1;
    ++emitted;
    for (int32_t s : succ[t])
      if (--indeg[s] == 0) ready.push(s);
  }
  if (emitted != n_tasks) return -1;  // cycle

  int32_t qlen = 0;
  for (int32_t c = 0; c < num_cores; ++c)
    if (fill[c] > qlen) qlen = fill[c];
  out_meta[0] = qlen;
  if (qlen > qlen_cap) return -3;
  for (int32_t i = 0; i < qlen * num_cores; ++i) out_queue[i] = -1;
  for (int32_t t = 0; t < n_tasks; ++t)
    out_queue[pos_of[t] * num_cores + core_of[t]] = t;

  // Edge semaphores for cross-core edges only (same-core order is the
  // queue itself). Edge ids are assigned in (dst task, pred) order.
  int32_t edge_id = 0, wcur = 0;
  for (int32_t t = 0; t < n_tasks; ++t) {
    out_wait_start[t] = wcur;
    int32_t cnt = 0;
    for (int32_t p : pred[t]) {
      if (core_of[p] != core_of[t]) {
        out_wait_edges[wcur + cnt] = edge_id++;
        ++cnt;
      }
    }
    out_wait_count[t] = cnt;
    wcur += cnt;
  }
  // Signals: re-walk edges in the same id order, bucketed by producer.
  std::vector<std::vector<int32_t>> sig_e(n_tasks), sig_c(n_tasks);
  edge_id = 0;
  for (int32_t t = 0; t < n_tasks; ++t) {
    for (int32_t p : pred[t]) {
      if (core_of[p] != core_of[t]) {
        sig_e[p].push_back(edge_id);
        sig_c[p].push_back(core_of[t]);
        ++edge_id;
      }
    }
  }
  int32_t scur = 0;
  for (int32_t t = 0; t < n_tasks; ++t) {
    out_sig_start[t] = scur;
    out_sig_count[t] = (int32_t)sig_e[t].size();
    for (std::size_t k = 0; k < sig_e[t].size(); ++k) {
      out_sig_edges[scur] = sig_e[t][k];
      out_sig_cores[scur] = sig_c[t][k];
      ++scur;
    }
  }
  out_meta[1] = edge_id;
  return 0;
}

// Dynamic-claim schedule: the device-side scoreboard scheduler's host
// precompute (reference: MegaTritonKernel's in-kernel runtime scheduler,
// model_builder.py:89,124 — SMs pop tasks off an atomic queue head).
//
// The TPU form: instead of per-core slot lists, the host emits ONE
// priority-ordered claim list; at run time each grid slot claims the
// next entry off a claim counter in the scoreboard workspace (SMEM
// counter + per-priority-bucket claim semaphores) and executes whatever
// task the counter hands it. Claim index i is bound to core (i %
// num_cores) — that is the binding the wait/signal edge tables below
// assume, and the one a concurrent megacore claim (fetch-add order)
// would reproduce under the deterministic sequential merged order.
//
// Claim-order construction is list scheduling: among tasks whose
// predecessors have all been CLAIMED, pick by (priority bucket asc,
// priority desc, task id asc). Pinned tasks (collectives on core 0)
// are only claimable at matching claim indices; a hole (-1, a NOOP
// claim) is emitted when the next index's core has no eligible task.
// Unlike tdt_schedule_mc there is no padding for merged-order safety:
// the claim order IS a topological order, so every wait's signal sits
// at an earlier claim index — deadlock-free sequentially by
// construction, and concurrently because waits only ever point
// backwards in claim order while each core's claims increase.
//
// A timed model (task_cost) runs alongside to report [idle_units,
// makespan]: cores accrue idle time while the task they claimed waits
// on a predecessor's finish. Compare with tdt_sim_static on the same
// costs to quantify the dynamic win over cost_lpt.
//
// priority: higher claims earlier within a bucket (comm-aware: computed
// host-side from the task graph — how many remote-peer-unblocking
// collectives a task's completion leads to).
// bucket:   priority bucket per task, 0 = most urgent.
//
// Outputs:
//  out_order[cap]:     claim idx -> task id, or -1 (hole / NOOP claim).
//  out_claim_of[n]:    task id -> claim idx.
//  out_wait_*/out_sig_* (task-indexed, schedule_mc's scoreboard
//  format): edge semaphores for deps whose endpoints' claim cores
//  differ.
//  out_meta: [n_claims, n_edges, idle_units, makespan].
// Returns 0, -1 on cycle, -2 on bad input, -3 if cap too small.
int tdt_schedule_dyn(int32_t n_tasks, const int32_t* dep_src,
                     const int32_t* dep_dst, int32_t n_deps,
                     int32_t num_cores, const int32_t* priority,
                     const int32_t* bucket, const int32_t* task_cost,
                     const int32_t* pin_core, int32_t cap,
                     int32_t* out_order, int32_t* out_claim_of,
                     int32_t* out_wait_start, int32_t* out_wait_count,
                     int32_t* out_wait_edges, int32_t* out_sig_start,
                     int32_t* out_sig_count, int32_t* out_sig_edges,
                     int32_t* out_sig_cores, int64_t* out_meta) {
  if (n_tasks < 0 || n_deps < 0 || num_cores < 1) return -2;
  std::vector<std::vector<int32_t>> succ(n_tasks), pred(n_tasks);
  std::vector<int32_t> indeg(n_tasks, 0);
  for (int32_t e = 0; e < n_deps; ++e) {
    int32_t s = dep_src[e], d = dep_dst[e];
    if (s < 0 || s >= n_tasks || d < 0 || d >= n_tasks) return -2;
    succ[s].push_back(d);
    pred[d].push_back(s);
    ++indeg[d];
  }

  // Claimable pool: tasks whose predecessors have all been claimed.
  // Selection is readiness-aware, like the reference's runtime
  // scheduler whose queue only ever holds READY tasks: at claim time
  // the core prefers the best (bucket, priority) task that is ready
  // by its free time, and only reaches for a not-yet-ready task (the
  // earliest-ready one) when nothing is. O(n) scan per claim — decode
  // graphs are thousands of tasks, and this runs once per build.
  std::vector<int32_t> pool;
  pool.reserve(n_tasks);
  auto push_task = [&](int32_t t) { pool.push_back(t); };
  for (int32_t t = 0; t < n_tasks; ++t)
    if (indeg[t] == 0) push_task(t);

  // Timed model state.
  std::vector<int64_t> core_free(num_cores, 0);
  std::vector<int64_t> ready_at(n_tasks, 0);   // max pred finish
  std::vector<int64_t> finish(n_tasks, 0);
  std::vector<int32_t> claim_of(n_tasks, -1);
  int64_t idle_units = 0, makespan = 0;

  auto prio_of = [&](int32_t t) {
    return std::tuple<int32_t, int32_t, int32_t>{
        bucket ? bucket[t] : 0, priority ? -priority[t] : 0, t};
  };

  int32_t claimed = 0, n_claims = 0;
  while (claimed < n_tasks) {
    if (n_claims >= cap) return -3;
    int32_t c = n_claims % num_cores;
    int64_t now = core_free[c];
    int32_t best_ready = -1, best_late = -1;
    std::size_t ready_ix = 0, late_ix = 0;
    for (std::size_t i = 0; i < pool.size(); ++i) {
      int32_t t = pool[i];
      if (pin_core && pin_core[t] >= 0 && pin_core[t] % num_cores != c)
        continue;
      if (ready_at[t] <= now) {
        if (best_ready < 0 || prio_of(t) < prio_of(best_ready)) {
          best_ready = t;
          ready_ix = i;
        }
      } else if (best_late < 0 || ready_at[t] < ready_at[best_late] ||
                 (ready_at[t] == ready_at[best_late] &&
                  prio_of(t) < prio_of(best_late))) {
        best_late = t;
        late_ix = i;
      }
    }
    int32_t t = best_ready >= 0 ? best_ready : best_late;
    if (t < 0) {
      if (pool.empty()) return -1;  // nothing claimable: cycle
      out_order[n_claims++] = -1;   // hole: pinned work for other cores
      continue;
    }
    std::size_t ix = best_ready >= 0 ? ready_ix : late_ix;
    pool[ix] = pool.back();
    pool.pop_back();
    out_order[n_claims] = t;
    claim_of[t] = n_claims;
    ++n_claims;
    ++claimed;

    int64_t start = core_free[c] > ready_at[t] ? core_free[c]
                                               : ready_at[t];
    idle_units += start - core_free[c];
    finish[t] = start + (task_cost ? task_cost[t] : 1);
    core_free[c] = finish[t];
    if (finish[t] > makespan) makespan = finish[t];
    for (int32_t s : succ[t]) {
      if (ready_at[s] < finish[t]) ready_at[s] = finish[t];
      if (--indeg[s] == 0) push_task(s);
    }
  }

  for (int32_t t = 0; t < n_tasks; ++t) out_claim_of[t] = claim_of[t];

  // Scoreboard edges for deps whose claim cores differ (same-core
  // order is the per-core claim subsequence). Same id scheme as
  // tdt_schedule_mc: (dst task, pred) order.
  auto core_of = [&](int32_t t) { return claim_of[t] % num_cores; };
  int32_t edge_id = 0, wcur = 0;
  for (int32_t t = 0; t < n_tasks; ++t) {
    out_wait_start[t] = wcur;
    int32_t cnt = 0;
    for (int32_t p : pred[t]) {
      if (core_of(p) != core_of(t)) {
        out_wait_edges[wcur + cnt] = edge_id++;
        ++cnt;
      }
    }
    out_wait_count[t] = cnt;
    wcur += cnt;
  }
  std::vector<std::vector<int32_t>> sig_e(n_tasks), sig_c(n_tasks);
  edge_id = 0;
  for (int32_t t = 0; t < n_tasks; ++t) {
    for (int32_t p : pred[t]) {
      if (core_of(p) != core_of(t)) {
        sig_e[p].push_back(edge_id);
        sig_c[p].push_back(core_of(t));
        ++edge_id;
      }
    }
  }
  int32_t scur = 0;
  for (int32_t t = 0; t < n_tasks; ++t) {
    out_sig_start[t] = scur;
    out_sig_count[t] = (int32_t)sig_e[t].size();
    for (std::size_t k = 0; k < sig_e[t].size(); ++k) {
      out_sig_edges[scur] = sig_e[t][k];
      out_sig_cores[scur] = sig_c[t][k];
      ++scur;
    }
  }
  out_meta[0] = n_claims;
  out_meta[1] = edge_id;
  out_meta[2] = idle_units;
  out_meta[3] = makespan;
  return 0;
}

// Timed replay of a STATIC schedule_mc queue under the same cost model
// as tdt_schedule_dyn's simulator: each core walks its column in
// order, a task starts at max(core free, preds' finish), NOOP slots
// are free. Single pass over merged order is sound because
// tdt_schedule_mc guarantees every pred sits at a smaller merged
// index. out_meta: [idle_units, makespan]. Returns 0 / -2 on bad ids.
int tdt_sim_static(int32_t n_tasks, const int32_t* dep_src,
                   const int32_t* dep_dst, int32_t n_deps,
                   const int32_t* queue, int32_t qlen,
                   int32_t num_cores, const int32_t* task_cost,
                   int64_t* out_meta) {
  if (n_tasks < 0 || n_deps < 0 || num_cores < 1 || qlen < 0) return -2;
  std::vector<std::vector<int32_t>> pred(n_tasks);
  for (int32_t e = 0; e < n_deps; ++e) {
    int32_t s = dep_src[e], d = dep_dst[e];
    if (s < 0 || s >= n_tasks || d < 0 || d >= n_tasks) return -2;
    pred[d].push_back(s);
  }
  std::vector<int64_t> core_free(num_cores, 0);
  std::vector<int64_t> finish(n_tasks, 0);
  int64_t idle_units = 0, makespan = 0;
  for (int32_t q = 0; q < qlen; ++q) {
    for (int32_t c = 0; c < num_cores; ++c) {
      int32_t t = queue[q * num_cores + c];
      if (t < 0) continue;
      if (t >= n_tasks) return -2;
      int64_t start = core_free[c];
      for (int32_t p : pred[t])
        if (finish[p] > start) start = finish[p];
      idle_units += start - core_free[c];
      finish[t] = start + (task_cost ? task_cost[t] : 1);
      core_free[c] = finish[t];
      if (finish[t] > makespan) makespan = finish[t];
    }
  }
  out_meta[0] = idle_units;
  out_meta[1] = makespan;
  return 0;
}

}  // extern "C"
