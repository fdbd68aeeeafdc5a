"""Task descriptors (counterpart of ``triton_dist_tpu/megakernel/task.py``).

All 18 type codes are kept, so a task's type number is the same in the
port's tables as in the JAX package's; the port runs the dense decode set
(``RMSNORM`` .. ``NOOP``), batched prefill (``WRITE_KV_PREFILL``,
``ATTN_PREFILL``), the prefill chunk (``ATTN_CHUNK``,
``WRITE_KV_CHUNK``) and the MoE pair (``MOE_WEIGHTS``,
``WEIGHTED_ADD``), and raises on the others.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import List, Tuple

ARGS_MAX = 8


class TaskType(enum.IntEnum):
    RMSNORM = 0        # args: in_off, w_off, out_off, d_tiles
    LINEAR = 1         # args: in_off, w_off, out_off, k_tiles, n_tiles, j
    ADD = 2            # args: a_off, b_off, out_off, tiles
    SILU_MUL = 3       # args: gate_off, up_off, out_off, tiles
    ATTN_DECODE = 4    # args: q_off, out_off, layer, q_norm_off
    WRITE_KV = 5       # args: k_off, v_off, layer, k_norm_off
    ALLREDUCE = 6      # args: buf_off, tiles
    GATHER = 7         # args: table_off, out_off, d_tiles, vocab_loc
    NOOP = 8           # queue padding slot
    WRITE_KV_PREFILL = 9   # args as WRITE_KV; rows (slot, s), slot-major
    ATTN_PREFILL = 10      # args as ATTN_DECODE
    MOE_WEIGHTS = 11       # args: rl_off, wbe_off, n_experts, cnt_off
    WEIGHTED_ADD = 12      # args: acc_off, part_off, wbe_off, e, tiles, init
    GDN_DECODE = 13
    ATTN_QBLOCK = 14
    WRITE_KV_QBLOCK = 15
    ATTN_CHUNK = 16        # args as ATTN_DECODE; rows sign-encoded
    WRITE_KV_CHUNK = 17    # args as WRITE_KV


# Task types whose completion unblocks remote peers (the comm-aware
# claim priority of graph.comm_priority is built on this set).
COLLECTIVE_TYPES = frozenset({TaskType.ALLREDUCE})


@dataclasses.dataclass
class Task:
    task_id: int
    task_type: TaskType
    args: Tuple[int, ...]
    deps: List[int] = dataclasses.field(default_factory=list)
    layer: int = -1
    # Which expert's FFN chain this task belongs to (-1: not expert work);
    # read by graph.comm_priority's expert_load weighting.
    expert: int = -1

    @property
    def unblocks_remote(self) -> bool:
        return self.task_type in COLLECTIVE_TYPES

    def encoded_args(self) -> List[int]:
        a = list(self.args)[:ARGS_MAX]
        return a + [0] * (ARGS_MAX - len(a))
