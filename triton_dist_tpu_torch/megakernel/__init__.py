"""Megakernel runtime: a whole model step (decode, a prompt chunk, or a
batched prefill) as one persistent kernel (counterpart of
``triton_dist_tpu/megakernel``).

The task graph, its arena layout and its schedule are built on the host
exactly as the JAX package builds them (:class:`ModelBuilder`, the native
scheduler in ``csrc/megakernel_scheduler.cc``). On the card one launch of
``csrc/megakernel.cu`` runs the step: every block claims tasks off an
atomic counter in claim-list order, waits on its predecessors' done
flags, and runs the task body. On the CPU the plain interpreter runs the
same claim list through the PyTorch task bodies.
"""

from triton_dist_tpu_torch.megakernel.task import (  # noqa: F401
    ARGS_MAX, COLLECTIVE_TYPES, Task, TaskType,
)
from triton_dist_tpu_torch.megakernel.graph import (  # noqa: F401
    Graph, comm_priority,
)
from triton_dist_tpu_torch.megakernel.scheduler import (  # noqa: F401
    prune_deps, schedule, schedule_dyn, schedule_mc, simulate_static,
)
from triton_dist_tpu_torch.megakernel.builder import (  # noqa: F401
    ArenaRegion, ArenaSchema, MegakernelTimeoutError, ModelBuilder,
)
from triton_dist_tpu_torch.megakernel.engine import (  # noqa: F401
    MegaKernelEngine,
)
