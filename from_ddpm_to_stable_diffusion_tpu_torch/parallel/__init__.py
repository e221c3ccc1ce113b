"""The mesh and its parallel functions (port of ``parallel/``): meshes over
devices or over the ranks of a process group (:mod:`.mesh`), ring and
Ulysses attention (:mod:`.ring_attention`), the Switch-MoE experts
(:mod:`.expert`) and the GPipe / 1F1B schedules (:mod:`.pipeline`).

Not ported yet (ROADMAP.md queue A8): tensor parallelism
(``parallel/sharding.py``) and FSDP (``parallel/fsdp.py``).
"""

from .mesh import (DATA_AXIS, MODEL_AXIS, SEQ_AXIS, AxisComm, Mesh,
                   build_mesh, init_multihost, local_mesh, replicate,
                   shard_batch, visible_devices)
