"""The mesh and its parallel functions (port of ``parallel/``): meshes over
devices or over the ranks of a process group (:mod:`.mesh`), tensor
parallelism over a ``model`` axis (:mod:`.sharding`), FSDP over ``data``
(:mod:`.fsdp`), ring and Ulysses attention (:mod:`.ring_attention`), the
Switch-MoE experts (:mod:`.expert`) and the GPipe / 1F1B schedules
(:mod:`.pipeline`).
"""

from .mesh import (DATA_AXIS, MODEL_AXIS, SEQ_AXIS, AxisComm, Mesh,
                   build_mesh, init_multihost, local_mesh, replicate,
                   shard_batch, visible_devices)
from .fsdp import (apply_fsdp, drop_data_axis, fsdp_shardings, fsdp_spec,
                   fsdp_tp_shardings)
from .sharding import apply_tp, tp_shardings, tp_spec_for_path
