"""Data parallelism over N ranks, one process each (`mesh.py`,
`collectives.py`, `launch.py`)."""

from lanedetection_end2end_tpu_torch.parallel.collectives import (  # noqa: F401
    all_reduce_grads, all_reduce_mean, gather_rows, set_sync_group)
from lanedetection_end2end_tpu_torch.parallel.mesh import (  # noqa: F401
    DataParallel, check_slices, init_data_parallel, local_rows, rank_seed,
    replicate)
from lanedetection_end2end_tpu_torch.parallel.launch import (  # noqa: F401
    spawn)
