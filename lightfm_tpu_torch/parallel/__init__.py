from lightfm_tpu_torch.parallel.mesh import (  # noqa: F401
    DATA_AXIS,
    MODEL_AXIS,
    Mesh,
    all_gather_rows,
    initialize_multihost,
    make_mesh,
    shard_state,
    shard_train_data,
    sum_over_data,
)
from lightfm_tpu_torch.parallel.ingest import build_local_train_data  # noqa: F401
