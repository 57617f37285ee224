from lightfm_tpu_torch.parallel.mesh import (  # noqa: F401
    DATA_AXIS,
    MODEL_AXIS,
    Mesh,
    Placement,
    TablePlacement,
    all_gather_rows,
    assemble_state,
    gather_columns,
    gather_owned_rows,
    initialize_multihost,
    make_mesh,
    plan_placement,
    shard_state,
    shard_train_data,
    sum_over_data,
    sum_over_model,
)
from lightfm_tpu_torch.parallel.ingest import build_local_train_data  # noqa: F401
