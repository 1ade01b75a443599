from .mesh import (  # noqa: F401
    DATA_AXIS, MODEL_AXIS, Mesh, available_devices, batch_rows, join_state,
    make_mesh, param_shardings, row_params, shard_params, shard_state,
    shard_teacher, shards_conv, train_row_params,
)
