from .mesh import (  # noqa: F401
    DATA_AXIS, MODEL_AXIS, Mesh, available_devices, batch_rows, make_mesh,
    param_shardings, row_params, shard_params, shards_conv,
)
