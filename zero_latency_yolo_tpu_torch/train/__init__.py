"""Training: the frozen-BN train step, losses, the optimizer, checkpoints in
the JAX package's npz layout, data, and eval through the serving forward."""
from .loss import detection_loss, distill_loss  # noqa: F401
from .step import TrainState, init_train_state, make_train_step  # noqa: F401
