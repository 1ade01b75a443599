from .yolov8 import (ModelSpec, VARIANTS, anchors_for, decode_outputs,
                     fold_batchnorm, forward_decoded, forward_raw, get_spec,
                     init_params)

__all__ = ["ModelSpec", "VARIANTS", "anchors_for", "decode_outputs",
           "fold_batchnorm", "forward_decoded", "forward_raw", "get_spec",
           "init_params"]
