"""The serving step's kernel calls at batch 8 (yolov8n, 4 classes, 416 px),
in step order: the shapes the card tests (tests/test_torch_cuda.py) run
each kernel at. tests/test_torch_kernel_plan.py checks them against the
port's own forward. Data only: this module holds no tests and imports
nothing, so both test files can share it."""

# 1x1 convs as (M, Cin, Cout, act):
SERVING_CONV1X1_B8 = [
    (86528, 32, 32, True), (86528, 48, 32, True), (21632, 64, 64, True),
    (21632, 128, 64, True), (5408, 128, 128, True), (5408, 256, 128, True),
    (1352, 256, 256, True), (1352, 384, 256, True), (1352, 256, 128, True),
    (1352, 512, 256, True), (5408, 384, 128, True), (5408, 192, 128, True),
    (21632, 192, 64, True), (21632, 96, 64, True), (5408, 192, 128, True),
    (5408, 192, 128, True), (1352, 384, 256, True), (1352, 384, 256, True),
    (21632, 64, 64, False), (21632, 64, 4, False), (5408, 64, 64, False),
    (5408, 64, 4, False), (1352, 64, 64, False), (1352, 64, 4, False)]
# bias+SiLU inputs (B, H, W, C):
SERVING_BIAS_SILU_B8 = [
    (8, 208, 208, 16), (8, 104, 104, 32), (8, 104, 104, 16),
    (8, 104, 104, 16), (8, 52, 52, 64), (8, 52, 52, 32), (8, 52, 52, 32),
    (8, 52, 52, 32), (8, 52, 52, 32), (8, 26, 26, 128), (8, 26, 26, 64),
    (8, 26, 26, 64), (8, 26, 26, 64), (8, 26, 26, 64), (8, 13, 13, 256),
    (8, 13, 13, 128), (8, 13, 13, 128), (8, 26, 26, 64), (8, 26, 26, 64),
    (8, 52, 52, 32), (8, 52, 52, 32), (8, 26, 26, 64), (8, 26, 26, 64),
    (8, 26, 26, 64), (8, 13, 13, 128), (8, 13, 13, 128), (8, 13, 13, 128),
    (8, 52, 52, 64), (8, 52, 52, 64), (8, 52, 52, 64), (8, 52, 52, 64),
    (8, 26, 26, 64), (8, 26, 26, 64), (8, 26, 26, 64), (8, 26, 26, 64),
    (8, 13, 13, 64), (8, 13, 13, 64), (8, 13, 13, 64), (8, 13, 13, 64)]
