"""Caps PyTorch's CPU thread pool in a test process.

The Tier-1 run executes the test files in 6 xdist workers on one 8-core
machine. Left alone, PyTorch sizes its intra-op pool to every core in each
worker, so the workers running the port's CPU-heavy tests (float64 int8
convs, yolov8n steps at 416, train steps) oversubscribe the machine, and
the JAX package's loopback tests beside them, which must answer within
fixed windows, starve. Every worker imports every test file while it
collects, so one port test module that imports this (the CPU-heavy ones
do: `import torch_fixtures.cpu_threads`) caps every worker before any test
runs. `THREADS` threads a worker keeps most of one test's speed: the heavy
files ran in 97 s capped at 1 thread against 178 s uncapped under -n 6.
"""

import torch

THREADS = 2

if torch.get_num_threads() > THREADS:
    torch.set_num_threads(THREADS)
