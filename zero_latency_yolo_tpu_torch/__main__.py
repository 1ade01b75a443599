"""`python -m zero_latency_yolo_tpu_torch --config FILE [--device cpu]` starts
the detection server (on the CUDA device unless `--device cpu`)."""

from .runtime.server import main

if __name__ == "__main__":
    main()
