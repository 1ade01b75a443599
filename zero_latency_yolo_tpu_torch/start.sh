#!/usr/bin/env bash
# Bootstrap and launch the PyTorch port's detection server (the port's copy
# of scripts/start.sh). The model comes from configs/server.json's
# model_path: an .onnx exported by ultralytics, a .pt or a native .npz;
# missing weights => simulation mode. Arguments are passed to the server
# (e.g. --device cpu; without it the server needs a CUDA device).
#
#   zero_latency_yolo_tpu_torch/start.sh [--device cpu]
set -euo pipefail
cd "$(dirname "$0")/.."

echo "[1/5] building the native codec"
python -c "from zero_latency_yolo_tpu_torch.protocol import native; \
assert native.HAVE_NATIVE, 'native codec did not build'; print('native codec built')"

echo "[2/5] building the kernels (on a CUDA device)"
python -c "import torch
if torch.cuda.is_available():
    from zero_latency_yolo_tpu_torch.ops import _build
    k = _build.kernels()
    print(f'kernels built: {k.path.name} in {k.build_seconds:.1f} s')
else:
    print('no CUDA device: the kernels are built on a card only')"

echo "[3/5] preparing directories; checking the config"
mkdir -p logs models configs
python -c "from zero_latency_yolo_tpu_torch.config import ServerConfig; \
c = ServerConfig.load('configs/server.json'); print('config ok:', c.model_path)"

echo "[4/5] running the quick self-test (the port's wire protocol and its"
echo "      config packets; --noconftest: tests/conftest.py imports JAX)"
python -m pytest --noconftest -p no:cacheprovider tests/test_torch_protocol.py -q

echo "[5/5] starting the detection server"
exec python -m zero_latency_yolo_tpu_torch --config configs/server.json "$@"
