# Top-level build/test entry points.

.PHONY: all native test test-fast test-native test-native-torch release-check bench serve clean

all: native

native:
	$(MAKE) -C zero_latency_yolo_tpu/native

test: native
	python -m pytest tests/ -q

test-fast: native
	python -m pytest tests/test_protocol.py tests/test_config.py \
	  tests/test_tracker.py tests/test_native_codec.py -q

test-native:
	$(MAKE) -C zero_latency_yolo_tpu/native test-native

# The PyTorch port's native codec (zero_latency_yolo_tpu_torch/native/) under
# ASan + UBSan with the flags of test-native: its checks, then the fuzz. The
# binary goes to build/native-test/ (git-ignored).
TORCH_NATIVE := zero_latency_yolo_tpu_torch/native
TORCH_NATIVE_TEST := build/native-test/codec_test_asan

test-native-torch: $(TORCH_NATIVE)/codec.cpp $(TORCH_NATIVE)/udp.cpp \
  $(TORCH_NATIVE)/codec_test.cpp $(TORCH_NATIVE)/codec.h
	mkdir -p $(dir $(TORCH_NATIVE_TEST))
	$(CXX) -O1 -g -Wall -std=c++17 -fPIC -fsanitize=address,undefined \
	  -fno-omit-frame-pointer -o $(TORCH_NATIVE_TEST) \
	  $(TORCH_NATIVE)/codec.cpp $(TORCH_NATIVE)/udp.cpp \
	  $(TORCH_NATIVE)/codec_test.cpp
	./$(TORCH_NATIVE_TEST)
	./$(TORCH_NATIVE_TEST) fuzz 200000

# One-command acceptance: native ASan/UBSan + fuzz, full suite (virtual
# 8-device CPU mesh), bench mechanics. ~25 min on a 1-core host.
release-check: test-native test bench-smoke
	@echo "release-check: all green"

bench:
	python bench.py

bench-smoke:
	ZLT_BENCH_SMOKE=1 python bench.py

serve: native
	python -m zero_latency_yolo_tpu.runtime.server --config configs/server.json

clean:
	$(MAKE) -C zero_latency_yolo_tpu/native clean
	find . -name __pycache__ -type d -exec rm -rf {} +
