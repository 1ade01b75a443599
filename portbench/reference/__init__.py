"""The plain reference that decides a run's `correct`.

Plain PyTorch in float32 (TF32 off), channels-first, written from the
published YOLOv8 description (ultralytics `yolov8.yaml`) and the serving
contract it is held to: the frame rebuilt from its keyframe and region
writes, the letterbox, the forward, the DFL decode, class-weighted
threshold, top-K and greedy same-class NMS, and the packed detections.

It imports neither JAX nor anything of the program under test, and takes
nothing the program made: it reads the weight file and the generator's
frames itself.
"""
