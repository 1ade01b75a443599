"""The train step: frozen-BN training forward, loss, gradient over every
leaf, the optimizer and the EMA, on one device.

The PyTorch counterpart of the JAX package's `train/step.py`. The forward
and backward are autograd over `F.conv2d` and elementwise ops (the JAX step
reaches no Pallas kernel either: its kernels hang only on the serving
engine's hooks). Differences that are by design:

- The step updates its state in place and returns it (the JAX step donates
  its input state and returns a new one).
- No mesh: `mesh_data * mesh_model > 1` is refused.
- An f32 step runs under `runtime/engine.py` `full_f32_precision`, so
  PyTorch's default TF32 does not change it.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from ..models.weights import tree_leaves, tree_map
from ..models.yolov8 import ModelSpec, forward_train_raw
from ..runtime.engine import full_f32_precision
from .loss import detection_loss, distill_loss
from .optim import AdamW, AdamWState

Params = Dict[str, Any]


@dataclass
class TrainState:
    """Params (the training form: the JAX tree's keys, HWIO, f32 leaf
    tensors that require grad), the optimizer's state, the step count and
    the EMA of the params (None when the EMA is off; deployed checkpoints
    should serve the EMA weights)."""
    params: Params
    opt_state: AdamWState
    step: int
    ema_params: Optional[Params] = None


def init_train_state(params: Params, tx: AdamW, ema: bool = False
                     ) -> TrainState:
    """A fresh state over training-form `params` (`models/weights.py`
    `train_params_from_jax`): every leaf, BN mean and var included,
    requires grad, as every leaf of the JAX tree is trained."""
    params = tree_map(lambda p: p.detach().clone().requires_grad_(True),
                      params)
    return TrainState(
        params=params, opt_state=tx.init(tree_leaves(params)), step=0,
        ema_params=(tree_map(lambda p: p.detach().clone(), params)
                    if ema else None))


def check_single_device(mesh_data: int = 1, mesh_model: int = 1) -> None:
    """Refuse a mesh, as the engine's `_check_supported` does."""
    if int(mesh_data) * int(mesh_model) > 1:
        raise ValueError("not implemented in the PyTorch port: "
                         "mesh_data/mesh_model > 1")


def ema_decay_at(ema_decay: float, step: int) -> torch.Tensor:
    """The ramped EMA decay d = ema_decay * (1 - exp(-(step + 1) / 2000)) of
    the JAX step (ultralytics ModelEMA), in f32."""
    t = torch.tensor(float(step), dtype=torch.float32) + 1.0
    return (torch.tensor(ema_decay, dtype=torch.float32)
            * (1.0 - torch.exp(-t / 2000.0)))


def make_train_step(spec: ModelSpec, tx: AdamW, input_hw: Tuple[int, int],
                    dtype=torch.bfloat16, remat: bool = False,
                    ema_decay: float = 0.9998, assigner: str = "center",
                    teacher_spec: Optional[ModelSpec] = None,
                    distill_weight: float = 1.0,
                    distill_box_weight: float = 1.0,
                    distill_temp: float = 2.0,
                    mesh_data: int = 1, mesh_model: int = 1) -> Callable:
    """Build the train step.

    step(state, images (B,H,W,3) f32 in [0,1], targets (B,M,5)) ->
    (state, metrics), on the device the state's params live on. With
    teacher_spec set the step distills: it takes a fourth argument, the
    teacher's params (training form or a folded tree in that form; the
    teacher forward runs under `torch.no_grad`), and adds distill_weight *
    distill_loss. remat=True recomputes the forward in the backward pass
    (`torch.utils.checkpoint`), trading FLOPs for activation memory.
    """
    check_single_device(mesh_data, mesh_model)

    def fwd(params, images):
        return forward_train_raw(params, spec, images, dtype=dtype)

    def forward(params, images):
        if not remat:
            return fwd(params, images)
        return checkpoint(lambda x: fwd(params, x), images,
                          use_reentrant=False)

    def precision():
        return (full_f32_precision() if dtype == torch.float32
                else contextlib.nullcontext())

    def train_step(state: TrainState, images, targets, teacher_params=None):
        if teacher_spec is not None and teacher_params is None:
            raise ValueError(
                "this train step was built with teacher_spec (distill "
                "mode): call it as step(state, images, targets, "
                "teacher_params)")
        leaves: List[torch.Tensor] = tree_leaves(state.params)
        dev = leaves[0].device
        images = torch.as_tensor(images, device=dev, dtype=torch.float32)
        targets = torch.as_tensor(targets, device=dev, dtype=torch.float32)
        with precision():
            teacher_outs = None
            if teacher_spec is not None:
                with torch.no_grad():
                    teacher_outs = forward_train_raw(
                        teacher_params, teacher_spec, images, dtype=dtype)
            outs = forward(state.params, images)
            loss, metrics = detection_loss(spec, outs, targets, input_hw,
                                           assigner=assigner)
            if teacher_outs is not None:
                kd, kd_metrics = distill_loss(spec, teacher_outs, outs,
                                              temp=distill_temp,
                                              w_box=distill_box_weight)
                loss = loss + distill_weight * kd
                metrics = dict(metrics, **kd_metrics)
            grads = torch.autograd.grad(loss, leaves)
        tx.update(grads, state.opt_state, leaves)
        if state.ema_params is not None:
            d = ema_decay_at(ema_decay, state.step).to(dev)
            ema = tree_leaves(state.ema_params)
            with torch.no_grad():
                torch._foreach_mul_(ema, d)
                torch._foreach_add_(ema, torch._foreach_mul(leaves, 1 - d))
        state.step += 1
        metrics = {k: v.detach() for k, v in dict(metrics, loss=loss).items()}
        return state, metrics

    return train_step


__all__ = ["TrainState", "check_single_device", "ema_decay_at",
           "init_train_state", "make_train_step"]
