"""The train step: frozen-BN training forward, loss, gradient over every
leaf, the optimizer and the EMA, on one device or on a (data, model) mesh.

The PyTorch counterpart of the JAX package's `train/step.py`. The forward
and backward are autograd over `F.conv2d` and elementwise ops (the JAX step
reaches no Pallas kernel either: its kernels hang only on the serving
engine's hooks). Differences that are by design:

- The step updates its state in place and returns it (the JAX step donates
  its input state and returns a new one).
- An f32 step runs under `runtime/engine.py` `full_f32_precision` (on every
  device: the setting is process-wide), so PyTorch's default TF32 does not
  change it.

On a mesh (`make_train_step(mesh=...)`, or `mesh_data` x `mesh_model` over
`parallel.mesh.available_devices`) the step computes the same function as on
one device, as the JAX step under `jit` with shardings does:

- the state is a MeshTrainState (`parallel/mesh.py` `shard_state`): one
  TrainState a device, conv output channels sharded over "model" by the JAX
  package's `_leaf_spec` rules, every other leaf copied to every device;
- data row r runs rows `batch_rows(mesh, B)[r]` of the batch on its devices
  (`models/yolov8.py` `tp_train_conv` for the sharded blocks), and the head
  maps of every row (and the teacher's, which runs per row on each row's
  lead under `no_grad`) are gathered onto the first device, where the loss
  runs over the whole batch: its normalizer is global, as JAX's;
- one backward over every device's leaves; a sharded leaf's gradient is the
  sum over the data rows of its column, a replicated leaf's the sum over
  every device that holds a copy (a copy not used on a device gets none),
  and each holder gets that one sum, so the copies stay bit-equal;
- the gradient is clipped by the global norm counted once (each sharded
  slice once, each replicated leaf once), then every device applies the
  same optimizer update and EMA to its leaves.

A mesh wider than the devices warns and trains on one device (the serving
engine's rule): the step is then the single-device step, on the device the
state lives on.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from ..models.weights import tree_leaves, tree_map
from ..models.yolov8 import ModelSpec, forward_train_raw, tp_train_conv
from ..parallel import mesh as mesh_mod
from ..runtime.engine import full_f32_precision
from ..utils.logging import get_logger
from .loss import detection_loss, distill_loss
from .optim import AdamW, AdamWState

log = get_logger("train")

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


@dataclass
class MeshTrainState:
    """A TrainState placed on a mesh (`parallel/mesh.py` `shard_state`):
    `states[i]` is device `mesh.flat[i]`'s TrainState (its column's slice of
    each sharded leaf, a copy of every other leaf, its moments and EMA
    alike); `specs` is the spec tree of the whole params
    (`param_shardings`). `parallel/mesh.py` `join_state` gives back the
    single-device state."""
    mesh: "mesh_mod.Mesh"
    specs: Params
    states: List[TrainState]

    @property
    def step(self) -> int:
        return self.states[0].step


def ema_decay_at(ema_decay: float, step: int) -> torch.Tensor:
    """The ramped EMA decay d = ema_decay * (1 - exp(-(step + 1) / 2000)) of
    the JAX step (ultralytics ModelEMA), in f32."""
    t = torch.tensor(float(step), dtype=torch.float32) + 1.0
    return (torch.tensor(ema_decay, dtype=torch.float32)
            * (1.0 - torch.exp(-t / 2000.0)))


def train_mesh(mesh_data: int, mesh_model: int, device="cuda"
               ) -> Optional["mesh_mod.Mesh"]:
    """The mesh mesh_data x mesh_model over `available_devices(device)`, or
    None (one device) when it is 1x1 or wider than the devices, with a
    warning then."""
    n = int(mesh_data) * int(mesh_model)
    if n <= 1:
        return None
    devices = mesh_mod.available_devices(device)
    if len(devices) >= n:
        return mesh_mod.make_mesh(int(mesh_data), int(mesh_model),
                                  devices[:n])
    log.warning("train mesh %dx%d needs %d devices, have %d — single-device "
                "training", mesh_data, mesh_model, n, len(devices))
    return None


def reduce_mesh_grads(mstate: MeshTrainState, grads: List[list]
                      ) -> Tuple[List[list], torch.Tensor]:
    """grads[d][i]: device d's gradient of its leaf i (None where the leaf
    was not used there). Returns each device's reduced gradients (a sharded
    leaf: the sum over the data rows of its column; any other: the sum over
    every device) and the global norm over the whole tree, counting each
    sharded slice and each replicated leaf once, on the first device. Each
    sum is formed once and copied to its holders, so copies stay equal."""
    mesh = mstate.mesh
    devs, m = mesh.flat, mesh.model
    out = [[None] * len(g) for g in grads]
    squares = []
    with torch.no_grad():
        for i, spec in enumerate(tree_leaves(mstate.specs)):
            if mesh_mod.model_axis(spec) is None:
                groups = [list(range(len(devs)))]
            else:
                groups = [[r * m + c for r in range(mesh.data)]
                          for c in range(m)]
            parts = []
            for holders in groups:
                home = devs[holders[0]]
                total = None
                for d in holders:
                    if grads[d][i] is not None:
                        g = grads[d][i].to(home)
                        total = g if total is None else total + g
                if total is None:
                    total = torch.zeros_like(
                        tree_leaves(mstate.states[holders[0]].params)[i])
                for d in holders:
                    out[d][i] = total.to(devs[d])
                parts.append(torch.sum(total * total).to(devs[0]))
            squares.append(parts[0] if len(parts) == 1
                           else torch.sum(torch.stack(parts)))
        g_norm = torch.sqrt(torch.sum(torch.stack(squares)))
    return out, g_norm


def make_train_step(spec: ModelSpec, tx: AdamW, input_hw: Tuple[int, int],
                    dtype=torch.bfloat16, remat: bool = False,
                    ema_decay: float = 0.9998, assigner: str = "center",
                    teacher_spec: Optional[ModelSpec] = None,
                    distill_weight: float = 1.0,
                    distill_box_weight: float = 1.0,
                    distill_temp: float = 2.0,
                    mesh: Optional["mesh_mod.Mesh"] = None,
                    mesh_data: int = 1, mesh_model: int = 1,
                    device="cuda") -> Callable:
    """Build the train step.

    step(state, images (B,H,W,3) f32 in [0,1], targets (B,M,5)) ->
    (state, metrics), on the device the state's params live on. With
    teacher_spec set the step distills: it takes a fourth argument, the
    teacher's params (training form or a folded tree in that form; the
    teacher forward runs under `torch.no_grad`), and adds distill_weight *
    distill_loss. remat=True recomputes the forward in the backward pass
    (`torch.utils.checkpoint`), trading FLOPs for activation memory.

    mesh: a `parallel.mesh` Mesh to train on; mesh_data / mesh_model build
    one over `available_devices(device)` instead (see `train_mesh`). On a
    mesh the state is the MeshTrainState that `step.shard_state(state)`
    places, the batch must divide over mesh.data, and the teacher is the
    list `step.shard_teacher(params)` places (one copy a data row). The
    step carries `mesh` (None on one device), `shard_state` and
    `shard_teacher` (identities on one device), as the JAX step carries
    the last two, and `value_and_grad(state, images, targets[, teacher])`:
    the step's (loss, metrics, gradient of every leaf of the whole tree)
    without the update.
    """
    if mesh is None:
        mesh = train_mesh(mesh_data, mesh_model, device)
    elif mesh.data * mesh.model == 1:
        mesh = None
    conv_fn = tp_train_conv if mesh is not None and mesh.model > 1 else None

    def fwd(params, images):
        return forward_train_raw(params, spec, images, dtype=dtype,
                                 conv_fn=conv_fn)

    def forward(params, images):
        if not remat:
            return fwd(params, images)
        return checkpoint(lambda x: fwd(params, x), images,
                          use_reentrant=False)

    def precision():
        return (full_f32_precision() if dtype == torch.float32
                else contextlib.nullcontext())

    def need_teacher(teacher_params):
        if teacher_spec is not None and teacher_params is None:
            raise ValueError(
                "this train step was built with teacher_spec (distill "
                "mode): call it as step(state, images, targets, "
                "teacher_params)")

    def loss_of(outs, targets, teacher_outs):
        loss, metrics = detection_loss(spec, outs, targets, input_hw,
                                       assigner=assigner)
        if teacher_outs is not None:
            kd, kd_metrics = distill_loss(spec, teacher_outs, outs,
                                          temp=distill_temp,
                                          w_box=distill_box_weight)
            loss = loss + distill_weight * kd
            metrics = dict(metrics, **kd_metrics)
        return loss, metrics

    def finish(state: TrainState, grads, leaves, g_norm=None) -> None:
        """The optimizer update, the EMA and the count of one state."""
        tx.update(grads, state.opt_state, leaves, g_norm=g_norm)
        if state.ema_params is not None:
            d = ema_decay_at(ema_decay, state.step).to(leaves[0].device)
            ema = tree_leaves(state.ema_params)
            with torch.no_grad():
                torch._foreach_mul_(ema, d)
                torch._foreach_add_(ema, torch._foreach_mul(leaves, 1 - d))
        state.step += 1

    def done(metrics, loss):
        return {k: v.detach() for k, v in dict(metrics, loss=loss).items()}

    def value_and_grad(state: TrainState, images, targets,
                       teacher_params=None):
        """(loss, metrics, the gradient of every leaf in `tree_leaves`
        order) of one step, without the update."""
        need_teacher(teacher_params)
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
            loss, metrics = loss_of(forward(state.params, images), targets,
                                    teacher_outs)
            grads = torch.autograd.grad(loss, leaves)
        return loss, metrics, list(grads)

    def train_step(state: TrainState, images, targets, teacher_params=None):
        loss, metrics, grads = value_and_grad(state, images, targets,
                                              teacher_params)
        finish(state, grads, tree_leaves(state.params))
        return state, done(metrics, loss)

    if mesh is None:
        train_step.mesh = None
        train_step.shard_state = lambda state: state
        train_step.shard_teacher = lambda params: params
        train_step.value_and_grad = value_and_grad
        return train_step

    def gather(row_outs, dev):
        return [torch.cat([o[lvl].to(dev) for o in row_outs])
                for lvl in range(len(row_outs[0]))]

    def mesh_grads(mstate: MeshTrainState, images, targets, teacher_params):
        """(loss, metrics, each device's reduced gradients, the global
        norm) of one meshed step, without the update."""
        need_teacher(teacher_params)
        if not isinstance(mstate, MeshTrainState) or mstate.mesh != mesh:
            raise TypeError(
                f"this train step runs on mesh {mesh.describe()}: pass the "
                "state that step.shard_state(state) placed on it")
        rows = mesh_mod.batch_rows(mesh, len(images))
        first = mesh.devices[0][0]
        with precision():
            outs, teacher_outs = [], []
            for r, sl in enumerate(rows):
                x = torch.as_tensor(images[sl], device=mesh.devices[r][0],
                                    dtype=torch.float32)
                if teacher_spec is not None:
                    with torch.no_grad():
                        teacher_outs.append(forward_train_raw(
                            teacher_params[r], teacher_spec, x, dtype=dtype))
                outs.append(forward(mesh_mod.train_row_params(mstate, r), x))
            targets = torch.as_tensor(targets, device=first,
                                      dtype=torch.float32)
            loss, metrics = loss_of(
                gather(outs, first), targets,
                gather(teacher_outs, first) if teacher_outs else None)
            leaves = [tree_leaves(s.params) for s in mstate.states]
            n = len(leaves[0])
            flat = torch.autograd.grad(
                loss, [p for ls in leaves for p in ls], allow_unused=True)
        grads, g_norm = reduce_mesh_grads(
            mstate, [list(flat[d * n:(d + 1) * n])
                     for d in range(len(leaves))])
        return loss, metrics, grads, g_norm

    def mesh_value_and_grad(mstate: MeshTrainState, images, targets,
                            teacher_params=None):
        """(loss, metrics, the whole tree's gradient joined on the mesh's
        first device) of one meshed step, without the update."""
        loss, metrics, grads, _ = mesh_grads(mstate, images, targets,
                                             teacher_params)
        return loss, metrics, mesh_mod.join_leaves(mstate,
                                                   grads[:mesh.model])

    def mesh_step(mstate: MeshTrainState, images, targets,
                  teacher_params=None):
        loss, metrics, grads, g_norm = mesh_grads(mstate, images, targets,
                                                  teacher_params)
        for state, g, dev in zip(mstate.states, grads, mesh.flat):
            finish(state, g, tree_leaves(state.params),
                   g_norm=g_norm.to(dev))
        return mstate, done(metrics, loss)

    mesh_step.mesh = mesh
    mesh_step.shard_state = lambda state: mesh_mod.shard_state(state, mesh)
    mesh_step.shard_teacher = lambda params: mesh_mod.shard_teacher(params,
                                                                    mesh)
    mesh_step.value_and_grad = mesh_value_and_grad
    log.info("train mesh active: data=%d model=%d (%s)", mesh.data,
             mesh.model, mesh.describe())
    return mesh_step


__all__ = ["MeshTrainState", "TrainState", "ema_decay_at",
           "init_train_state", "make_train_step", "reduce_mesh_grads",
           "train_mesh"]
