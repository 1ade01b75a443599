"""Device mesh and tensor-parallel placement for multi-device serving and
training.

The PyTorch counterpart of the JAX package's `parallel/mesh.py`. A mesh is a
(data, model) grid of `torch.device`s:

- data ("data"): the batch of client streams. Data row r serves rows
  [r * B / data, (r + 1) * B / data) of every batch on its own devices, and
  the device frame cache shards its slots over the rows (`ops/roi.py`).
- model ("model"): conv output channels (tensor parallelism). A conv block
  that the JAX package's rules shard (`_leaf_spec`) runs its output-channel
  slice on each device of the row, and the slices are gathered along
  channels (`models/yolov8.py` `tp_conv`), where XLA inserts the same
  all-gather in the JAX package.

One Python thread drives a row: the ops other than the sharded convs (the
concats, pools, upsampling, the decode and NMS) run once, on the row's first
device (its lead), which receives the gathered channels; each sharded conv
sends its input to the devices of the row. Replicated leaves run whole on
the lead.

A training state is placed one `TrainState` a device (`shard_state`, below;
`train/step.py` runs it): the same rules shard the training form's kernels
and biases, and every other leaf is copied to every device.

An explicit device list may repeat a device: a virtual mesh, which runs the
mesh's code path (the batch split, the channel slices and gathers, the
cross-shard cache copies) on one card or on the CPU, as the JAX tests run
theirs on forced host devices. The default list is `available_devices()`;
tests replace that function to get a virtual mesh.
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..models.weights import tree_from_leaves, tree_leaves, tree_map

DATA_AXIS = "data"
MODEL_AXIS = "model"

Params = Dict[str, Any]


def available_devices(device="cuda") -> List[torch.device]:
    """The devices a mesh is built from by default: every CUDA device, or
    `device` itself when the engine was asked for the CPU."""
    device = torch.device(device)
    if device.type == "cuda":
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [device]


@dataclass(frozen=True)
class Mesh:
    """A (data, model) grid of devices: devices[r][c] is model column c of
    data row r."""
    devices: Tuple[Tuple[torch.device, ...], ...]

    @property
    def data(self) -> int:
        return len(self.devices)

    @property
    def model(self) -> int:
        return len(self.devices[0])

    @property
    def shape(self) -> Dict[str, int]:
        return {DATA_AXIS: self.data, MODEL_AXIS: self.model}

    @property
    def flat(self) -> List[torch.device]:
        """The devices in row-major order (data row by data row)."""
        return [d for row in self.devices for d in row]

    @property
    def leads(self) -> List[torch.device]:
        """Each data row's first device, where the row's batch lives."""
        return [row[0] for row in self.devices]

    @property
    def virtual(self) -> bool:
        """True when a device appears more than once."""
        return len(set(self.flat)) < len(self.flat)

    def describe(self) -> str:
        return (f"{self.data}x{self.model} on "
                f"{','.join(str(d) for d in self.flat)}"
                + (" (virtual)" if self.virtual else ""))


def make_mesh(data: int = 1, model: int = 1,
              devices: Optional[Sequence] = None) -> Mesh:
    """Build a (data, model) mesh; data * model must equal len(devices)
    (default: `available_devices()`). Devices fill the grid row-major."""
    devices = [torch.device(d) for d in (
        devices if devices is not None else available_devices())]
    if data < 1 or model < 1 or data * model != len(devices):
        raise ValueError(f"mesh {data}x{model} != {len(devices)} devices")
    return Mesh(tuple(tuple(devices[r * model:(r + 1) * model])
                      for r in range(data)))


def batch_rows(mesh: Mesh, batch: int) -> List[slice]:
    """Each data row's slice of a batch of `batch` rows."""
    if batch % mesh.data:
        raise ValueError(f"batch {batch} does not divide over data="
                         f"{mesh.data}")
    per = batch // mesh.data
    return [slice(r * per, (r + 1) * per) for r in range(mesh.data)]


_HEAD_TIP = re.compile(r"/cv[23]/\d+/2/[wb]$")


def _leaf_spec(path: str, shape: Tuple[int, ...], model_size: int) -> tuple:
    """Tensor-parallel spec of one leaf of the JAX package's tree (HWIO
    kernels), the JAX package's `_leaf_spec` rule for rule, as a tuple of
    axis names (a PartitionSpec's entries; () is replicated):

    conv kernels (H, W, I, O) shard O over "model" when it divides and is
    at least 4 * model; biases (O,) likewise; BatchNorm vectors and scalars
    are replicated, and so are the detect head's tip convs
    (`.../cv{2,3}/<level>/2/{w,b}`), whose outputs the decode needs whole."""
    if model_size <= 1 or _HEAD_TIP.search(path):
        return ()
    if path.endswith("/w") and len(shape) == 4 and shape[3] % model_size == 0:
        return ((None, None, None, MODEL_AXIS) if shape[3] >= 4 * model_size
                else ())
    if path.endswith("/b") and len(shape) == 1 and shape[0] % model_size == 0:
        return (MODEL_AXIS,) if shape[0] >= 4 * model_size else ()
    return ()


def param_shardings(params: Params, mesh: Mesh):
    """The spec of every leaf of a JAX-layout tree (NumPy, HWIO), in the
    tree's structure: the JAX package's `param_shardings` with tuples in
    place of its NamedShardings."""
    def walk(node, path=""):
        if isinstance(node, dict):
            return {k: walk(v, path + k + "/") for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v, path + str(i) + "/") for i, v in enumerate(node)]
        return _leaf_spec(path[:-1], tuple(np.shape(node)), mesh.model)

    return walk(params)


def shards_conv(path: str, cout: int, model_size: int) -> bool:
    """Whether the conv block at `path` (its path in the JAX tree, e.g.
    "m2/cv1") with `cout` output channels runs channel-sharded: its
    kernel's spec is sharded (the bias's then is too: the same rule on the
    same count)."""
    return bool(_leaf_spec(path + "/w", (1, 1, 1, int(cout)), model_size))


def shard_params(params: Params, mesh: Mesh, dtype: torch.dtype,
                 **place_kw) -> List[Params]:
    """One placed tree per device of the mesh, row-major: device-form params
    (`models/weights.py` `params_from_jax`) placed by `place_params` with
    the device's model column as its shard. Sharded blocks are marked
    "shard"; `row_params` joins a row's trees into the tree its forward
    runs."""
    from ..models.weights import place_params
    return [place_params(params, dev, dtype, shard=(c, mesh.model), **place_kw)
            for row in mesh.devices for c, dev in enumerate(row)]


def row_params(mesh: Mesh, trees: Sequence[Params], row: int) -> Params:
    """The tree data row `row` runs (with `models/yolov8.py` `tp_conv`):
    the replicated blocks of its lead device's tree, and each sharded block
    as {"shards": [the block of each device of the row, in column order],
    "b": the whole bias on the lead} (the split C2f adds the whole bias
    after summing its pieces)."""
    own = list(trees[row * mesh.model:(row + 1) * mesh.model])
    lead = mesh.devices[row][0]

    def walk(nodes):
        first = nodes[0]
        if isinstance(first, list):
            return [walk([n[i] for n in nodes]) for i in range(len(first))]
        if "shard" in first:
            return {"shards": list(nodes),
                    "b": torch.cat([n["b"].to(lead) for n in nodes])}
        if "b" in first:
            return first
        return {k: walk([n[k] for n in nodes]) for k in first}

    return walk(own)


# ---------------------------------------------------------------------------
# A training state on a mesh: the JAX package's `train/step.py`
# `shard_state` / `shard_teacher`, over the training form (HWIO f32 leaves
# that require grad, BN unfolded). One `TrainState` a device, row-major: a
# leaf that `_leaf_spec` shards holds its model column's slice of the output
# channels (kernels on O, biases of O >= 4 * model), every other leaf (BN
# vectors, the head tips, small convs) a whole copy. The optimizer's moments
# and the EMA mirror the params leaf for leaf; the step count is on every
# copy.
# ---------------------------------------------------------------------------

def model_axis(spec: tuple) -> Optional[int]:
    """The axis a leaf's spec shards over "model", or None (replicated)."""
    return spec.index(MODEL_AXIS) if MODEL_AXIS in spec else None


def _column(leaf: torch.Tensor, spec: tuple, col: int, model: int,
            device) -> torch.Tensor:
    """A copy on `device` of what model column `col` holds of `leaf`: its
    slice of the sharded axis, or the whole leaf. Always a copy, so that
    the devices of a virtual mesh hold leaves of their own."""
    leaf = leaf.detach()
    axis = model_axis(spec)
    if axis is not None:
        n = leaf.shape[axis] // model
        leaf = leaf.narrow(axis, col * n, n)
    return leaf.to(device=device, copy=True)


def shard_state(state, mesh: Mesh):
    """Place a single-device `train/step.py` TrainState on the mesh: a
    MeshTrainState of one TrainState a device (see above)."""
    from ..train.optim import AdamWState
    from ..train.step import MeshTrainState, TrainState
    specs = param_shardings(state.params, mesh)
    spec_leaves = tree_leaves(specs)
    opt = state.opt_state
    states = []
    for row in mesh.devices:
        for col, dev in enumerate(row):
            def place(leaves):
                return [_column(x, s, col, mesh.model, dev)
                        for x, s in zip(leaves, spec_leaves)]
            params = [p.requires_grad_(True)
                      for p in place(tree_leaves(state.params))]
            ema = (None if state.ema_params is None else tree_from_leaves(
                state.ema_params, place(tree_leaves(state.ema_params))))
            states.append(TrainState(
                params=tree_from_leaves(state.params, params),
                opt_state=AdamWState(count=opt.count, mu=place(opt.mu),
                                     nu=place(opt.nu),
                                     sched_count=opt.sched_count),
                step=int(state.step), ema_params=ema))
    return MeshTrainState(mesh=mesh, specs=specs, states=states)


def join_leaves(mstate, parts: Sequence[List[torch.Tensor]],
                device=None) -> List[torch.Tensor]:
    """One whole tree's leaves (in `tree_leaves` order, on `device`, default
    the mesh's first device) from `parts`, the leaves of data row 0's
    devices in column order: each sharded leaf joined along its sharded
    axis, every other leaf the lead's copy."""
    mesh = mstate.mesh
    device = mesh.devices[0][0] if device is None else torch.device(device)
    out = []
    for i, spec in enumerate(tree_leaves(mstate.specs)):
        axis = model_axis(spec)
        if axis is None:
            out.append(parts[0][i].detach().to(device=device, copy=True))
        else:
            out.append(torch.cat([p[i].detach().to(device) for p in parts],
                                 axis))
    return out


def join_state(mstate, device=None):
    """The single-device TrainState of a MeshTrainState, on `device`
    (default: the mesh's first device), from data row 0's states
    (`join_leaves`). Checkpoints and eval use it."""
    from ..train.optim import AdamWState
    from ..train.step import TrainState
    row0 = mstate.states[:mstate.mesh.model]

    def join(parts):
        return join_leaves(mstate, parts, device)

    lead = row0[0]
    params = [p.requires_grad_(True) for p in join(
        [tree_leaves(s.params) for s in row0])]
    ema = (None if lead.ema_params is None else tree_from_leaves(
        lead.ema_params, join([tree_leaves(s.ema_params) for s in row0])))
    opt = lead.opt_state
    return TrainState(
        params=tree_from_leaves(lead.params, params),
        opt_state=AdamWState(count=opt.count,
                             mu=join([s.opt_state.mu for s in row0]),
                             nu=join([s.opt_state.nu for s in row0]),
                             sched_count=opt.sched_count),
        step=int(lead.step), ema_params=ema)


def shard_teacher(params: Params, mesh: Mesh) -> List[Params]:
    """A distillation teacher (a training-form or NumPy tree) replicated:
    one f32 copy on each data row's lead, in row order."""
    return [tree_map(lambda a: torch.as_tensor(a, dtype=torch.float32)
                     .detach().to(lead), params) for lead in mesh.leads]


def train_row_params(mstate, row: int) -> Params:
    """The training-form tree data row `row` runs (with `models/yolov8.py`
    `tp_train_conv`): each sharded conv block as {"shards": [the block of
    each device of the row, in column order]}, each whole block the lead
    device's."""
    mesh = mstate.mesh
    own = [s.params for s in
           mstate.states[row * mesh.model:(row + 1) * mesh.model]]

    def walk(nodes, spec):
        first = nodes[0]
        if isinstance(first, list):
            return [walk([n[i] for n in nodes], spec[i])
                    for i in range(len(first))]
        if isinstance(first.get("w"), torch.Tensor):
            return {"shards": list(nodes)} if spec["w"] else first
        return {k: walk([n[k] for n in nodes], spec[k]) for k in first}

    return walk(own, mstate.specs)
