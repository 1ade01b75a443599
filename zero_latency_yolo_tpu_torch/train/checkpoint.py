"""Training checkpoint / resume in the JAX package's npz layout.

The port's counterpart of the JAX package's `train/checkpoint.py`, its npz
fallback only (there is no orbax on the card's machine):

    <dir>/ckpt_<step:08d>/params.npz   flat "m0/bn/var"-keyed params
                          ema.npz      the same for the EMA (when on)
                          opt.npz      leaf_0..leaf_n: the optimizer state's
                                       leaves in `jax.tree.flatten` order
                          meta.json    {"step": step}

written to `ckpt_<step>.tmp` and renamed into place, keeping the newest
`max_to_keep`. The keys, layouts and leaf order are the JAX package's, so a
checkpoint written by either package resumes in the other. A state on a mesh
(`train/step.py` MeshTrainState) is saved joined (`parallel/mesh.py`
`join_state`: the sharded leaves whole again), the same files as a
single-device state's, and restoring into a meshed template places the
state on the template's mesh, as the JAX loop re-shards after a restore; so
a checkpoint resumes in either layout.
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Optional

import numpy as np

from ..models.weights import (flatten, train_params_from_jax,
                              train_params_to_numpy, tree_leaves, tree_map,
                              unflatten)
from ..parallel.mesh import join_state, shard_state
from ..utils.logging import get_logger
from .optim import AdamW
from .step import MeshTrainState, TrainState

log = get_logger("checkpoint")


class CheckpointManager:
    def __init__(self, directory: str, max_to_keep: int = 3) -> None:
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        os.makedirs(self.directory, exist_ok=True)

    def _ckpts(self):
        return sorted(d for d in os.listdir(self.directory)
                      if d.startswith("ckpt_") and not d.endswith(".tmp"))

    # ------------------------------------------------------------------ save
    def save(self, state, tx: AdamW) -> int:
        if isinstance(state, MeshTrainState):
            state = join_state(state)
        step = int(state.step)
        path = os.path.join(self.directory, f"ckpt_{step:08d}")
        tmp = path + ".tmp"
        os.makedirs(tmp, exist_ok=True)
        np.savez(os.path.join(tmp, "params.npz"),
                 **flatten(train_params_to_numpy(state.params)))
        if state.ema_params is not None:
            np.savez(os.path.join(tmp, "ema.npz"),
                     **flatten(train_params_to_numpy(state.ema_params)))
        np.savez(os.path.join(tmp, "opt.npz"),
                 **{f"leaf_{i}": a for i, a in
                    enumerate(tx.state_leaves(state.opt_state))})
        with open(os.path.join(tmp, "meta.json"), "w") as f:
            json.dump({"step": step}, f)
        if os.path.exists(path):
            shutil.rmtree(path)
        os.rename(tmp, path)
        for d in self._ckpts()[:-self.max_to_keep]:
            shutil.rmtree(os.path.join(self.directory, d))
        return step

    # --------------------------------------------------------------- restore
    def latest_step(self) -> Optional[int]:
        ckpts = self._ckpts()
        return int(ckpts[-1].split("_")[1]) if ckpts else None

    def restore(self, template, tx: AdamW, step: Optional[int] = None):
        """Restore onto the device of `template`'s params, or onto its mesh
        for a MeshTrainState template; its EMA presence decides the EMA's
        (the JAX package's rules: a file's EMA is dropped when the run has
        none, and seeded from the restored params when the run has one and
        the file not). Returns None when no checkpoint exists."""
        if isinstance(template, MeshTrainState):
            state = self.restore(template.states[0], tx, step)
            return None if state is None else shard_state(state,
                                                          template.mesh)
        target = step if step is not None else self.latest_step()
        if target is None:
            return None
        path = os.path.join(self.directory, f"ckpt_{target:08d}")
        dev = tree_leaves(template.params)[0].device
        with np.load(os.path.join(path, "params.npz")) as z:
            params = train_params_from_jax(
                unflatten({k: z[k] for k in z.files}), device=dev)
        params = tree_map(lambda p: p.requires_grad_(True), params)
        with np.load(os.path.join(path, "opt.npz")) as z:
            leaves = [z[f"leaf_{i}"] for i in range(len(z.files))]
        opt_state = tx.state_from_leaves(leaves, tree_leaves(params))
        ema = None
        ema_path = os.path.join(path, "ema.npz")
        if template.ema_params is not None:
            if os.path.exists(ema_path):
                with np.load(ema_path) as z:
                    ema = train_params_from_jax(
                        unflatten({k: z[k] for k in z.files}), device=dev)
            else:
                log.warning("checkpoint %d has no EMA state; the EMA resumes "
                            "seeded from the restored params", target)
                ema = tree_map(lambda p: p.detach().clone(), params)
        elif os.path.exists(ema_path):
            log.warning("checkpoint %d carries EMA state but this run has "
                        "no EMA; the file's EMA is discarded", target)
        return TrainState(params=params, opt_state=opt_state,
                          step=int(target), ema_params=ema)


__all__ = ["CheckpointManager"]
