"""The optimizer of the train loop: the port's counterpart of the optax chain
that the JAX package's `train/loop.py` builds,

    optax.chain(optax.clip_by_global_norm(10.0),
                optax.adamw(lr, weight_decay=1e-4))

with optax's defaults (b1 0.9, b2 0.999, eps 1e-8, eps_root 0, no nesterov)
and the weight decay on every leaf (optax's mask is None). `lr` is a
constant or optax's `warmup_cosine_decay_schedule(0, peak, warmup,
max(steps, warmup + 1), 0.05 * peak)`, indexed by the optimizer's own count.

Written over the leaf list with `torch._foreach_*` ops, in optax's order of
operations (`torch.optim.AdamW` decays the weights before the Adam step and
by lr * wd; optax adds wd * p to the Adam direction, then scales by -lr),
and with optax's state: `state_leaves` gives the leaves of the chain's
state in the order `jax.tree.flatten` gives them (count, mu, nu, and the
schedule's count for a schedule), so `train/checkpoint.py` writes and reads
the JAX package's opt.npz.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, List, Optional, Sequence, Union

import numpy as np
import torch

CLIP_NORM = 10.0
WEIGHT_DECAY = 1e-4
B1, B2, EPS = 0.9, 0.999, 1e-8  # optax's eps_root is 0

Schedule = Callable[[int], float]


def warmup_cosine_decay_schedule(init_value: float, peak_value: float,
                                 warmup_steps: int, decay_steps: int,
                                 end_value: float) -> Schedule:
    """optax's schedule of the same name (exponent 1) in f32, as optax
    computes it: a linear ramp from init to peak over warmup_steps, then a
    cosine from peak to end over decay_steps - warmup_steps. Returns the
    rate for an optimizer count as a float."""
    if decay_steps - warmup_steps <= 0:
        raise ValueError("the cosine part needs decay_steps > warmup_steps")
    f32 = np.float32
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value
    cos_steps = f32(decay_steps - warmup_steps)

    def linear(count: int) -> np.float32:
        if warmup_steps <= 0:
            return f32(init_value)
        c = f32(min(max(count, 0), warmup_steps))
        frac = f32(1) - c / f32(warmup_steps)
        return (f32(init_value) - f32(peak_value)) * frac + f32(peak_value)

    def cosine(count: int) -> np.float32:
        c = np.minimum(f32(count), cos_steps)
        decay = f32(0.5) * (f32(1) + np.cos(f32(np.pi) * c / cos_steps,
                                            dtype=np.float32))
        return f32(peak_value) * ((f32(1) - f32(alpha)) * decay + f32(alpha))

    def schedule(count: int) -> float:
        out = linear(count) if count < warmup_steps else cosine(
            count - warmup_steps)
        return float(np.float32(out))

    return schedule


def global_norm(grads: Sequence[torch.Tensor]) -> torch.Tensor:
    """optax's global norm: sqrt of the sum of each leaf's sum of squares."""
    return torch.sqrt(torch.sum(torch.stack([torch.sum(g * g)
                                             for g in grads])))


@dataclass
class AdamWState:
    """optax's state of the chain: ScaleByAdamState(count, mu, nu) and, with
    a schedule, ScaleByScheduleState(count). The moments are lists in the
    order of `models/weights.py` `tree_leaves`."""
    count: int
    mu: List[torch.Tensor]
    nu: List[torch.Tensor]
    sched_count: Optional[int] = None


class AdamW:
    """clip_by_global_norm(10) then adamw(lr, weight_decay=1e-4)."""

    def __init__(self, lr: Union[float, Schedule]) -> None:
        self.lr = lr
        self.scheduled = callable(lr)

    def init(self, leaves: Sequence[torch.Tensor]) -> AdamWState:
        return AdamWState(
            count=0, mu=[torch.zeros_like(p) for p in leaves],
            nu=[torch.zeros_like(p) for p in leaves],
            sched_count=0 if self.scheduled else None)

    def rate(self, state: AdamWState) -> float:
        """The rate this update uses: the schedule at its own count."""
        return self.lr(state.sched_count) if self.scheduled else self.lr

    @torch.no_grad()
    def update(self, grads: Sequence[torch.Tensor],
               state: AdamWState, params: Sequence[torch.Tensor],
               g_norm: Optional[torch.Tensor] = None) -> None:
        """Apply one update to `params` (in place) and advance `state`.
        g_norm: the global norm to clip by, when the leaves are one device's
        part of a larger tree (a mesh); default: the norm of `grads`."""
        grads = list(grads)
        params = list(params)
        # clip_by_global_norm: sqrt of the sum of each leaf's sum of squares;
        # every leaf kept below max_norm, else (g / norm) * max_norm.
        if g_norm is None:
            g_norm = global_norm(grads)
        keep = g_norm < CLIP_NORM
        grads = [torch.where(keep, g, g / g_norm * CLIP_NORM) for g in grads]
        # scale_by_adam: the moments, then the bias-corrected direction.
        torch._foreach_mul_(state.mu, B1)
        torch._foreach_add_(state.mu, torch._foreach_mul(grads, 1 - B1))
        torch._foreach_mul_(state.nu, B2)
        torch._foreach_add_(state.nu, torch._foreach_mul(
            torch._foreach_mul(grads, grads), 1 - B2))
        state.count = min(state.count + 1, 2 ** 31 - 1)
        bc1 = 1 - np.float32(B1) ** np.float32(state.count)
        bc2 = 1 - np.float32(B2) ** np.float32(state.count)
        mu_hat = torch._foreach_div(state.mu, float(bc1))
        den = torch._foreach_sqrt(torch._foreach_div(state.nu, float(bc2)))
        torch._foreach_add_(den, EPS)
        upd = torch._foreach_div(mu_hat, den)
        # add_decayed_weights on every leaf, then scale by -lr.
        torch._foreach_add_(upd, torch._foreach_mul(params, WEIGHT_DECAY))
        lr = self.rate(state)
        torch._foreach_mul_(upd, -lr)
        torch._foreach_add_(params, upd)
        if self.scheduled:
            state.sched_count = min(state.sched_count + 1, 2 ** 31 - 1)

    # -------------------------------------------------------- optax's leaves
    def state_leaves(self, state: AdamWState) -> List[np.ndarray]:
        """The chain's state as `jax.tree.flatten` lists it: count (int32),
        mu's leaves, nu's leaves, then the schedule's count (int32)."""
        out = [np.asarray(state.count, np.int32)]
        out += [m.detach().cpu().numpy() for m in state.mu]
        out += [v.detach().cpu().numpy() for v in state.nu]
        if self.scheduled:
            out.append(np.asarray(state.sched_count, np.int32))
        return out

    def state_from_leaves(self, leaves: Sequence[np.ndarray],
                          like: Sequence[torch.Tensor]) -> AdamWState:
        """The inverse of `state_leaves`, each moment placed like the param
        leaf at its position in `like`."""
        n = len(like)
        want = 1 + 2 * n + (1 if self.scheduled else 0)
        if len(leaves) != want:
            raise ValueError(
                f"optimizer state has {len(leaves)} leaves; this chain "
                f"({'schedule' if self.scheduled else 'constant rate'}, {n} "
                f"params) has {want}")

        def put(a, p):
            a = np.asarray(a)
            if a.shape != tuple(p.shape):
                raise ValueError(f"optimizer leaf shape {a.shape} does not "
                                 f"match its param {tuple(p.shape)}")
            return torch.tensor(a, dtype=p.dtype, device=p.device)
        return AdamWState(
            count=int(leaves[0]),
            mu=[put(a, p) for a, p in zip(leaves[1:1 + n], like)],
            nu=[put(a, p) for a, p in zip(leaves[1 + n:1 + 2 * n], like)],
            sched_count=int(leaves[-1]) if self.scheduled else None)


def make_optimizer(lr: float, schedule: str = "const", steps: int = 100,
                   warmup_steps: int = 0) -> AdamW:
    """The train loop's chain: a constant rate, or warmup-cosine over the
    run (ramp from 0 to lr over warmup_steps, decay to 5% of lr by
    `steps`), as the JAX package's `train/loop.py` builds it."""
    if schedule == "cosine":
        warm = max(int(warmup_steps), 0)
        return AdamW(warmup_cosine_decay_schedule(
            0.0, lr, warm, max(int(steps), warm + 1), 0.05 * lr))
    if schedule != "const":
        raise ValueError(f"unknown lr schedule {schedule!r} "
                         "(expected 'const' or 'cosine')")
    return AdamW(float(lr))


__all__ = ["AdamW", "AdamWState", "global_norm", "make_optimizer",
           "warmup_cosine_decay_schedule"]
