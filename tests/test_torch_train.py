"""The port's training slice against the JAX package's, on the CPU.

yolov8p at 64 px, batch 2 (the size of tests/test_train.py): the same NumPy
inputs go through the JAX package's `train/` and the port's
`zero_latency_yolo_tpu_torch/train/`. Tolerances, each from the order of f32
sums (XLA's and PyTorch's reductions and convolutions differ there, the
formulas do not):

- losses: |port - jax| <= 1e-5 * max(|jax|, 1): a loss under 1 is a
  difference of terms of order 1 (the KL of two near-equal bin
  distributions cancels to ~1e-3), so its error is absolute;
- gradients: |port - jax| <= 1e-5 * max|jax| per leaf;
- after 3 train steps, params, EMA and the optimizer's moments:
  |port - jax| <= 1e-4 * max|jax| per leaf (Adam's update divides by
  sqrt(nu) + 1e-8, which magnifies a gradient's last bits where |g| is near
  1e-8; measured 1.5e-5 on this size);
- integers (counts, steps) and NumPy data: exact.

The JAX train steps are compiled once a module (`_jax_run`).
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

import torch_fixtures.cpu_threads  # noqa: E402,F401  (caps torch's CPU threads)
from zero_latency_yolo_tpu.models import get_spec as jget_spec  # noqa: E402
from zero_latency_yolo_tpu.models import init_params as jinit_params  # noqa: E402
from zero_latency_yolo_tpu.models.weights import load_params as jload_params  # noqa: E402
from zero_latency_yolo_tpu.models.yolov8 import forward_raw as jforward_raw  # noqa: E402
from zero_latency_yolo_tpu.train import checkpoint as jckpt  # noqa: E402
from zero_latency_yolo_tpu.train import data as jdata  # noqa: E402
from zero_latency_yolo_tpu.train import eval as jeval  # noqa: E402
from zero_latency_yolo_tpu.train import loop as jloop  # noqa: E402
from zero_latency_yolo_tpu.train import loss as jloss  # noqa: E402
from zero_latency_yolo_tpu.train import ood as jood  # noqa: E402
from zero_latency_yolo_tpu.train import step as jstep  # noqa: E402

from zero_latency_yolo_tpu_torch.models import weights as pw  # noqa: E402
from zero_latency_yolo_tpu_torch.models.yolov8 import (  # noqa: E402
    forward_train_raw, get_spec, init_params)
from zero_latency_yolo_tpu_torch.train import checkpoint as pckpt  # noqa: E402
from zero_latency_yolo_tpu_torch.train import data as pdata  # noqa: E402
from zero_latency_yolo_tpu_torch.train import eval as peval  # noqa: E402
from zero_latency_yolo_tpu_torch.train import loop as ploop  # noqa: E402
from zero_latency_yolo_tpu_torch.train import loss as ploss  # noqa: E402
from zero_latency_yolo_tpu_torch.train import ood as pood  # noqa: E402
from zero_latency_yolo_tpu_torch.train import optim as poptim  # noqa: E402
from zero_latency_yolo_tpu_torch.train import step as pstep  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
SIZE, BATCH, STEPS = 64, 2, 3
LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-5
STATE_RTOL = 1e-4

SPEC = get_spec("yolov8p", 4)
JSPEC = jget_spec("yolov8p", 4)


def _tree(seed=0, folded=False):
    return init_params(seed, SPEC, folded=folded)


def _close_leaves(jax_leaves, port_leaves, rtol, what):
    assert len(jax_leaves) == len(port_leaves), what
    for i, (a, b) in enumerate(zip(jax_leaves, port_leaves)):
        a = np.asarray(a, np.float64)
        b = (b.detach().cpu().numpy() if isinstance(b, torch.Tensor)
             else np.asarray(b)).astype(np.float64)
        assert a.shape == b.shape, (what, i, a.shape, b.shape)
        err = float(np.max(np.abs(a - b))) if a.size else 0.0
        assert err <= rtol * float(np.max(np.abs(a))) + 1e-30, (what, i, err)


def _close_loss(got, want, what):
    assert abs(got - want) <= LOSS_RTOL * max(abs(want), 1.0), (
        what, got, want)


def _batches(n, seed=0):
    it = jloop.synthetic_batches(BATCH, SIZE, seed=seed)
    return [next(it) for _ in range(n)]


# ---------------------------------------------------------------------------
# Parameters: init, training form, files
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 7])
def test_init_params_unfolded_bit_equal_to_jax(seed):
    """The port's init_params(seed, folded=False) is the JAX package's
    init_params(PRNGKey(seed), folded=False): the JAX init reads the key's
    last word as the NumPy seed."""
    ours = pw.flatten(init_params(seed, SPEC, folded=False))
    theirs = pw.flatten(jinit_params(jax.random.PRNGKey(seed), JSPEC,
                                     folded=False, device=False))
    assert sorted(ours) == sorted(theirs)
    for k in ours:
        assert ours[k].dtype == theirs[k].dtype
        np.testing.assert_array_equal(ours[k], theirs[k], err_msg=k)


@pytest.mark.parametrize("folded", [False, True])
def test_train_params_round_trip(folded, tmp_path):
    """train_params_from_jax keeps the JAX tree's keys and HWIO layout as
    f32 leaf tensors; train_params_to_numpy gives the tree back bit for bit;
    save_params writes a file the JAX package's load_params reads, and the
    other way round; tree_leaves lists the leaves as jax.tree.leaves does."""
    tree = _tree(3, folded)
    tp = pw.train_params_from_jax(tree)
    back = pw.flatten(pw.train_params_to_numpy(tp))
    src = pw.flatten(tree)
    assert sorted(back) == sorted(src)
    for k in src:
        assert back[k].dtype == np.float32
        np.testing.assert_array_equal(back[k], src[k], err_msg=k)
    assert tp["m0"]["w"].shape == tree["m0"]["w"].shape  # HWIO kept
    leaves = pw.tree_leaves(tp)
    jleaves = jax.tree.leaves(tree)
    assert len(leaves) == len(jleaves)
    for a, b in zip(jleaves, leaves):
        np.testing.assert_array_equal(a, b.numpy())
    pw.save_params(tp, str(tmp_path / "port.npz"))
    theirs = pw.flatten(jload_params(str(tmp_path / "port.npz")))
    assert sorted(theirs) == sorted(src)
    for k in src:
        np.testing.assert_array_equal(theirs[k], src[k], err_msg=k)
    from zero_latency_yolo_tpu.models.weights import save_params as jsave
    jsave(tree, str(tmp_path / "jax.npz"))
    ours = pw.flatten(pw.load_params(str(tmp_path / "jax.npz")))
    for k in src:
        np.testing.assert_array_equal(ours[k], src[k], err_msg=k)


@pytest.mark.parametrize("stem,c2f,folded", [
    ("conv", "slice", False), ("conv", "split", False),
    ("conv", "split", True), ("s2d", "slice", True)])
def test_training_forward_matches_jax(stem, c2f, folded):
    """forward_train_raw against the JAX package's forward_raw(...,
    accum_f32=False) in f32, on unfolded (BN tail) and folded trees, with
    the s2d stem and the split C2f (which falls back to the slice form on
    unfolded blocks, as in JAX); relative 1e-5 of each level's max."""
    tree = _tree(2, folded)
    images = _batches(1)[0][0]
    x = images
    if stem == "s2d":
        b, h, w, _ = images.shape
        x = images.reshape(b, h // 2, 2, w // 2, 2, 3).transpose(
            0, 1, 3, 2, 4, 5).reshape(b, h // 2, w // 2, 12)
    with jax.disable_jit():
        want = jforward_raw(jax.tree.map(jnp.asarray, tree), JSPEC,
                            jnp.asarray(x), dtype=jnp.float32,
                            accum_f32=False, stem=stem, c2f=c2f)
    got = forward_train_raw(pw.train_params_from_jax(tree), SPEC,
                            torch.from_numpy(x), stem=stem, c2f=c2f)
    for a, b in zip(want, got):
        a = np.asarray(a)
        assert a.shape == tuple(b.shape)
        assert np.max(np.abs(a - b.detach().numpy())) <= 1e-5 * np.max(np.abs(a))


def test_training_forward_refuses_an_unfolded_s2d_stem():
    with pytest.raises(ValueError, match="BN-folded"):
        forward_train_raw(pw.train_params_from_jax(_tree()), SPEC,
                          torch.zeros(1, SIZE // 2, SIZE // 2, 12),
                          stem="s2d")


def test_bf16_training_forward_rounds_the_conv_as_jax():
    """bf16: each conv's output rounded to bf16, the f32 tail, one cast
    back, as the JAX package's accum_f32=False branch: the head maps agree
    within bf16's relative step (2**-7) of each level's max."""
    tree = _tree(2)
    x = _batches(1)[0][0]
    with jax.disable_jit():
        want = jforward_raw(jax.tree.map(jnp.asarray, tree), JSPEC,
                            jnp.asarray(x), dtype=jnp.bfloat16,
                            accum_f32=False)
    got = forward_train_raw(pw.train_params_from_jax(tree), SPEC,
                            torch.from_numpy(x), dtype=torch.bfloat16)
    for a, b in zip(want, got):
        a = np.asarray(a, np.float32)
        assert b.dtype == torch.float32
        err = np.abs(a - b.detach().numpy())
        assert np.median(err) <= 2.0 ** -7 * np.max(np.abs(a))
        assert np.mean(err) <= 2.0 ** -7 * np.max(np.abs(a))


# ---------------------------------------------------------------------------
# Losses
# ---------------------------------------------------------------------------

def _loss_inputs(seed=0):
    """Seeded head maps of the yolov8p 64-px shapes, and targets: a
    synthetic image, an image without targets, a crowded one."""
    rng = np.random.default_rng(seed)
    outs = []
    for s in SPEC.strides:
        o = rng.standard_normal((3, SIZE // s, SIZE // s, SPEC.no)
                                ).astype(np.float32)
        o[..., 4 * SPEC.reg_max:] -= 2.0
        outs.append(o)
    t_syn = next(jloop.synthetic_batches(1, SIZE, max_boxes=12, seed=4))[1]
    t_crowd = next(jloop.crowded_batches(1, SIZE, max_boxes=12, seed=5))[1]
    t_none = np.full((1, 12, 5), -1.0, np.float32)
    return outs, np.concatenate([t_syn, t_none, t_crowd])


@pytest.mark.parametrize("assigner", ["center", "tal"])
def test_detection_loss_and_gradient_match_jax(assigner):
    outs, targets = _loss_inputs()

    def jfn(o):
        return jloss.detection_loss(JSPEC, o, jnp.asarray(targets),
                                    (SIZE, SIZE), assigner=assigner)
    (jl, jm), jg = jax.jit(jax.value_and_grad(jfn, has_aux=True))(
        [jnp.asarray(o) for o in outs])
    t_outs = [torch.tensor(o, requires_grad=True) for o in outs]
    pl, pm = ploss.detection_loss(SPEC, t_outs, torch.from_numpy(targets),
                                  (SIZE, SIZE), assigner=assigner)
    pg = torch.autograd.grad(pl, t_outs)
    assert float(jm["num_pos"]) == float(pm["num_pos"].detach()) > 0
    for k in ("box", "cls", "dfl"):
        np.testing.assert_allclose(float(pm[k].detach()), float(jm[k]), rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(pl.detach()), float(jl), rtol=LOSS_RTOL)
    _close_leaves(jg, pg, GRAD_RTOL, f"{assigner} gradient")


@pytest.mark.parametrize("assigner", ["center", "tal"])
def test_loss_of_an_image_without_targets(assigner):
    """No targets: no positive anchor, box and dfl 0, the cls term pushes
    every logit down; equal to JAX."""
    outs, targets = _loss_inputs(1)
    outs = [o[1:2] for o in outs]
    targets = targets[1:2]
    jl, jm = jloss.detection_loss(JSPEC, [jnp.asarray(o) for o in outs],
                                  jnp.asarray(targets), (SIZE, SIZE),
                                  assigner=assigner)
    pl, pm = ploss.detection_loss(SPEC, [torch.from_numpy(o) for o in outs],
                                  torch.from_numpy(targets), (SIZE, SIZE),
                                  assigner=assigner)
    assert float(pm["box"]) == float(pm["dfl"]) == 0.0
    assert float(pm["num_pos"].detach()) == float(jm["num_pos"]) == 1.0  # clamped
    np.testing.assert_allclose(float(pl.detach()), float(jl), rtol=LOSS_RTOL)


def test_unknown_assigner_refused():
    outs, targets = _loss_inputs()
    with pytest.raises(ValueError, match="unknown assigner"):
        ploss.detection_loss(SPEC, [torch.from_numpy(o) for o in outs],
                             torch.from_numpy(targets), (SIZE, SIZE),
                             assigner="atss")


def test_distill_loss_and_gradient_match_jax():
    s_outs, _ = _loss_inputs(2)
    t_outs, _ = _loss_inputs(3)

    def jfn(s):
        return jloss.distill_loss(JSPEC, [jnp.asarray(o) for o in t_outs], s,
                                  temp=2.0, w_box=0.5)
    (jl, jm), jg = jax.value_and_grad(jfn, has_aux=True)(
        [jnp.asarray(o) for o in s_outs])
    ts = [torch.tensor(o, requires_grad=True) for o in s_outs]
    pl, pm = ploss.distill_loss(SPEC, [torch.from_numpy(o) for o in t_outs],
                                ts, temp=2.0, w_box=0.5)
    pg = torch.autograd.grad(pl, ts)
    for k in ("kd_cls", "kd_box"):
        np.testing.assert_allclose(float(pm[k].detach()), float(jm[k]), rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(pl.detach()), float(jl), rtol=LOSS_RTOL)
    _close_leaves(jg, pg, GRAD_RTOL, "distill gradient")
    with pytest.raises(ValueError, match="head shapes disagree"):
        ploss.distill_loss(SPEC, [torch.from_numpy(o) for o in t_outs[:2]],
                           ts[:2] + [ts[2][:, :1]])


# ---------------------------------------------------------------------------
# The optimizer against optax
# ---------------------------------------------------------------------------

def _jax_tx(lr):
    return optax.chain(optax.clip_by_global_norm(10.0),
                       optax.adamw(lr, weight_decay=1e-4))


@pytest.mark.parametrize("schedule", ["const", "cosine"])
def test_optimizer_state_leaf_for_leaf_against_optax(schedule):
    """Six updates of a small tree, two of them with a gradient over the
    clip norm: the params and every leaf of the state (count, mu, nu, the
    schedule's count) against optax's chain, in jax.tree.flatten's order."""
    rng = np.random.default_rng(11)
    tree = {"m1": {"w": rng.standard_normal((3, 3, 4, 8)).astype(np.float32),
                   "bn": {"var": np.abs(rng.standard_normal(8)
                                        ).astype(np.float32)}},
            "m0": [rng.standard_normal((5,)).astype(np.float32)]}
    grads = [jax.tree.map(lambda a, k=k: (rng.standard_normal(a.shape)
                                          * (40.0 if k in (2, 4) else 0.3)
                                          ).astype(np.float32), tree)
             for k in range(6)]
    if schedule == "cosine":
        jlr = optax.warmup_cosine_decay_schedule(0.0, 1e-2, 2, 6, 5e-4)
    else:
        jlr = 1e-2
    tx = _jax_tx(jlr)
    jp = jax.tree.map(jnp.asarray, tree)
    js = tx.init(jp)
    opt = poptim.make_optimizer(1e-2, schedule, steps=6, warmup_steps=2)
    pp = pw.train_params_from_jax(tree)
    leaves = pw.tree_leaves(pp)
    ps = opt.init(leaves)
    for g in grads:
        upd, js = tx.update(jax.tree.map(jnp.asarray, g), js, jp)
        jp = optax.apply_updates(jp, upd)
        opt.update([torch.from_numpy(a) for a in jax.tree.leaves(g)], ps,
                   leaves)
    _close_leaves(jax.tree.leaves(jp), leaves, 1e-6, "params")
    jl = jax.tree.leaves(js)
    ol = opt.state_leaves(ps)
    assert len(jl) == len(ol) == 1 + 2 * len(leaves) + (schedule == "cosine")
    assert int(jl[0]) == int(ol[0]) == 6 and ol[0].dtype == np.int32
    if schedule == "cosine":
        assert int(jl[-1]) == int(ol[-1]) == 6
    _close_leaves(jl[1:1 + 2 * len(leaves)], ol[1:1 + 2 * len(leaves)], 1e-6,
                  "moments")
    back = opt.state_from_leaves(ol, leaves)
    assert back.count == 6 and back.sched_count == ps.sched_count
    with pytest.raises(ValueError, match="leaves"):
        opt.state_from_leaves(ol[:-1], leaves)


def test_cosine_schedule_values_equal_optax():
    for warm, steps in ((0, 7), (3, 10), (4, 4)):
        js = optax.warmup_cosine_decay_schedule(
            0.0, 2e-3, warm, max(steps, warm + 1), 1e-4)
        ps = poptim.warmup_cosine_decay_schedule(
            0.0, 2e-3, warm, max(steps, warm + 1), 1e-4)
        for c in range(steps + 3):
            np.testing.assert_allclose(ps(c), float(js(c)), rtol=1e-6,
                                       atol=1e-12)
    with pytest.raises(ValueError, match="schedule"):
        poptim.make_optimizer(1e-3, "step")


# ---------------------------------------------------------------------------
# Train steps against make_train_step
# ---------------------------------------------------------------------------

RUNS = {
    # name: (schedule, ema, assigner, remat, distill)
    "const_ema": ("const", True, "center", False, False),
    "cosine_tal_remat": ("cosine", False, "tal", True, False),
    "distill": ("const", False, "center", False, True),
}
_JAX_RUNS = {}


def _teacher_tree():
    return init_params(5, SPEC, folded=True)


def _jax_run(name):
    """The JAX package's 3 steps of run `name` (compiled once a module):
    per-step metrics, the state after each step, the jitted step."""
    if name in _JAX_RUNS:
        return _JAX_RUNS[name]
    schedule, ema, assigner, remat, distill = RUNS[name]
    lr = (optax.warmup_cosine_decay_schedule(0.0, 1e-3, 1, STEPS, 5e-5)
          if schedule == "cosine" else 1e-3)
    tx = _jax_tx(lr)
    state = jstep.init_train_state(jax.tree.map(jnp.asarray, _tree()), tx,
                                   ema=ema)
    fn = jstep.make_train_step(JSPEC, tx, (SIZE, SIZE), dtype=jnp.float32,
                               remat=remat, assigner=assigner,
                               teacher_spec=JSPEC if distill else None,
                               distill_box_weight=0.5)
    teacher = jax.tree.map(jnp.asarray, _teacher_tree()) if distill else None
    metrics, states = [], []
    for images, targets in _batches(STEPS):
        args = (state, jnp.asarray(images), jnp.asarray(targets))
        state, m = fn(*args, teacher) if distill else fn(*args)
        metrics.append({k: float(v) for k, v in m.items()})
        states.append(jax.tree.map(np.asarray, state))
    _JAX_RUNS[name] = (metrics, states, fn, tx)
    return _JAX_RUNS[name]


def _port_run(name, steps=STEPS):
    schedule, ema, assigner, remat, distill = RUNS[name]
    opt = poptim.make_optimizer(1e-3, schedule, steps=STEPS, warmup_steps=1)
    state = pstep.init_train_state(pw.train_params_from_jax(_tree()), opt,
                                   ema=ema)
    fn = pstep.make_train_step(SPEC, opt, (SIZE, SIZE), dtype=torch.float32,
                               remat=remat, assigner=assigner,
                               teacher_spec=SPEC if distill else None,
                               distill_box_weight=0.5)
    teacher = pw.train_params_from_jax(_teacher_tree()) if distill else None
    metrics = []
    for images, targets in _batches(steps):
        state, m = (fn(state, images, targets, teacher) if distill
                    else fn(state, images, targets))
        metrics.append({k: float(v) for k, v in m.items()})
    return metrics, state, opt


@pytest.mark.parametrize("name", list(RUNS))
def test_three_train_steps_match_make_train_step(name):
    """Losses at every step, then params, EMA and the optimizer's state
    after 3 steps, against the JAX package's jitted step."""
    jm, jstates, _, _ = _jax_run(name)
    pm, state, opt = _port_run(name)
    for a, b in zip(jm, pm):
        assert sorted(a) == sorted(b)
        for k in a:
            _close_loss(b[k], a[k], k)
    js = jstates[-1]
    assert int(js.step) == state.step == STEPS
    _close_leaves(jax.tree.leaves(js.params), pw.tree_leaves(state.params),
                  STATE_RTOL, "params")
    if js.ema_params is None:
        assert state.ema_params is None
    else:
        _close_leaves(jax.tree.leaves(js.ema_params),
                      pw.tree_leaves(state.ema_params), STATE_RTOL, "ema")
    jl = jax.tree.leaves(js.opt_state)
    ol = opt.state_leaves(state.opt_state)
    assert len(jl) == len(ol)
    ints = [i for i, a in enumerate(jl) if np.asarray(a).dtype == np.int32]
    assert ints == [i for i, a in enumerate(ol) if a.dtype == np.int32]
    for i in ints:
        assert int(jl[i]) == int(ol[i]) == STEPS
    _close_leaves([a for i, a in enumerate(jl) if i not in ints],
                  [a for i, a in enumerate(ol) if i not in ints],
                  STATE_RTOL, "optimizer state")


def test_every_leaf_gets_a_gradient_bn_statistics_included():
    """Every leaf of the training form requires grad and receives a
    nonzero gradient, BN mean and var included, as JAX trains every leaf."""
    opt = poptim.make_optimizer(1e-3)
    state = pstep.init_train_state(pw.train_params_from_jax(_tree()), opt)
    before = [p.detach().clone() for p in pw.tree_leaves(state.params)]
    fn = pstep.make_train_step(SPEC, opt, (SIZE, SIZE), dtype=torch.float32)
    images, targets = _batches(1)[0]
    fn(state, images, targets)
    flat = pw.flatten(pw.train_params_to_numpy(state.params))
    keys = sorted(flat, key=lambda k: k)
    assert any(k.endswith("/bn/mean") for k in keys)
    assert any(k.endswith("/bn/var") for k in keys)
    for p, b in zip(pw.tree_leaves(state.params), before):
        assert p.requires_grad
        assert not torch.equal(p.detach(), b)


def test_ema_decay_ramps_as_jax():
    """d = ema_decay * (1 - exp(-(step + 1) / 2000)) in f32, as the JAX
    step computes it; 1 - exp(x) near 1 carries f32's absolute step at 1
    (2**-24), so two exp implementations agree within two of those."""
    for step in (0, 1, 10, 5000):
        t = jnp.asarray(step, jnp.int32).astype(jnp.float32) + 1.0
        want = jnp.asarray(0.9998, jnp.float32) * (1.0 - jnp.exp(-t / 2000.0))
        got = pstep.ema_decay_at(0.9998, step)
        assert got.dtype == torch.float32
        assert abs(float(got) - float(want)) <= 2.0 ** -23


def test_bf16_step_is_finite_and_descends():
    """bf16 steps on the CPU (the card's default dtype): every loss and
    leaf finite, and the loss of a repeated batch falls."""
    opt = poptim.make_optimizer(1e-3)
    state = pstep.init_train_state(pw.train_params_from_jax(_tree()), opt,
                                   ema=True)
    fn = pstep.make_train_step(SPEC, opt, (SIZE, SIZE))
    images, targets = _batches(1)[0]
    losses = [float(fn(state, images, targets)[1]["loss"]) for _ in range(4)]
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]
    assert all(torch.isfinite(p).all() for p in pw.tree_leaves(state.params))
    assert all(torch.isfinite(p).all()
               for p in pw.tree_leaves(state.ema_params))


def test_distill_step_needs_the_teacher():
    opt = poptim.make_optimizer(1e-3)
    state = pstep.init_train_state(pw.train_params_from_jax(_tree()), opt)
    fn = pstep.make_train_step(SPEC, opt, (SIZE, SIZE), teacher_spec=SPEC)
    images, targets = _batches(1)[0]
    with pytest.raises(ValueError, match="teacher_params"):
        fn(state, images, targets)


@pytest.mark.parametrize("mesh", [(2, 1), (1, 2), (4, 2)])
def test_a_mesh_trains(mesh, monkeypatch, capsys):
    """make_train_step(mesh_data=, mesh_model=) and loop.train build the
    mesh and run one step on it (a virtual mesh: available_devices replaced
    by repeats of the CPU); the loop returns the joined state."""
    from zero_latency_yolo_tpu_torch.parallel import mesh as pmesh
    monkeypatch.setattr(pmesh, "available_devices",
                        lambda device="cuda": [torch.device("cpu")] * 8)
    opt = poptim.make_optimizer(1e-3)
    fn = pstep.make_train_step(SPEC, opt, (SIZE, SIZE), dtype=torch.float32,
                               mesh_data=mesh[0], mesh_model=mesh[1])
    assert fn.mesh.shape == {"data": mesh[0], "model": mesh[1]}
    state = fn.shard_state(pstep.init_train_state(
        pw.train_params_from_jax(_tree()), opt))
    assert len(state.states) == mesh[0] * mesh[1]
    images, targets = next(jloop.synthetic_batches(4, SIZE))
    state, m = fn(state, images, targets)
    assert state.step == 1 and np.isfinite(float(m["loss"]))
    out = ploop.train(steps=1, batch=4, mesh_data=mesh[0],
                      mesh_model=mesh[1], device="cpu")
    assert f"train mesh {mesh[0]}x{mesh[1]}" in capsys.readouterr().out
    assert isinstance(out, pstep.TrainState) and out.step == 1
    assert all(torch.isfinite(p).all() for p in pw.tree_leaves(out.params))


# ---------------------------------------------------------------------------
# Checkpoints, both ways
# ---------------------------------------------------------------------------

def test_jax_checkpoint_resumes_in_the_port(tmp_path):
    """The JAX package's npz checkpoint after 2 steps, restored by the
    port and stepped once: equal to the JAX run's third step."""
    jm, jstates, _, _ = _jax_run("const_ema")
    js2 = jstates[1]
    mgr = jckpt.CheckpointManager.__new__(jckpt.CheckpointManager)
    mgr.directory, mgr.max_to_keep, mgr._mgr = str(tmp_path), 3, None
    mgr._save_npz(js2, 2)
    opt = poptim.make_optimizer(1e-3)
    template = pstep.init_train_state(pw.train_params_from_jax(_tree()), opt,
                                      ema=True)
    state = pckpt.CheckpointManager(str(tmp_path)).restore(template, opt)
    assert state.step == 2
    _close_leaves(jax.tree.leaves(js2.params), pw.tree_leaves(state.params),
                  0.0, "restored params")
    _close_leaves(jax.tree.leaves(js2.opt_state)[1:],
                  opt.state_leaves(state.opt_state)[1:], 0.0, "restored opt")
    fn = pstep.make_train_step(SPEC, opt, (SIZE, SIZE), dtype=torch.float32)
    images, targets = _batches(3)[2]
    state, m = fn(state, images, targets)
    np.testing.assert_allclose(m["loss"].item(), jm[2]["loss"],
                               rtol=LOSS_RTOL)
    _close_leaves(jax.tree.leaves(jstates[2].params),
                  pw.tree_leaves(state.params), STATE_RTOL, "params")
    _close_leaves(jax.tree.leaves(jstates[2].ema_params),
                  pw.tree_leaves(state.ema_params), STATE_RTOL, "ema")


def test_port_checkpoint_resumes_in_jax(tmp_path):
    """The port's checkpoint after 2 steps, restored by the JAX package's
    npz restore and stepped once by its jitted step: equal to the port's
    own third step."""
    _, _, jfn, tx = _jax_run("const_ema")
    pm, state, opt = _port_run("const_ema", steps=2)
    pckpt.CheckpointManager(str(tmp_path)).save(state, opt)
    names = sorted(os.listdir(tmp_path / "ckpt_00000002"))
    assert names == ["ema.npz", "meta.json", "opt.npz", "params.npz"]
    assert json.loads((tmp_path / "ckpt_00000002" / "meta.json").read_text()
                      ) == {"step": 2}
    template = jstep.init_train_state(jax.tree.map(jnp.asarray, _tree()),
                                      tx, ema=True)
    mgr = jckpt.CheckpointManager.__new__(jckpt.CheckpointManager)
    mgr.directory, mgr.max_to_keep, mgr._mgr = str(tmp_path), 3, None
    js = mgr._restore_npz(template, 2)
    assert int(js.step) == 2
    images, targets = _batches(3)[2]
    js, jm = jfn(js, jnp.asarray(images), jnp.asarray(targets))
    fn = pstep.make_train_step(SPEC, opt, (SIZE, SIZE), dtype=torch.float32)
    state, m = fn(state, images, targets)
    np.testing.assert_allclose(m["loss"].item(), float(jm["loss"]),
                               rtol=LOSS_RTOL)
    _close_leaves(jax.tree.leaves(js.params), pw.tree_leaves(state.params),
                  STATE_RTOL, "params")
    _close_leaves(jax.tree.leaves(js.opt_state),
                  opt.state_leaves(state.opt_state), STATE_RTOL, "opt")


def test_checkpoint_retention_and_ema_rules(tmp_path):
    """max_to_keep newest checkpoints, no .tmp left; a run without EMA
    drops the file's EMA; a run with EMA from a file without seeds it from
    the restored params; no checkpoint restores None; a resumed step
    equals an uninterrupted one."""
    opt = poptim.make_optimizer(1e-3)
    fn = pstep.make_train_step(SPEC, opt, (SIZE, SIZE), dtype=torch.float32)
    mgr = pckpt.CheckpointManager(str(tmp_path / "a"), max_to_keep=2)
    state = pstep.init_train_state(pw.train_params_from_jax(_tree()), opt,
                                   ema=True)
    assert mgr.restore(state, opt) is None and mgr.latest_step() is None
    batches = _batches(3)
    for images, targets in batches[:2]:
        state, _ = fn(state, images, targets)
        mgr.save(state, opt)
    mgr.save(state, opt)  # the same step again: replaced
    state, _ = fn(state, *batches[2])
    mgr.save(state, opt)
    assert sorted(os.listdir(tmp_path / "a")) == ["ckpt_00000002",
                                                  "ckpt_00000003"]
    no_ema = pstep.init_train_state(pw.train_params_from_jax(_tree()), opt)
    got = mgr.restore(no_ema, opt, step=2)
    assert got.ema_params is None and got.step == 2
    ema_run = pstep.init_train_state(pw.train_params_from_jax(_tree()), opt,
                                     ema=True)
    mgr2 = pckpt.CheckpointManager(str(tmp_path / "b"))
    mgr2.save(got, opt)
    seeded = mgr2.restore(ema_run, opt)
    for p, e in zip(pw.tree_leaves(seeded.params),
                    pw.tree_leaves(seeded.ema_params)):
        assert torch.equal(p.detach(), e) and not e.requires_grad
    resumed = mgr.restore(ema_run, opt, step=2)
    resumed, _ = fn(resumed, *batches[2])
    for a, b in zip(pw.tree_leaves(resumed.params),
                    pw.tree_leaves(state.params)):
        assert torch.equal(a.detach(), b.detach())


# ---------------------------------------------------------------------------
# Eval
# ---------------------------------------------------------------------------

def test_evaluate_matches_jax_evaluate():
    """The deployed yolov8n weights at 160 px over 16 seeded synthetic
    images: the port folds and serves (plain kernel versions on the CPU),
    the JAX package evaluates the same tree; the f32 results equal within
    1e-6 (the detections decided identically)."""
    tree = pw.load_params(str(REPO / "artifacts" / "yolov8n_trained_416.npz"))
    spec = get_spec("yolov8n", 4)
    images, targets = next(jloop.synthetic_batches(16, 160, seed=21))
    want = jeval.evaluate(jax.tree.map(jnp.asarray, tree),
                          jget_spec("yolov8n", 4), images, targets, batch=8)
    got = peval.evaluate(tree, spec, images, targets, batch=8, device="cpu")
    assert sorted(got) == sorted(want)
    assert want["num_gt"] == got["num_gt"] > 0 and want["mAP"] > 0.1
    for k in want:
        assert abs(got[k] - want[k]) <= 1e-6, (k, got[k], want[k])
    tp = pw.train_params_from_jax(tree)
    again = peval.evaluate(tp, spec, images, targets, batch=8, device="cpu",
                           plain=True)
    assert again == got


def test_eval_host_functions_equal_jax():
    rng = np.random.default_rng(3)
    scored = [(float(s), bool(h)) for s, h in zip(rng.random(40),
                                                   rng.random(40) > 0.4)]
    assert peval.average_precision(scored, 25) == jeval.average_precision(
        scored, 25)
    assert peval.average_precision([], 0) == 0.0
    gt = rng.uniform(0.2, 0.8, (6, 4)).astype(np.float32)
    pred = (gt[rng.integers(0, 6, 12)] + rng.normal(0, 0.03, (12, 4))
            ).astype(np.float32)
    scores = rng.random(12).astype(np.float32)
    for thr in (0.5, 0.75):
        assert peval.match_detections(pred, scores, gt, thr) == \
            jeval.match_detections(pred, scores, gt, thr)
    assert peval.COCO_IOU_LADDER == jeval.COCO_IOU_LADDER


# ---------------------------------------------------------------------------
# Data: the batch generators, ood, the YOLO directory layout
# ---------------------------------------------------------------------------

def _equal_streams(a, b, n=3):
    for _ in range(n):
        (ia, ta), (ib, tb) = next(a), next(b)
        assert ia.dtype == ib.dtype and ta.dtype == tb.dtype
        np.testing.assert_array_equal(ia, ib)
        np.testing.assert_array_equal(ta, tb)


@pytest.mark.parametrize("kind", ["synthetic", "crowded", "mosaic",
                                  "photometric", "clutter"])
def test_batch_generators_bit_equal_to_jax(kind):
    def make(mod):
        if kind == "synthetic":
            return mod.synthetic_batches(3, 64, seed=9)
        if kind == "crowded":
            return mod.crowded_batches(3, 64, seed=9)
        src = mod.synthetic_batches(3, 64, seed=9)
        if kind == "mosaic":
            return mod.mosaic_batches(src, prob=0.7, seed=2)
        if kind == "photometric":
            return mod.photometric_batches(src, strength=1.0, seed=2)
        return mod.clutter_batches(mod.mosaic_batches(src, seed=2),
                                   strength=1.5)
    _equal_streams(make(jloop), make(ploop))


def test_npz_batches_bit_equal_to_jax(tmp_path):
    rng = np.random.default_rng(0)
    for i in range(2):
        np.savez(tmp_path / f"shard{i}.npz",
                 images=rng.integers(0, 256, (5, 32, 32, 3), np.uint8),
                 targets=rng.random((5, 4, 5)).astype(np.float32))
    pattern = str(tmp_path / "shard*.npz")
    _equal_streams(jloop.npz_batches(pattern, 2), ploop.npz_batches(pattern, 2),
                   n=6)
    with pytest.raises(FileNotFoundError):
        next(ploop.npz_batches(str(tmp_path / "none*.npz"), 2))
    with pytest.raises(ValueError, match="fewer than batch"):
        next(ploop.npz_batches(pattern, 9))


@pytest.mark.parametrize("level", [1, 2, 3])
def test_ood_batches_bit_equal_to_jax(level):
    if level == 3 and not jood.jpeg_available():
        pytest.skip("cv2 missing: level 3 needs the JPEG round trip")
    assert pood.jpeg_available() == jood.jpeg_available()
    _equal_streams(jood.ood_batches(2, 64, seed=777, level=level),
                   pood.ood_batches(2, 64, seed=777, level=level), n=2)
    with pytest.raises(ValueError):
        next(pood.ood_batches(2, 64, level=4))


def _write_yolo_dir(root: Path, flat: bool):
    cv2 = pytest.importorskip("cv2")
    rng = np.random.default_rng(5)
    img_dir = root if flat else root / "images"
    lbl_dir = root if flat else root / "labels"
    img_dir.mkdir(parents=True, exist_ok=True)
    lbl_dir.mkdir(parents=True, exist_ok=True)
    for i, (h, w) in enumerate(((48, 80), (90, 60), (64, 64))):
        img = rng.integers(0, 256, (h, w, 3), np.uint8)
        cv2.imwrite(str(img_dir / f"im{i}.png"), img)
        if i < 2:  # the last image is a negative (no label file)
            (lbl_dir / f"im{i}.txt").write_text(
                f"{i} 0.5 0.5 0.25 0.5\n\n3 0.2 0.3 0.1 0.1\n")
    (img_dir / "notes.txt").write_text("not an image")


@pytest.mark.parametrize("flat", [False, True])
def test_yolo_dir_loading_equals_jax(flat, tmp_path):
    root = tmp_path / "ds"
    _write_yolo_dir(root, flat)
    pairs = pdata.find_pairs(str(root))
    assert pairs == jdata.find_pairs(str(root))
    assert [p[1] is None for p in pairs] == [False, False, True]
    for img, lbl in pairs:
        np.testing.assert_array_equal(pdata.read_labels(lbl, 4),
                                      jdata.read_labels(lbl, 4))
        a = pdata.load_sample(img, lbl, 64, 6, 4)
        b = jdata.load_sample(img, lbl, 64, 6, 4)
        np.testing.assert_array_equal(a[0], b[0])
        np.testing.assert_array_equal(a[1], b[1])
    a = pdata.load_yolo_dir(str(root), 64, 6, 4)
    b = jdata.load_yolo_dir(str(root), 64, 6, 4)
    np.testing.assert_array_equal(a[0], b[0])
    np.testing.assert_array_equal(a[1], b[1])
    _equal_streams(jdata.yolo_dir_batches(str(root), 2, 64, 6, 4, seed=1),
                   pdata.yolo_dir_batches(str(root), 2, 64, 6, 4, seed=1), 4)
    img = np.random.default_rng(1).integers(0, 256, (30, 70, 3), np.uint8)
    for x, y in zip(pdata.letterbox_image(img, 64),
                    jdata.letterbox_image(img, 64)):
        np.testing.assert_array_equal(x, y)


def test_read_labels_refuses_what_jax_refuses(tmp_path):
    cases = {"short": "0 0.5 0.5 0.2\n", "frac": "1.5 0.5 0.5 0.2 0.2\n",
             "range": "7 0.5 0.5 0.2 0.2\n", "nan": "0 nan 0.5 0.2 0.2\n",
             "big": "0 1.5 0.5 0.2 0.2\n"}
    for name, text in cases.items():
        p = tmp_path / f"{name}.txt"
        p.write_text(text)
        with pytest.raises(ValueError):
            jdata.read_labels(str(p), 4)
        with pytest.raises(ValueError):
            pdata.read_labels(str(p), 4)
    assert pdata.read_labels(None).shape == (0, 5)
    with pytest.raises(FileNotFoundError):
        pdata.find_pairs(str(tmp_path))


def test_coco_to_yolo_equals_jax(tmp_path):
    cv2 = pytest.importorskip("cv2")
    src = tmp_path / "coco"
    (src / "a").mkdir(parents=True)
    for name in ("a/one.jpg", "two.jpg"):
        cv2.imwrite(str(src / name), np.zeros((40, 50, 3), np.uint8))
    ann = {"categories": [{"id": 9, "name": "head"}, {"id": 3, "name": "ct"}],
           "images": [{"id": 1, "file_name": "a/one.jpg", "width": 50,
                       "height": 40},
                      {"id": 2, "file_name": "two.jpg", "width": 50,
                       "height": 40}],
           "annotations": [
               {"image_id": 1, "category_id": 9, "bbox": [5, 5, 20, 10]},
               {"image_id": 1, "category_id": 3, "bbox": [-5, 30, 20, 20]},
               {"image_id": 2, "category_id": 3, "bbox": [0, 0, 0, 5]},
               {"image_id": 2, "category_id": 9, "bbox": [1, 1, 5, 5],
                "iscrowd": 1}]}
    ann_file = tmp_path / "ann.json"
    ann_file.write_text(json.dumps(ann))
    got = pdata.coco_to_yolo(str(ann_file), str(src), str(tmp_path / "p"))
    want = jdata.coco_to_yolo(str(ann_file), str(src), str(tmp_path / "j"))
    assert got == want == (2, {3: 0, 9: 1})
    for rel in ("classes.txt", "labels/a_one.txt", "labels/two.txt"):
        assert (tmp_path / "p" / rel).read_text() == \
            (tmp_path / "j" / rel).read_text(), rel
    assert sorted(os.listdir(tmp_path / "p" / "images")) == \
        sorted(os.listdir(tmp_path / "j" / "images"))


# ---------------------------------------------------------------------------
# The entry point
# ---------------------------------------------------------------------------

def test_train_loop_cli_on_the_cpu(tmp_path):
    """python -m zero_latency_yolo_tpu_torch.train.loop --device cpu: two
    steps, a checkpoint in the JAX package's layout that its npz restore
    reads; without --device cpu on a machine without a card it refuses."""
    env = dict(os.environ, PYTHONPATH=str(REPO))
    ckpt = tmp_path / "ck"
    cmd = [sys.executable, "-m", "zero_latency_yolo_tpu_torch.train.loop",
           "--steps", "2", "--batch", "2", "--size", "64", "--ema",
           "--ckpt-dir", str(ckpt)]
    r = subprocess.run(cmd + ["--device", "cpu"], capture_output=True,
                       text=True, env=env, timeout=300, cwd=str(tmp_path))
    assert r.returncode == 0, r.stderr[-2000:]
    lines = [ln for ln in r.stdout.splitlines() if ln.startswith("step")]
    assert len(lines) == 1 and lines[0].split()[1] == "2" and "loss" in lines[0]
    assert sorted(os.listdir(ckpt)) == ["ckpt_00000002"]
    tx = _jax_tx(1e-3)
    template = jstep.init_train_state(jax.tree.map(jnp.asarray, _tree()), tx,
                                      ema=True)
    mgr = jckpt.CheckpointManager.__new__(jckpt.CheckpointManager)
    mgr.directory, mgr.max_to_keep, mgr._mgr = str(ckpt), 3, None
    js = mgr._restore_npz(template, 2)
    assert int(js.step) == 2 and js.ema_params is not None
    if not torch.cuda.is_available():
        r = subprocess.run(cmd, capture_output=True, text=True, env=env,
                           timeout=300, cwd=str(tmp_path))
        assert r.returncode != 0 and "no CUDA device" in r.stderr
