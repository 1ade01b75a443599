"""The port's trainer on a (data, model) mesh against the JAX package's
meshed train step and against the port's own single-device step, on the CPU.

yolov8p at 64 px, batch 8. The JAX reference runs `make_train_step(mesh=)`
on the 8 host devices that tests/conftest.py forces, one mesh a case and one
compile a case, once a module (the JAX meshed step computes one function
whatever the mesh, so its run is the reference of every port mesh; each
compile takes 15-25 s here, 4x2 the longest, so the file runs three); the
port runs on virtual 4x2, 2x1 and 1x2 meshes (`parallel.mesh` meshes whose
devices repeat the CPU). Cases: the const chain with the EMA (JAX on 4x2);
the same with a clipped first step (the images scaled by 1.5, which makes
the first gradient's norm about 200, above the clip norm of 10: this pins
the global norm; the same compiled JAX step); distillation (JAX
`tests/test_train.py:345`; JAX on 2x1); the TAL assigner on the cosine
schedule (JAX on 2x1). Tolerances are tests/test_torch_train.py's:

- losses: |port - jax| <= 1e-5 * max(|jax|, 1);
- step-1 gradients (after clipping, read from the first moment after step
  1, mu = (1 - b1) * g): |port - jax| <= 1e-5 * max|jax| per leaf;
- after 3 steps, params, EMA and the optimizer's moments:
  |port - jax| <= 1e-4 * max|jax| per leaf.

The copies of the meshed state are held bit-equal: every replicated leaf
across every device, every sharded slice across the data rows.
"""

import logging
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_fixtures.cpu_threads  # noqa: E402,F401  (caps torch's CPU threads)
import chip_smoke  # noqa: E402
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from zero_latency_yolo_tpu.models import get_spec as jget_spec  # noqa: E402
from zero_latency_yolo_tpu.models.weights import load_params as jload_params  # noqa: E402
from zero_latency_yolo_tpu.parallel import mesh as jmesh  # noqa: E402
from zero_latency_yolo_tpu.train import loop as jloop  # noqa: E402
from zero_latency_yolo_tpu.train import step as jstep  # noqa: E402

from zero_latency_yolo_tpu_torch.models import weights as pw  # noqa: E402
from zero_latency_yolo_tpu_torch.models.yolov8 import get_spec, init_params  # noqa: E402
from zero_latency_yolo_tpu_torch.parallel import mesh as pmesh  # noqa: E402
from zero_latency_yolo_tpu_torch.train import checkpoint as pckpt  # noqa: E402
from zero_latency_yolo_tpu_torch.train import loop as ploop  # noqa: E402
from zero_latency_yolo_tpu_torch.train import optim as poptim  # noqa: E402
from zero_latency_yolo_tpu_torch.train import step as pstep  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
SIZE, BATCH, STEPS = 64, 8, 3
LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-5
STATE_RTOL = 1e-4
MESHES = [(4, 2), (2, 1), (1, 2)]
CPU = torch.device("cpu")
SPEC = get_spec("yolov8p", 4)
JSPEC = jget_spec("yolov8p", 4)
CASES = {
    # name: (schedule, ema, assigner, distill, image scale, JAX mesh)
    "ema": ("const", True, "center", False, 1.0, (4, 2)),
    "clipped": ("const", True, "center", False, 1.5, (4, 2)),
    "distill": ("const", False, "center", True, 1.0, (2, 1)),
    "tal": ("cosine", False, "tal", False, 1.0, (2, 1)),
}

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs 8 virtual devices")


def _tree():
    return init_params(0, SPEC, folded=False)


def _teacher():
    return init_params(5, SPEC, folded=True)


def _batches(case):
    scale = CASES[case][4]
    it = jloop.synthetic_batches(BATCH, SIZE, seed=0)
    return [(im * np.float32(scale), t) for im, t in
            (next(it) for _ in range(STEPS))]


def _vmesh(shape):
    return pmesh.make_mesh(*shape, [CPU] * (shape[0] * shape[1]))


def _close_leaves(want, got, rtol, what):
    assert len(want) == len(got), what
    for i, (a, b) in enumerate(zip(want, got)):
        a = np.asarray(a, np.float64)
        b = (b.detach().cpu().numpy() if isinstance(b, torch.Tensor)
             else np.asarray(b)).astype(np.float64)
        assert a.shape == b.shape, (what, i, a.shape, b.shape)
        err = float(np.max(np.abs(a - b))) if a.size else 0.0
        assert err <= rtol * float(np.max(np.abs(a))) + 1e-30, (what, i, err)


def _close_loss(got, want, what):
    assert abs(got - want) <= LOSS_RTOL * max(abs(want), 1.0), (
        what, got, want)


def _record(states, tx_leaves, state):
    """Append a step's numbers: the state's (params, EMA, optimizer
    leaves) as NumPy."""
    def arr(x):  # a copy: the port's step updates its tensors in place
        return np.array(x.detach() if isinstance(x, torch.Tensor) else x)
    params, ema, opt = state
    states.append({"params": [arr(x) for x in params],
                   "ema": None if ema is None else [arr(x) for x in ema],
                   "opt": [arr(x) for x in tx_leaves(opt)]})


_JAX = {}


def _jax_run(case):
    """The JAX package's meshed step on 4x2 over the case's batches:
    per-step metrics and the state after each step (compiled once a case;
    "clipped" reuses "ema"'s compiled step, its inputs have the same
    shapes)."""
    if case in _JAX:
        return _JAX[case]
    schedule, ema, assigner, distill, _, shape = CASES[case]
    key = ("ema" if case == "clipped" else case)
    if key not in _JAX.get("fns", {}):
        lr = (optax.warmup_cosine_decay_schedule(0.0, 1e-3, 1, STEPS, 5e-5)
              if schedule == "cosine" else 1e-3)
        tx = optax.chain(optax.clip_by_global_norm(10.0),
                         optax.adamw(lr, weight_decay=1e-4))
        mesh = jmesh.make_mesh(*shape,
                               devices=jax.devices()[:shape[0] * shape[1]])
        fn = jstep.make_train_step(JSPEC, tx, (SIZE, SIZE), dtype=jnp.float32,
                                   mesh=mesh, assigner=assigner,
                                   teacher_spec=JSPEC if distill else None)
        _JAX.setdefault("fns", {})[key] = (fn, tx)
    fn, tx = _JAX["fns"][key]
    state = fn.shard_state(jstep.init_train_state(
        jax.tree.map(jnp.asarray, _tree()), tx, ema=ema))
    teacher = fn.shard_teacher(_teacher()) if distill else None
    metrics, states = [], []
    for images, targets in _batches(case):
        args = (state, jnp.asarray(images), jnp.asarray(targets))
        state, m = fn(*args, teacher) if distill else fn(*args)
        # Back onto the input shardings, so the next step hits the cache.
        state = fn.shard_state(state)
        metrics.append({k: float(v) for k, v in m.items()})
        _record(states, jax.tree.leaves,
                (jax.tree.leaves(state.params),
                 None if state.ema_params is None
                 else jax.tree.leaves(state.ema_params), state.opt_state))
    _JAX[case] = (metrics, states)
    return _JAX[case]


def _port_run(case, mesh_shape=None, steps=STEPS):
    """The port's run of a case, on a virtual mesh or on one device:
    per-step metrics, the (joined) state's numbers after each step, and the
    last (meshed) state."""
    schedule, ema, assigner, distill = CASES[case][:4]
    opt = poptim.make_optimizer(1e-3, schedule, steps=STEPS, warmup_steps=1)
    mesh = None if mesh_shape is None else _vmesh(mesh_shape)
    fn = pstep.make_train_step(SPEC, opt, (SIZE, SIZE), dtype=torch.float32,
                               assigner=assigner, mesh=mesh,
                               teacher_spec=SPEC if distill else None)
    assert fn.mesh == mesh
    state = fn.shard_state(pstep.init_train_state(
        pw.train_params_from_jax(_tree()), opt, ema=ema))
    teacher = (fn.shard_teacher(pw.train_params_from_jax(_teacher()))
               if distill else None)
    metrics, states = [], []
    for images, targets in _batches(case)[:steps]:
        state, m = (fn(state, images, targets, teacher) if distill
                    else fn(state, images, targets))
        metrics.append({k: float(v) for k, v in m.items()})
        whole = state if mesh is None else pmesh.join_state(state)
        _record(states, opt.state_leaves,
                (pw.tree_leaves(whole.params),
                 None if whole.ema_params is None
                 else pw.tree_leaves(whole.ema_params), whole.opt_state))
    return metrics, states, state, opt


_RUNS = {}


def _cached_run(case, mesh_shape=None):
    """_port_run of all the steps, once a module."""
    if (case, mesh_shape) not in _RUNS:
        _RUNS[case, mesh_shape] = _port_run(case, mesh_shape)
    return _RUNS[case, mesh_shape]


def _compare(want, got, what):
    """Metrics at every step, the step-1 gradient, and the state after the
    last step, of two runs (each (metrics, states))."""
    wm, ws = want
    gm, gs = got
    for a, b in zip(wm, gm):
        assert sorted(a) == sorted(b), what
        for k in a:
            _close_loss(b[k], a[k], f"{what} {k}")
    n = len(ws[0]["params"])
    g1_want = [m / (1 - poptim.B1) for m in ws[0]["opt"][1:1 + n]]
    g1_got = [m / (1 - poptim.B1) for m in gs[0]["opt"][1:1 + n]]
    _close_leaves(g1_want, g1_got, GRAD_RTOL, f"{what} step-1 gradient")
    last_w, last_g = ws[-1], gs[-1]
    _close_leaves(last_w["params"], last_g["params"], STATE_RTOL,
                  f"{what} params")
    assert (last_w["ema"] is None) == (last_g["ema"] is None), what
    if last_w["ema"] is not None:
        _close_leaves(last_w["ema"], last_g["ema"], STATE_RTOL, f"{what} ema")
    ints = [i for i, a in enumerate(last_w["opt"]) if a.dtype == np.int32]
    assert ints == [i for i, a in enumerate(last_g["opt"])
                    if a.dtype == np.int32], what
    for i in ints:
        assert int(last_w["opt"][i]) == int(last_g["opt"][i]) == STEPS
    _close_leaves([a for i, a in enumerate(last_w["opt"]) if i not in ints],
                  [a for i, a in enumerate(last_g["opt"]) if i not in ints],
                  STATE_RTOL, f"{what} optimizer state")
    return g1_got


def _copies_equal(mstate):
    """Every copy of the meshed state bit-equal (`chip_smoke.copies_differ`:
    replicated leaves on every device, sharded slices across the data rows,
    params, EMA and moments, the counts)."""
    differ, compared = chip_smoke.copies_differ(torch, mstate)
    assert differ == 0 and compared > 0, (differ, compared)


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
@pytest.mark.parametrize("case", list(CASES))
def test_meshed_steps_match_jax_and_single_device(case, mesh):
    """Three meshed steps against the JAX package's meshed step and against
    the port's single-device step: losses at every step, the step-1
    gradient, params, EMA and optimizer state after; the meshed state's
    copies equal bit for bit. The clipped case's first gradient is clipped
    to the norm 10 (the others are below it)."""
    metrics, states, mstate, _ = _cached_run(case, mesh)
    assert mstate.step == STEPS and len(mstate.states) == mesh[0] * mesh[1]
    _copies_equal(mstate)
    g1 = _compare(_jax_run(case), (metrics, states), f"{case} vs jax")
    _compare(_cached_run(case)[:2], (metrics, states), f"{case} vs single")
    norm = float(np.sqrt(sum(float(np.sum(np.square(g, dtype=np.float64)))
                             for g in g1)))
    if case == "clipped":
        assert abs(norm - poptim.CLIP_NORM) <= 1e-4 * poptim.CLIP_NORM
    elif case == "ema":
        assert norm < poptim.CLIP_NORM


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_value_and_grad_joins_the_whole_gradient(mesh):
    """The meshed step's value_and_grad (no update): the loss and the
    gradient of every leaf of the whole tree, joined, as the single-device
    step's (unclipped; the images scaled by 1.5 give a norm near 200) within
    the gradient tolerance; the state is left as it was."""
    opt = poptim.make_optimizer(1e-3)
    images, targets = _batches("clipped")[0]
    out = []
    for m in (None, _vmesh(mesh)):
        fn = pstep.make_train_step(SPEC, opt, (SIZE, SIZE),
                                   dtype=torch.float32, mesh=m)
        state = fn.shard_state(pstep.init_train_state(
            pw.train_params_from_jax(_tree()), opt))
        loss, metrics, grads = fn.value_and_grad(state, images, targets)
        assert state.step == 0
        out.append((float(loss), grads))
    (want_l, want), (got_l, got) = out
    _close_loss(got_l, want_l, "loss")
    assert float(poptim.global_norm(want)) > 10 * poptim.CLIP_NORM
    _close_leaves([g.numpy() for g in want], got, GRAD_RTOL, "gradient")


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_placement_matches_jax_shard_state(mesh):
    """shard_state against the JAX step's shard_state on the training tree,
    spec for spec: the params (BN vectors replicated, the head tips whole),
    the moments and the EMA mirror them; each device holds its column's
    slice of a sharded leaf and a copy of every other leaf; join_state
    gives the state back bit for bit."""
    tx = optax.chain(optax.clip_by_global_norm(10.0),
                     optax.adamw(1e-3, weight_decay=1e-4))
    jm = jmesh.make_mesh(*mesh, devices=jax.devices()[:mesh[0] * mesh[1]])
    fn = jstep.make_train_step(JSPEC, tx, (SIZE, SIZE), dtype=jnp.float32,
                               mesh=jm)
    js = fn.shard_state(jstep.init_train_state(
        jax.tree.map(jnp.asarray, _tree()), tx, ema=True))

    def spec_of(a):
        return tuple(a.sharding.spec)

    want = [spec_of(a) for a in jax.tree.leaves(js.params)]
    jopt = jax.tree.leaves(js.opt_state)
    n = len(want)
    assert [spec_of(a) for a in jopt[1:1 + n]] == want
    assert [spec_of(a) for a in jopt[1 + n:1 + 2 * n]] == want
    assert [spec_of(a) for a in jax.tree.leaves(js.ema_params)] == want

    opt = poptim.make_optimizer(1e-3)
    state = pstep.init_train_state(pw.train_params_from_jax(_tree()), opt,
                                   ema=True)
    ms = pmesh.shard_state(state, _vmesh(mesh))
    specs = pw.tree_leaves(ms.specs)
    assert specs == want
    spec_by_key = dict(zip(_keys(state.params), specs))
    assert all(s == () for k, s in spec_by_key.items() if "/bn/" in k)
    tips = [k for k in spec_by_key
            if re.fullmatch(r"m22/cv[23]/\d/2/[wb]", k)]
    assert len(tips) == 12 and all(spec_by_key[k] == () for k in tips)
    if mesh[1] > 1:
        assert spec_by_key["m9/cv2/w"] == (None, None, None, "model")
    whole = pw.tree_leaves(state.params)
    for d, s in enumerate(ms.states):
        col = d % mesh[1]
        for part in (pw.tree_leaves(s.params), s.opt_state.mu,
                     s.opt_state.nu, pw.tree_leaves(s.ema_params)):
            for x, full, spec in zip(part, whole, specs):
                axis = pmesh.model_axis(spec)
                if axis is None:
                    assert x.shape == full.shape
                else:
                    k = full.shape[axis] // mesh[1]
                    assert x.shape == full.narrow(axis, col * k, k).shape
        for x, full, spec in zip(pw.tree_leaves(s.params), whole, specs):
            axis = pmesh.model_axis(spec)
            ref = full if axis is None else full.narrow(
                axis, col * (full.shape[axis] // mesh[1]),
                full.shape[axis] // mesh[1])
            assert x.requires_grad and torch.equal(x, ref.detach())
            if x.data_ptr() == full.data_ptr():
                raise AssertionError("a device shares the source's leaf")
    back = pmesh.join_state(ms)
    for a, b in zip(pw.tree_leaves(back.params), whole):
        assert torch.equal(a, b)
    for a, b in zip(pw.tree_leaves(back.ema_params),
                    pw.tree_leaves(state.ema_params)):
        assert torch.equal(a, b)


def _keys(tree, path=""):
    """The leaves' keys in tree_leaves order."""
    if isinstance(tree, dict):
        return [k for key in sorted(tree)
                for k in _keys(tree[key], f"{path}{key}/")]
    if isinstance(tree, list):
        return [k for i, v in enumerate(tree) for k in _keys(v, f"{path}{i}/")]
    return [path[:-1]]


def test_checkpoints_move_between_layouts(tmp_path):
    """A meshed (4x2) checkpoint after 2 steps is the npz layout of a
    single-device one (the same files, keys and shapes; JAX's load_params
    reads its params); it resumes single-device, and a single-device one
    resumes on a 2x1 mesh: each third step equals the uninterrupted run of
    the other layout within the state tolerance, and a meshed resume on the
    same mesh equals the uninterrupted meshed run bit for bit."""
    case = "ema"
    images, targets = _batches(case)[2]
    _, _, meshed2, opt_m = _port_run(case, (4, 2), steps=2)
    _, _, single2, opt_s = _port_run(case, None, steps=2)
    mdir, sdir = tmp_path / "meshed", tmp_path / "single"
    pckpt.CheckpointManager(str(mdir)).save(meshed2, opt_m)
    pckpt.CheckpointManager(str(sdir)).save(single2, opt_s)
    for name in ("params.npz", "ema.npz", "opt.npz"):
        with np.load(mdir / "ckpt_00000002" / name) as a, \
                np.load(sdir / "ckpt_00000002" / name) as b:
            assert sorted(a.files) == sorted(b.files)
            _close_leaves([b[k] for k in sorted(b.files)],
                          [a[k] for k in sorted(a.files)], STATE_RTOL, name)
    jtree = jload_params(str(mdir / "ckpt_00000002" / "params.npz"))
    assert sorted(pw.flatten(jtree)) == sorted(pw.flatten(_tree()))

    def third(state, mesh):
        fn = pstep.make_train_step(SPEC, opt_s, (SIZE, SIZE),
                                   dtype=torch.float32, mesh=mesh)
        state, _ = fn(state, images, targets)
        return state if mesh is None else pmesh.join_state(state)

    def template(mesh):
        t = pstep.init_train_state(pw.train_params_from_jax(_tree()), opt_s,
                                   ema=True)
        return t if mesh is None else pmesh.shard_state(t, mesh)

    m_states = _cached_run(case, (4, 2))[1]
    s_states = _cached_run(case)[1]
    # meshed -> single device
    got = third(pckpt.CheckpointManager(str(mdir)).restore(
        template(None), opt_s), None)
    _close_leaves(m_states[-1]["params"], pw.tree_leaves(got.params),
                  STATE_RTOL, "meshed ckpt resumed single-device")
    # single device -> 2x1
    got = third(pckpt.CheckpointManager(str(sdir)).restore(
        template(_vmesh((2, 1))), opt_s), _vmesh((2, 1)))
    _close_leaves(s_states[-1]["params"], pw.tree_leaves(got.params),
                  STATE_RTOL, "single-device ckpt resumed on 2x1")
    _close_leaves(s_states[-1]["ema"], pw.tree_leaves(got.ema_params),
                  STATE_RTOL, "single-device ckpt resumed on 2x1 (ema)")
    # meshed -> the same mesh: bit for bit
    restored = pckpt.CheckpointManager(str(mdir)).restore(
        template(_vmesh((4, 2))), opt_s)
    assert isinstance(restored, pstep.MeshTrainState) and restored.step == 2
    _copies_equal(restored)
    got = third(restored, restored.mesh)
    for a, b in zip(m_states[-1]["params"], pw.tree_leaves(got.params)):
        np.testing.assert_array_equal(a, b.detach().numpy())
    for a, b in zip(m_states[-1]["opt"], opt_s.state_leaves(got.opt_state)):
        np.testing.assert_array_equal(a, b)


def test_undivided_batch_and_unplaced_state_are_refused():
    """A batch that mesh.data does not divide is refused with a message, as
    JAX's sharding refuses it; so is a state not placed on the step's
    mesh."""
    opt = poptim.make_optimizer(1e-3)
    mesh = _vmesh((2, 1))
    fn = pstep.make_train_step(SPEC, opt, (SIZE, SIZE), dtype=torch.float32,
                               mesh=mesh)
    state = pstep.init_train_state(pw.train_params_from_jax(_tree()), opt)
    images, targets = next(jloop.synthetic_batches(3, SIZE))
    with pytest.raises(ValueError, match="batch 3 does not divide over "
                                         "data=2"):
        fn(fn.shard_state(state), images, targets)
    with pytest.raises(TypeError, match="shard_state"):
        fn(state, images[:2], targets[:2])


def test_mesh_wider_than_devices_trains_on_one_device(caplog):
    """mesh_data x mesh_model over fewer devices: a warning, and the
    single-device step (the serving engine's rule)."""
    opt = poptim.make_optimizer(1e-3)
    with caplog.at_level(logging.WARNING, logger="zlt.train"):
        fn = pstep.make_train_step(SPEC, opt, (SIZE, SIZE),
                                   dtype=torch.float32, mesh_data=2,
                                   device="cpu")
    assert fn.mesh is None
    assert any("needs 2 devices, have 1" in r.getMessage()
               for r in caplog.records)
    state = pstep.init_train_state(pw.train_params_from_jax(_tree()), opt)
    assert fn.shard_state(state) is state
    state, m = fn(state, *next(jloop.synthetic_batches(2, SIZE)))
    assert state.step == 1 and np.isfinite(float(m["loss"]))


def test_loop_cli_trains_on_a_mesh(monkeypatch, capsys, tmp_path):
    """The loop's CLI with --mesh-data 2 --device cpu: in this process on a
    virtual 2x1 mesh (it trains there and checkpoints), and as a process,
    where the CPU is one device (the warning, then one device)."""
    monkeypatch.setattr(pmesh, "available_devices",
                        lambda device="cuda": [CPU] * 8)
    ploop.main(["--mesh-data", "2", "--device", "cpu", "--steps", "2",
                "--batch", "4", "--ckpt-dir", str(tmp_path / "ck"),
                "--ema"])
    out = capsys.readouterr().out
    assert "train mesh 2x1 on cpu,cpu (virtual)" in out
    assert "step      2" in out
    assert sorted(os.listdir(tmp_path / "ck")) == ["ckpt_00000002"]
    proc = subprocess.run(
        [sys.executable, "-m", "zero_latency_yolo_tpu_torch.train.loop",
         "--mesh-data", "2", "--device", "cpu", "--steps", "1", "--batch",
         "2"], cwd=REPO, capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": str(REPO), "OMP_NUM_THREADS": "2"})
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "train mesh 2x1 needs 2 devices, have 1" in proc.stderr
    assert "step      1" in proc.stdout
