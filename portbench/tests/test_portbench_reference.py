"""The plain reference against the port's plain path, at yolov8p and a
small size on the CPU. The test imports both; the reference itself
imports nothing of the port."""

import numpy as np
import torch

from portbench.reference import detect as ref_detect
from portbench.reference import model as ref_model
from zero_latency_yolo_tpu_torch.models.weights import (params_from_jax,
                                                        place_params,
                                                        save_params)
from zero_latency_yolo_tpu_torch.models.yolov8 import (forward_decoded,
                                                       get_spec, init_params)
from zero_latency_yolo_tpu_torch.ops import nms as nms_ops
from zero_latency_yolo_tpu_torch.ops.preprocess import (letterbox_batch_mxu,
                                                        letterbox_params)

SIZE = 128


def _frame(seed, h=90, w=120):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, (h, w, 3), dtype=np.uint8)


def test_letterbox_matches_the_ports():
    for h, w in ((90, 120), (120, 90), (37, 200)):
        f = _frame(h * w, h, w)
        buf = np.zeros((1, 208, 208, 3), np.uint8)
        buf[0, :h, :w] = f
        port = letterbox_batch_mxu(torch.from_numpy(buf),
                                   torch.tensor([h], dtype=torch.int32),
                                   torch.tensor([w], dtype=torch.int32), SIZE)
        ref, scale, px, py = ref_detect.letterbox(torch.from_numpy(f), SIZE)
        assert torch.allclose(ref.permute(1, 2, 0), port[0], atol=2e-6)
        s, ppx, ppy = letterbox_params(torch.tensor([float(h)]),
                                       torch.tensor([float(w)]), SIZE)
        assert (scale, px, py) == (float(s), float(ppx), float(ppy))


def test_forward_and_postprocess_match_the_ports_plain_path(tmp_path):
    spec = get_spec("yolov8p", 4)
    tree = init_params(3, spec, folded=False)   # BN blocks: folded by both
    path = tmp_path / "p.npz"
    save_params(tree, str(path))
    wts = ref_model.load_weights(str(path), ref_model.sha256_of(str(path)),
                                 "cpu")
    scale = ref_model.Scale(0.33, 0.125, 256, 4)
    x = torch.rand(2, 3, SIZE, SIZE, generator=torch.Generator().manual_seed(5))
    boxes, probs = ref_model.decode(ref_model.forward(wts, scale, x))
    params = place_params(params_from_jax(tree), torch.device("cpu"),
                          torch.float32)
    pred = forward_decoded(params, spec, x.permute(0, 2, 3, 1), plain=True)
    assert torch.allclose(boxes, pred[..., :4], rtol=1e-4, atol=1e-3)
    assert torch.allclose(probs, pred[..., 4:], rtol=1e-4, atol=1e-5)

    # Postprocess on the same decoded output, at a threshold some pass.
    cw = torch.tensor([1.0, 1.0, 1.2, 0.8])
    conf = float(torch.quantile((pred[..., 4:] * cw).max(-1)[0][0], 0.9))
    sc = torch.tensor([0.5, 0.5])
    pad = torch.tensor([[3.0, 17.0], [3.0, 17.0]])
    src = torch.tensor([[250.0, 220.0], [250.0, 220.0]])
    out = nms_ops.postprocess_batch(pred, cw, conf, 0.45, sc, pad, src, 64,
                                    plain=True)
    for b in range(2):
        rows = ref_detect.postprocess(pred[b, :, :4], pred[b, :, 4:], cw,
                                      conf, 0.45, 64, 0.5, 3.0, 17.0, 250,
                                      220)
        n = int(out["count"][b])
        assert len(rows) == n > 0
        assert np.allclose(rows[:, :4], out["boxes"][b, :n].numpy(),
                           atol=1e-6)
        assert np.allclose(rows[:, 4], out["scores"][b, :n].numpy(),
                           atol=1e-7)
        assert np.array_equal(rows[:, 5], out["classes"][b, :n].numpy())
