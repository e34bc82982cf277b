"""The port's detection kernels on the card against their plain versions
(``kernels/detection.py``: ``greedy_nms`` and ``det_match``), bit for bit,
on rows that a block's shared memory holds and on rows past it (boxes or
detections then read from device memory).

Marked ``card``: each test skips where torch sees no CUDA device (this
file imports no JAX, so it runs on a machine without it). On a card:

    python -m pytest --noconftest -p no:cacheprovider \\
        tests/test_torch_detection_card.py -q
"""

import pytest
import torch

from paddle_tpu_torch.kernels import detection as kdet
from paddle_tpu_torch.ops import detection_ops

NMS_CASES = [
    # (name, rows, k, box scale, threshold, eta, offset)
    ("eval_head", 640, 400, 1.0, 0.3, 1.0, 0.0),
    ("eta_0.9", 64, 400, 1.0, 0.7, 0.9, 0.0),
    ("pixel_boxes", 16, 400, 300.0, 0.5, 1.0, 1.0),
    ("shared_above_48KB", 2, 6000, 800.0, 0.7, 1.0, 0.0),
    ("unstaged_12000", 2, 12000, 800.0, 0.7, 0.9, 0.0),
    ("unstaged_28276", 1, 28276, 1.0, 0.3, 1.0, 0.0),
]

MATCH_CASES = [
    # (name, images, detections an image, gts an image, evaluate_difficult)
    ("eval_head", 32, 200, 16, True),
    ("difficult_skipped", 32, 200, 16, False),
    ("unstaged_8000", 2, 8000, 16, True),
]


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def _nms_inputs(rows, k, scale, seed):
    """Score-sorted boxes around 20 centres a row (so suppression
    happens), scores on a 0.01 grid (ties), about a tenth ineligible."""
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def rand(*shape):
        return torch.rand(*shape, generator=gen, device="cuda")

    centres = scale * (0.1 + 0.8 * rand(rows, 20, 2))
    pick = torch.randint(0, 20, (rows, k), generator=gen, device="cuda")
    ctr = torch.gather(centres, 1, pick[..., None].expand(rows, k, 2))
    ctr = ctr + 0.02 * scale * torch.randn(rows, k, 2, generator=gen,
                                           device="cuda")
    wh = scale * (0.05 + 0.2 * rand(rows, k, 2))
    boxes = torch.cat([ctr - wh / 2, ctr + wh / 2], dim=2)
    scores = torch.round(rand(rows, k) * 100) / 100
    order = torch.sort(-scores, dim=1, stable=True).indices
    boxes = torch.gather(boxes, 1, order[..., None].expand(rows, k, 4))
    return boxes.contiguous(), torch.gather(scores, 1, order) > 0.1


def _match_inputs(n, d, g, seed):
    """Detections of 20 classes (the last rows of each image label -1
    padding), most near a gt; 1..8 gts an image padded to ``g``, a fifth
    difficult; with each detection's global rank."""
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def rand(*shape):
        return torch.rand(*shape, generator=gen, device="cuda")

    m = torch.randint(1, 9, (n, 1), generator=gen, device="cuda")
    real = torch.arange(g, device="cuda")[None, :] < m
    xy = 0.7 * rand(n, g, 2)
    gt_box = torch.cat([xy, xy + 0.1 + 0.2 * rand(n, g, 2)], dim=2)
    gt_label = torch.where(real, torch.randint(
        1, 21, (n, g), generator=gen, device="cuda"), -1).to(torch.int32)
    src = (rand(n, d) * m).long()
    near = torch.gather(gt_box, 1, src[..., None].expand(n, d, 4))
    near = near + 0.03 * torch.randn(n, d, 4, generator=gen, device="cuda")
    xy = 0.7 * rand(n, d, 2)
    anywhere = torch.cat([xy, xy + 0.1 + 0.2 * rand(n, d, 2)], dim=2)
    is_near = rand(n, d, 1) < 0.6
    label = torch.where(rand(n, d) < 0.5,
                        torch.gather(gt_label, 1, src).float(),
                        torch.randint(1, 21, (n, d), generator=gen,
                                      device="cuda").float())
    live = torch.arange(d, device="cuda")[None, :] < (d * 3) // 4
    label = torch.where(live, label, -1.0)
    score = torch.round(rand(n, d) * 100) / 100
    det = torch.cat([label[..., None], score[..., None],
                     torch.where(is_near, near, anywhere)], dim=2)
    _, rank = detection_ops.global_rank(det)
    return det, rank, gt_label, gt_box, rand(n, g) < 0.2


@pytest.mark.card
@pytest.mark.parametrize("case", NMS_CASES, ids=[c[0] for c in NMS_CASES])
def test_greedy_nms_equals_plain(case):
    _card()
    name, rows, k, scale, thr, eta, offset = case
    boxes, elig = _nms_inputs(rows, k, scale, seed=k)
    before = kdet.GREEDY_NMS.launches
    got = kdet.greedy_nms(boxes, elig, thr, eta, offset)
    want = kdet.greedy_nms_plain(boxes, elig, thr, eta, offset)
    torch.cuda.synchronize()
    assert kdet.GREEDY_NMS.launches == before + 1
    assert (k > kdet.NMS_MAX_K) == name.startswith("unstaged")
    assert 0 < int(want.sum()) < int(elig.sum())
    assert torch.equal(got, want), name


@pytest.mark.card
@pytest.mark.parametrize("case", MATCH_CASES,
                         ids=[c[0] for c in MATCH_CASES])
def test_det_match_equals_plain(case):
    _card()
    name, n, d, g, eval_diff = case
    det, rank, lab, box, diff = _match_inputs(n, d, g, seed=d + eval_diff)
    before = kdet.DET_MATCH.launches
    tp, fp = kdet.det_match(det, rank, lab, box, diff, 0.5, eval_diff)
    tp_p, fp_p = kdet.det_match_plain(det, rank, lab, box, diff, 0.5,
                                      eval_diff)
    torch.cuda.synchronize()
    assert kdet.DET_MATCH.launches == before + 1
    assert int(tp_p.sum()) > 0 and int(fp_p.sum()) > 0
    assert torch.equal(tp, tp_p) and torch.equal(fp, fp_p), name
