"""The comparisons that decide ``correct``.

Detections (inference and serving). The program's answer for an image is
its list of kept detections (score, class, box). Each is matched to one of
the reference's 17 decoded slots, and three gaps are taken, each the
largest over the images:
  * ``box_gap``: the widest box coordinate gap;
  * ``score_gap``: the score gap (score = objectness * class confidence,
    continuous across a change of class);
  * ``class_miss``: how far the reference's class value lies beyond the
    half-way point to the class the program gave (0 when they agree).
Every output is sigmoid(logit) times a scale (79 for the class value, the
image's side for a box), so a rounding that moves a logit by a hundredth
moves a class value by tenths and its confidence with it, and a box by
pixels. Each gap is divided by how fast its output moves with its logit at
the reference's value: the gaps read in logit units, where rounding acts
alike on every output. ``nms_breaks`` counts the service's packed output
rows (kept and dropped slots alike) that break the plain NMS and top-k
rules on the program's own boxes: an exact comparison.

Training. The loss of each of the first three steps, the norm of each
leaf's first gradient as the optimiser gets it (clipped), and the norm of
each leaf's change over the three steps, compared with the reference's
leaf by leaf: the gap of the two norms over the reference's norm of that
leaf or of the median leaf, whichever is larger, taken at the worst leaf
(``grad_gap``, ``update_gap``) and as the mean over the leaves
(``grad_gap_mean``, ``update_gap_mean``). Leaves whose reference gradient
is under a thousandth of the median leaf's move by round-off alone and are
left out of the change. ``grad_dev`` (and ``grad_dev_mean``) takes the
norm of the difference of the two first gradients in place of the gap of
their norms: a rounding error that is unbiased moves a leaf's norm only in
its second order, and its gradient in the first.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

from scipy.optimize import linear_sum_assignment

GAP_NUMBERS = ("box_gap", "score_gap", "class_miss")


def _iou(boxes: np.ndarray) -> np.ndarray:
    cx, cy, h, w = boxes.T
    left, right, top, bottom = cx - w / 2, cx + w / 2, cy - h / 2, cy + h / 2
    iw = np.clip(np.minimum(right[:, None], right[None])
                 - np.maximum(left[:, None], left[None]), 0, None)
    ih = np.clip(np.minimum(bottom[:, None], bottom[None])
                 - np.maximum(top[:, None], top[None]), 0, None)
    inter = iw * ih
    area = h * w
    return inter / (area[:, None] + area[None] - inter + 1e-8)


def _beyond_ulp(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """|a - b| less two float32 spacings of the larger: what a float32
    output cannot tell apart reads 0 (a box at 640 px holds its logit to
    about 16, and a saturated sigmoid's gap in logits would otherwise be
    its last bit's)."""
    spacing = np.spacing(np.maximum(np.abs(a), np.abs(b)).astype(np.float32))
    return np.clip(np.abs(a - b) - 2.0 * spacing, 0, None)


def _logit_rates(decoded: np.ndarray, width: float, height: float,
                 num_classes: int):
    """How fast each output moves with its logit at the reference's values:
    (box (slots, 4), score (slots,), class value (slots,)), and the
    reference's scores."""
    obj, value = decoded[:, 0], decoded[:, 1]
    top = num_classes - 1
    conf = 1.0 - 2.0 * np.abs(value - np.round(value))
    size = np.array([width, height, height, width])
    ratio = decoded[:, 2:6] / size
    box = np.clip(ratio * (1.0 - ratio), 1e-9, None) * size
    cls = np.clip((value / top) * (1.0 - value / top) * top, 1e-9, None)
    score = np.clip(obj * (1.0 - obj) * conf + 2.0 * obj * cls, 1e-9, None)
    return box, score, cls, obj * conf


def image_gaps(dets: Sequence[dict], decoded: np.ndarray, width: float,
               height: float, num_classes: int) -> Dict[str, float]:
    """``box_gap``, ``score_gap`` and ``class_miss`` of one image, in logit
    units: ``dets`` the program's detections, ``decoded`` the reference's
    (slots, 6) decoded values. Each detection is matched to the slot that
    explains it best (one to one, least summed gap)."""
    decoded = np.asarray(decoded, np.float64)
    out = dict.fromkeys(GAP_NUMBERS, 0.0)
    if not len(dets):
        return out
    if len(dets) > decoded.shape[0]:
        return dict.fromkeys(GAP_NUMBERS, float("inf"))
    box_rate, score_rate, cls_rate, ref_score = _logit_rates(
        decoded, width, height, num_classes)
    box = np.array([[d["box"][c] for c in ("cx", "cy", "h", "w")]
                    for d in dets], np.float64)
    score = np.array([d["score"] for d in dets], np.float64)
    cls = np.array([d["class_id"] for d in dets], np.float64)
    gaps = np.stack([
        (_beyond_ulp(box[:, None], decoded[None, :, 2:6])
         / box_rate).max(-1),
        _beyond_ulp(score[:, None], ref_score[None]) / score_rate,
        np.clip(np.abs(cls[:, None] - decoded[None, :, 1]) - 0.5, 0, None)
        / cls_rate])                                  # (3, dets, slots)
    rows, cols = linear_sum_assignment(gaps.sum(0))
    for key, g in zip(GAP_NUMBERS, gaps):
        out[key] = float(g[rows, cols].max())
    return out


def detection_gaps(dets_per_image: List[Sequence[dict]],
                   decoded: np.ndarray, width: float, height: float,
                   num_classes: int) -> Dict[str, float]:
    """The three gaps, each the largest over the images."""
    out = dict.fromkeys(GAP_NUMBERS, 0.0)
    for dets, dec in zip(dets_per_image, decoded):
        for key, v in image_gaps(dets, dec, width, height,
                                 num_classes).items():
            out[key] = max(out[key], v)
    return out


def nms_breaks(raws: Sequence[np.ndarray], iou_threshold: float = 0.5,
               tolerance: float = 1e-4) -> int:
    """Rows of the packed (B, k, 7) outputs (score, class, cx, cy, h, w,
    valid) that break the plain NMS and top-k rules, on the program's own
    boxes: two kept boxes of one class overlapping above the threshold; a
    dropped box that no kept box of its class overlaps above it; kept
    boxes not first, or not in falling score order. ``tolerance`` spares
    overlaps that sit on the threshold (float32 on the device, float64
    here)."""
    breaks = 0
    for raw in raws:
        for row in np.asarray(raw, np.float64).reshape(-1, raw.shape[-2], 7):
            kept = row[:, 6] > 0.5
            n = int(kept.sum())
            scores = row[:n, 0]
            if not kept[:n].all() or np.any(np.diff(scores) > 0):
                breaks += 1
                continue
            iou = _iou(row[:, 2:6])
            same = row[:, 1][:, None] == row[:, 1][None]
            over = (iou > iou_threshold + tolerance) & same
            near = (iou > iou_threshold - tolerance) & same
            k = np.flatnonzero(kept)
            d = np.flatnonzero(~kept)
            if over[np.ix_(k, k)][~np.eye(n, dtype=bool)].any() or (
                    len(d) and not near[np.ix_(d, k)].any(1).all()):
                breaks += 1
    return breaks


def _leaf_gaps(prog: Dict[str, float], ref: Dict[str, float],
               names: Sequence[str]) -> np.ndarray:
    median = float(np.median([ref[n] for n in ref]))
    return np.array([abs(prog[n] - ref[n]) / max(ref[n], median, 1e-30)
                     for n in names])


def train_gaps(prog: dict, ref: dict) -> Dict[str, float]:
    """``prog`` and ``ref`` each hold ``losses`` (three steps),
    ``grad_norms`` and ``update_norms`` (per leaf); ``ref`` also
    ``grad_diff_norms``, the norm of each leaf's difference of the two
    first gradients. Each leaf gap is taken by the worst leaf and,
    steadier from seed to seed, as the mean over the leaves."""
    losses = [abs(p - r) / max(abs(r), 1e-30)
              for p, r in zip(prog["losses"], ref["losses"])]
    if len(prog["losses"]) != len(ref["losses"]) or not all(
            np.isfinite(prog["losses"])):
        losses.append(float("inf"))
    grads = ref["grad_norms"]
    median = float(np.median(list(grads.values())))
    moving = [n for n in grads if grads[n] >= 1e-3 * median]
    grad = _leaf_gaps(prog["grad_norms"], grads, list(grads))
    update = _leaf_gaps(prog["update_norms"], ref["update_norms"], moving)
    diff = ref["grad_diff_norms"]
    dev = np.array([diff[n] / max(grads[n], median, 1e-30) for n in grads])
    return {"loss_gap": float(max(losses)),
            "grad_gap": float(grad.max()),
            "grad_gap_mean": float(grad.mean()),
            "grad_dev": float(dev.max()),
            "grad_dev_mean": float(dev.mean()),
            "update_gap": float(update.max()),
            "update_gap_mean": float(update.mean())}


def verdict(numbers: Dict[str, float], limits: Dict[str, float]) -> bool:
    """Every number compared is finite and within its limit."""
    return all(np.isfinite(numbers[k]) and numbers[k] <= limits[k]
               for k in limits)
