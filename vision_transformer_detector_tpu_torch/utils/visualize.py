"""Headless prediction/label visualisation.

File-output renderer replacing the reference's interactive cv2 windows
(vision_transformer_detector.py:2187-2456): draws thresholded detections
(box + class name + optional confidence) onto the denormalised images with
PIL and writes PNGs. Threshold semantics match visualize_predictions
(vtd.py:2257-2340): objectness AND class confidence both above threshold.

``write_contact_sheet`` adds the interactive affordance the PNGs alone
lack: a single self-contained HTML file (images base64-embedded) with the
reference viewer's keyboard flow (vtd.py:2342-2354) mapped to a browser —
arrows / any-key step through images, ``s`` saves the current frame,
``q``/Esc leaves the single-image view for a grid overview.

The port's own copy of vision_transformer_detector_tpu/utils/visualize.py, held
equal to it by tests/test_torch_self_contained.py (it imports no JAX).
"""

from __future__ import annotations

import os
from typing import Sequence

import numpy as np

from ..config import DetectorConfig
from ..data.categories import MODEL_ID_TO_NAME
from ..metrics.mean_average_precision import _class_confidence, _decode_np

_PALETTE = [
    (230, 25, 75), (60, 180, 75), (255, 225, 25), (0, 130, 200),
    (245, 130, 48), (145, 30, 180), (70, 240, 240), (240, 50, 230),
    (210, 245, 60), (250, 190, 212), (0, 128, 128), (220, 190, 255),
]


def denormalize_image(image: np.ndarray) -> np.ndarray:
    """[-1,1] float -> uint8 (vtd.py:2224-2230)."""
    if image.dtype == np.uint8:
        return image
    return np.clip((image + 1.0) * 127.5, 0, 255).astype(np.uint8)


def draw_detections(image: np.ndarray,
                    detections: np.ndarray,
                    objectness_threshold: float = 0.5,
                    classification_threshold: float = 0.5,
                    show_confidence: bool = True,
                    decoded: bool = True,
                    config: DetectorConfig = DetectorConfig()) -> np.ndarray:
    """Draw one image's detections. ``detections`` is ``(max_objects, 6)``
    decoded (or raw when ``decoded=False``)."""
    from PIL import Image, ImageDraw

    if not decoded:
        detections = _decode_np(detections[None], config)[0]

    pil = Image.fromarray(denormalize_image(image))
    draw = ImageDraw.Draw(pil)
    for row in np.asarray(detections, np.float32):
        objectness, classification = row[0], row[1]
        confidence = float(_class_confidence(np.float32(classification)))
        if objectness <= objectness_threshold:
            continue
        if confidence <= classification_threshold:
            continue
        class_id = int(round(float(classification)))
        cx, cy, h, w = row[2], row[3], row[4], row[5]
        box = (cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2)
        color = _PALETTE[class_id % len(_PALETTE)]
        draw.rectangle(box, outline=color, width=2)
        name = MODEL_ID_TO_NAME.get(class_id, str(class_id))
        text = f"{name} {confidence:.2f}" if show_confidence else name
        draw.text((box[0] + 2, max(0.0, box[1] - 12)), text, fill=color)
    return np.asarray(pil)


def draw_labels(image: np.ndarray, labels: np.ndarray,
                config: DetectorConfig = DetectorConfig()) -> np.ndarray:
    """Label-mode rendering (vtd.py:2363-2456 dataset-input path): draw the
    ground-truth boxes (objectness==1 slots)."""
    rows = np.asarray(labels, np.float32).copy()
    # Make labels look like decoded predictions with full confidence.
    rows = rows[np.isclose(rows[:, 0], 1.0)]
    return draw_detections(image, rows, objectness_threshold=0.0,
                           classification_threshold=0.0,
                           show_confidence=False, config=config)


def visualize_predictions(images: np.ndarray,
                          predictions: np.ndarray,
                          output_dir: str,
                          objectness_threshold: float = 0.5,
                          classification_threshold: float = 0.5,
                          show_confidence: bool = True,
                          decoded: bool = False,
                          config: DetectorConfig = DetectorConfig(),
                          prefix: str = "prediction",
                          start_index: int = 0) -> Sequence[str]:
    """Batch renderer -> PNG files; returns the written paths.

    ``predictions`` raw (default, like model.predict feeding
    visualize_predictions at vtd.py:2447) or already decoded.
    """
    from PIL import Image

    os.makedirs(output_dir, exist_ok=True)
    if not decoded:
        predictions = _decode_np(np.asarray(predictions), config)
    paths = []
    for i, (image, dets) in enumerate(zip(np.asarray(images), predictions)):
        rendered = draw_detections(
            image, dets, objectness_threshold, classification_threshold,
            show_confidence, decoded=True, config=config)
        path = os.path.join(output_dir,
                            f"{prefix}_{start_index + i:04d}.png")
        Image.fromarray(rendered).save(path)
        paths.append(path)
    return paths


_SHEET_TEMPLATE = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>__TITLE__</title><style>
  body { background:#111; color:#ddd; font-family:sans-serif; margin:0; }
  h1 { font-size:16px; padding:10px 16px; margin:0; }
  .hint { color:#888; font-size:12px; padding:0 16px 10px; }
  #grid { display:flex; flex-wrap:wrap; gap:8px; padding:0 16px 16px; }
  #grid figure { margin:0; cursor:pointer; }
  #grid img { max-width:240px; max-height:240px; display:block;
               border:1px solid #333; }
  #grid figcaption { font-size:11px; color:#999; max-width:240px;
                      overflow:hidden; text-overflow:ellipsis; }
  #single { display:none; position:fixed; inset:0; background:#000;
             text-align:center; }
  #single img { max-width:100vw; max-height:92vh; }
  #single .bar { color:#aaa; font-size:13px; padding:6px; }
</style></head><body>
<h1>__TITLE__</h1>
<div class="hint">Click an image to view full size. Keys in single view:
&larr;/&rarr; (or any key) step &middot; s saves the frame &middot;
q / Esc back to the grid &mdash; the reference viewer&rsquo;s controls
(vision_transformer_detector.py:2342-2354).</div>
<div id="grid">__FIGURES__</div>
<div id="single"><div class="bar" id="bar"></div><img id="big"></div>
<script>
  const figs = Array.from(document.querySelectorAll('#grid figure'));
  const single = document.getElementById('single');
  const big = document.getElementById('big');
  const bar = document.getElementById('bar');
  let idx = -1;
  function show(i) {
    idx = (i + figs.length) % figs.length;
    const img = figs[idx].querySelector('img');
    big.src = img.src;
    bar.textContent = (idx + 1) + ' / ' + figs.length + '  ' +
        figs[idx].querySelector('figcaption').textContent;
    single.style.display = 'block';
  }
  figs.forEach((f, i) => f.addEventListener('click', () => show(i)));
  document.addEventListener('keydown', (e) => {
    if (single.style.display !== 'block') return;
    if (e.key === 'q' || e.key === 'Escape') {
      single.style.display = 'none';
    } else if (e.key === 'ArrowLeft') {
      show(idx - 1);
    } else if (e.key === 's') {
      const a = document.createElement('a');
      a.href = big.src;
      a.download = figs[idx].querySelector('figcaption').textContent
          || 'image_test.png';
      a.click();
    } else {
      show(idx + 1);  // any other key: next (cv.waitKey(0) semantics)
    }
  });
</script></body></html>
"""


def write_contact_sheet(image_paths: Sequence[str], output_path: str,
                        title: str = "detection results") -> str:
    """Bundle rendered PNGs into one self-contained interactive HTML file.

    Images are base64-embedded so the sheet survives being copied off the
    TPU host alone — the right "interactive viewer" shape for a headless
    machine, replacing cv2.imshow + waitKey (vtd.py:2342-2354). Returns
    ``output_path``.
    """
    import base64
    import html

    figures = []
    for path in image_paths:
        with open(path, "rb") as f:
            payload = base64.b64encode(f.read()).decode("ascii")
        name = html.escape(os.path.basename(path))
        figures.append(
            f'<figure><img src="data:image/png;base64,{payload}" '
            f'alt="{name}"><figcaption>{name}</figcaption></figure>')
    page = (_SHEET_TEMPLATE
            .replace("__TITLE__", html.escape(title))
            .replace("__FIGURES__", "\n".join(figures)))
    os.makedirs(os.path.dirname(output_path) or ".", exist_ok=True)
    with open(output_path, "w") as f:
        f.write(page)
    return output_path
