"""COCO dataset statistics tool, single- and multi-process.

Equivalent of coco_statistics.py (T1-T5 in SURVEY.md §2.3): per image-shard
it reports (1) the maximum number of annotations in one image, (2) the most
frequent category overall, (3) the category with the most annotations in a
single image — plus a single-vs-multi-process benchmark harness
(coco_statistics.py:392-444). Unlike the reference it takes the annotation
dict / image list as inputs instead of hardcoded Windows paths.

The port's own copy of vision_transformer_detector_tpu/data/statistics.py, held
equal to it by tests/test_torch_self_contained.py (it imports no JAX).
"""

from __future__ import annotations

import time
from collections import Counter
from concurrent.futures import ProcessPoolExecutor
from typing import Dict, List, Optional, Sequence, Tuple


def worker(image_names: Sequence[str],
           annotations_dict: Dict[str, list]
           ) -> Tuple[List[Tuple[int, str]], List[Tuple[int, int, str]],
                      List[int]]:
    """Per-shard statistics (coco_statistics.py:60-134).

    Returns (annotations_tally, max_annotations_per_image,
    showed_up_categories):
      * annotations_tally: (count, image_name) per image,
      * max_annotations_per_image: (category_id_in_coco, quantity,
        image_name) — the dominant category of each annotated image,
      * showed_up_categories: category ids, one entry per (image, category)
        presence (so a global Counter gives images-containing-category).
    """
    tally: List[Tuple[int, str]] = []
    dominant: List[Tuple[int, int, str]] = []
    showed_up: List[int] = []

    for name in image_names:
        annotations = annotations_dict.get(name, [])
        tally.append((len(annotations), name))
        if not annotations:
            continue
        counts = Counter(int(a[0]) for a in annotations)
        category_id, quantity = counts.most_common(1)[0]
        dominant.append((category_id, quantity, name))
        showed_up.extend(set(counts))

    return tally, dominant, showed_up


def _merge(results):
    tally: List[Tuple[int, str]] = []
    dominant: List[Tuple[int, int, str]] = []
    showed_up: List[int] = []
    for t, d, s in results:
        tally.extend(t)
        dominant.extend(d)
        showed_up.extend(s)
    return tally, dominant, showed_up


def summarize(tally, dominant, showed_up) -> Dict[str, object]:
    summary: Dict[str, object] = {
        "images": len(tally),
        "annotated_images": len(dominant),
        "max_annotations_in_one_image": max(tally)[0] if tally else 0,
    }
    if tally:
        summary["image_with_max_annotations"] = max(tally)[1]
    if showed_up:
        category, images_count = Counter(showed_up).most_common(1)[0]
        summary["most_frequent_category"] = category
        summary["most_frequent_category_images"] = images_count
    if dominant:
        category, quantity, image = max(dominant, key=lambda r: r[1])
        summary["max_single_image_category"] = category
        summary["max_single_image_category_quantity"] = quantity
        summary["max_single_image_category_image"] = image
    return summary


def coco_statistics(image_names: Sequence[str],
                    annotations_dict: Dict[str, list]) -> Dict[str, object]:
    """Single-process statistics (coco_statistics.py:277-389)."""
    return summarize(*worker(image_names, annotations_dict))


def coco_statistics_multi_processing(
        image_names: Sequence[str],
        annotations_dict: Dict[str, list],
        group_size: int = 10_000,
        max_workers: Optional[int] = None) -> Dict[str, object]:
    """Multi-process statistics (coco_statistics.py:138-273): shard the
    image list into groups of <= group_size, fan out, merge."""
    groups = [list(image_names[i:i + group_size])
              for i in range(0, len(image_names), group_size)]
    if len(groups) <= 1:
        return coco_statistics(image_names, annotations_dict)
    # Ship each worker only ITS group's annotation rows: pickling the
    # full dict per group (860k rows on COCO-train) made IPC dominate
    # and could erase the multiprocessing win entirely.
    subsets = [{name: annotations_dict[name]
                for name in group if name in annotations_dict}
               for group in groups]
    with ProcessPoolExecutor(max_workers=max_workers) as pool:
        results = list(pool.map(worker, groups, subsets))
    return summarize(*_merge(results))


def benchmark(image_names: Sequence[str],
              annotations_dict: Dict[str, list],
              sizes: Sequence[int] = (1_000, 4_000, 8_000, 20_000)
              ) -> List[Dict[str, float]]:
    """Single vs multi-process timing table (coco_statistics.py:392-444)."""
    rows = []
    for size in sizes:
        subset = list(image_names[:size])
        tic = time.perf_counter()
        coco_statistics(subset, annotations_dict)
        single = time.perf_counter() - tic
        tic = time.perf_counter()
        coco_statistics_multi_processing(subset, annotations_dict,
                                         group_size=max(1, size // 4))
        multi = time.perf_counter() - tic
        rows.append({"images": size, "single_s": round(single, 3),
                     "multi_s": round(multi, 3),
                     "speedup": round(single / multi, 2) if multi else 0.0})
    return rows
