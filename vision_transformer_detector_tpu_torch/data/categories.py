"""COCO category table: model id (0-79) <-> COCO id (1-90) <-> name.

The PyTorch port's own copy of vision_transformer_detector_tpu/data/
categories.py, kept as it is (tests/test_torch_self_contained.py holds the
two tables equal).

Replaces the reference's import-time pandas table construction
(vision_transformer_utilities.py:228-265, shipped as full_categories.csv):
the 80 COCO 2017 "thing" categories with their sparse ids and
supercategories are a fixed public table, so we embed it instead of parsing
instances_train2017.json at import. The model id of a category never changes
regardless of how many categories are being detected
(vision_transformer_utilities.py:261-263).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

# (id_in_coco, name, supercategory), ordered as in the COCO annotation file;
# index in this tuple == id_in_model (0..79).
COCO_CATEGORIES: Tuple[Tuple[int, str, str], ...] = (
    (1, "person", "person"),
    (2, "bicycle", "vehicle"),
    (3, "car", "vehicle"),
    (4, "motorcycle", "vehicle"),
    (5, "airplane", "vehicle"),
    (6, "bus", "vehicle"),
    (7, "train", "vehicle"),
    (8, "truck", "vehicle"),
    (9, "boat", "vehicle"),
    (10, "traffic light", "outdoor"),
    (11, "fire hydrant", "outdoor"),
    (13, "stop sign", "outdoor"),
    (14, "parking meter", "outdoor"),
    (15, "bench", "outdoor"),
    (16, "bird", "animal"),
    (17, "cat", "animal"),
    (18, "dog", "animal"),
    (19, "horse", "animal"),
    (20, "sheep", "animal"),
    (21, "cow", "animal"),
    (22, "elephant", "animal"),
    (23, "bear", "animal"),
    (24, "zebra", "animal"),
    (25, "giraffe", "animal"),
    (27, "backpack", "accessory"),
    (28, "umbrella", "accessory"),
    (31, "handbag", "accessory"),
    (32, "tie", "accessory"),
    (33, "suitcase", "accessory"),
    (34, "frisbee", "sports"),
    (35, "skis", "sports"),
    (36, "snowboard", "sports"),
    (37, "sports ball", "sports"),
    (38, "kite", "sports"),
    (39, "baseball bat", "sports"),
    (40, "baseball glove", "sports"),
    (41, "skateboard", "sports"),
    (42, "surfboard", "sports"),
    (43, "tennis racket", "sports"),
    (44, "bottle", "kitchen"),
    (46, "wine glass", "kitchen"),
    (47, "cup", "kitchen"),
    (48, "fork", "kitchen"),
    (49, "knife", "kitchen"),
    (50, "spoon", "kitchen"),
    (51, "bowl", "kitchen"),
    (52, "banana", "food"),
    (53, "apple", "food"),
    (54, "sandwich", "food"),
    (55, "orange", "food"),
    (56, "broccoli", "food"),
    (57, "carrot", "food"),
    (58, "hot dog", "food"),
    (59, "pizza", "food"),
    (60, "donut", "food"),
    (61, "cake", "food"),
    (62, "chair", "furniture"),
    (63, "couch", "furniture"),
    (64, "potted plant", "furniture"),
    (65, "bed", "furniture"),
    (67, "dining table", "furniture"),
    (70, "toilet", "furniture"),
    (72, "tv", "electronic"),
    (73, "laptop", "electronic"),
    (74, "mouse", "electronic"),
    (75, "remote", "electronic"),
    (76, "keyboard", "electronic"),
    (77, "cell phone", "electronic"),
    (78, "microwave", "appliance"),
    (79, "oven", "appliance"),
    (80, "toaster", "appliance"),
    (81, "sink", "appliance"),
    (82, "refrigerator", "appliance"),
    (84, "book", "indoor"),
    (85, "clock", "indoor"),
    (86, "vase", "indoor"),
    (87, "scissors", "indoor"),
    (88, "teddy bear", "indoor"),
    (89, "hair drier", "indoor"),
    (90, "toothbrush", "indoor"),
)

# Default detection set: all 80 names (vision_transformer_utilities.py:36-49).
CATEGORY_NAMES_TO_DETECT: Tuple[str, ...] = tuple(
    name for _, name, _ in COCO_CATEGORIES)

COCO_ID_TO_MODEL_ID: Dict[int, int] = {
    coco_id: model_id
    for model_id, (coco_id, _, _) in enumerate(COCO_CATEGORIES)
}
MODEL_ID_TO_COCO_ID: Dict[int, int] = {
    v: k for k, v in COCO_ID_TO_MODEL_ID.items()}
MODEL_ID_TO_NAME: Dict[int, str] = {
    model_id: name
    for model_id, (_, name, _) in enumerate(COCO_CATEGORIES)
}
NAME_TO_MODEL_ID: Dict[str, int] = {v: k for k, v in MODEL_ID_TO_NAME.items()}


def detected_coco_ids(
        names: Optional[Sequence[str]] = None) -> List[int]:
    """COCO ids of the categories to detect (all 80 by default)."""
    if names is None:
        names = CATEGORY_NAMES_TO_DETECT
    return [MODEL_ID_TO_COCO_ID[NAME_TO_MODEL_ID[n]] for n in names]


def categories_from_raw(raw_categories) -> List[Tuple[int, str, str]]:
    """Build the table from a COCO annotation file's 'categories' section,
    like _coco_categories_to_detect (vtu.py:228-265). Provided so users with
    custom datasets are not tied to the embedded table."""
    return [(c["id"], c["name"], c["supercategory"]) for c in raw_categories]
