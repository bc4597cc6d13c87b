"""Hyperparameter sweeps.

Counterpart of vision_transformer_detector_tpu/train/sweep.py, copied as
it is (tests/test_torch_self_contained.py holds the copy equal) except
where it builds the port's ``Trainer``, which also takes the ``device``
(under a ``mesh``, each process runs the sweep on its own shard). A config grid is expanded to its
cartesian product, each point trains through ``train.trainer.Trainer``,
and the results stream to ``records.jsonl`` plus per-run metrics files
the plotting tool understands. Override keys are routed by name to
whichever config dataclass owns them (DetectorConfig / TrainConfig /
LossConfig).
"""

from __future__ import annotations

import dataclasses
import itertools
import json
import os
import time
from typing import Any, Callable, Dict, Iterable, List, Optional, Sequence

from ..config import DetectorConfig, LossConfig, TrainConfig
from .trainer import Trainer


def expand_grid(grid: Dict[str, Sequence[Any]]) -> List[Dict[str, Any]]:
    """Cartesian product of ``{param: [values...]}`` in insertion order."""
    if not grid:
        return [{}]
    keys = list(grid)
    return [dict(zip(keys, values))
            for values in itertools.product(*(grid[k] for k in keys))]


def _field_names(cls) -> set:
    return {f.name for f in dataclasses.fields(cls)}


def split_overrides(point: Dict[str, Any]):
    """Route override keys to (detector, train, loss) override dicts."""
    detector_fields = _field_names(DetectorConfig)
    train_fields = _field_names(TrainConfig)
    loss_fields = _field_names(LossConfig)
    detector: Dict[str, Any] = {}
    train: Dict[str, Any] = {}
    loss: Dict[str, Any] = {}
    for key, value in point.items():
        if key in detector_fields:
            # image_size arrives as an int from flat sweep specs.
            if key == "image_size" and isinstance(value, int):
                value = (value, value)
            detector[key] = value
        elif key in train_fields:
            train[key] = value
        elif key in loss_fields:
            loss[key] = value
        else:
            raise KeyError(
                f"sweep parameter {key!r} is not a field of DetectorConfig, "
                f"TrainConfig or LossConfig")
    return detector, train, loss


def run_sweep(
        grid: Dict[str, Sequence[Any]],
        make_data: Callable[[DetectorConfig, TrainConfig], tuple],
        base_config: DetectorConfig = DetectorConfig(),
        base_train_config: TrainConfig = TrainConfig(),
        base_loss_config: LossConfig = LossConfig(),
        epochs: Optional[int] = None,
        out_dir: str = "sweep",
        mesh=None,
        device="cuda",
        plot: bool = True) -> List[Dict[str, Any]]:
    """Train every grid point; return (and persist) the records table.

    ``make_data(config, train_config)`` builds ``(train_data, eval_data)``
    per point — datasets depend on swept fields like image_size/batch_size.
    Each record carries the swept parameters plus best_AP, lowest/final
    loss and hours, mirroring the notebook's records DataFrame columns
    (ipynb cells 6, 9).
    """
    os.makedirs(out_dir, exist_ok=True)
    records_path = os.path.join(out_dir, "records.jsonl")
    # Fresh table per sweep: the per-point writes below append, so a
    # re-run into the same out_dir used to mix stale rows (with
    # duplicate 'run' indices) into a table whose run_00x artifacts the
    # second run had overwritten.
    open(records_path, "w").close()
    records: List[Dict[str, Any]] = []

    for index, point in enumerate(expand_grid(grid)):
        det_over, train_over, loss_over = split_overrides(point)
        config = base_config.replace(**det_over)
        train_config = dataclasses.replace(base_train_config, **train_over)
        loss_config = dataclasses.replace(base_loss_config, **loss_over)
        run_epochs = epochs if epochs is not None else train_config.epochs

        run_dir = os.path.join(out_dir, f"run_{index:03d}")
        os.makedirs(run_dir, exist_ok=True)
        metrics_path = os.path.join(run_dir, "metrics.jsonl")

        train_data, eval_data = make_data(config, train_config)
        if not hasattr(train_data, "__len__"):
            # A silent steps_per_epoch=1 fallback would make the LR
            # decay boundaries count optimizer STEPS instead of epochs —
            # every sweep point would train on a wrong schedule and the
            # records table would compare mis-trained runs.
            raise TypeError(
                "make_data must return a sized train dataset (__len__): "
                "the LR schedule boundaries are epochs x steps_per_epoch "
                f"and got {type(train_data).__name__} with no length. "
                "Materialize the batches or wrap the stream with a "
                "known-length dataset.")
        trainer = Trainer(config, loss_config, train_config,
                          steps_per_epoch=max(1, len(train_data)),
                          mesh=mesh, metrics_path=metrics_path,
                          device=device)
        state = trainer.init_state()
        tic = time.time()
        trainer.fit(state, train_data, epochs=run_epochs,
                    eval_data=eval_data)
        hours = (time.time() - tic) / 3600.0

        record: Dict[str, Any] = dict(point)
        record.update({
            "run": index,
            "best_AP": trainer.best_ap,
            "lowest_loss": min(trainer.loss_record),
            "final_loss": trainer.loss_record[-1],
            "hours": round(hours, 4),
            "metrics_path": metrics_path,
        })
        trainer.metrics.close()   # one open fd per grid point otherwise

        if plot:
            try:
                from ..utils.plotting import plot_training_curves
                record["plot_path"] = plot_training_curves(
                    metrics_path,
                    os.path.join(run_dir, "loss-AP-scatters.html"))
            except Exception:  # plotting never fails a sweep
                record["plot_path"] = None

        # Persist AFTER the plot so records.jsonl carries the same fields
        # as the returned table (plot_path was silently missing on disk).
        records.append(record)
        with open(records_path, "a") as f:
            f.write(json.dumps(record) + "\n")

    return records


def format_records(records: Iterable[Dict[str, Any]]) -> str:
    """Aligned text table of the records (the notebook's DataFrame print)."""
    records = list(records)
    if not records:
        return "(no records)"
    columns = [c for c in records[0] if c not in ("metrics_path",
                                                  "plot_path")]
    rows = [[str(r.get(c, "")) for c in columns] for r in records]
    widths = [max(len(c), *(len(row[i]) for row in rows))
              for i, c in enumerate(columns)]
    lines = ["  ".join(c.ljust(w) for c, w in zip(columns, widths))]
    for row in rows:
        lines.append("  ".join(v.ljust(w) for v, w in zip(row, widths)))
    return "\n".join(lines)
