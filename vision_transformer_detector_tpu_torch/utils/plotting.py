"""Training-curve plotting: loss + AP on a dual-axis chart.

Replaces scatters_plotly (vision_transformer_utilities.py:618-675). Reads
the trainer's jsonl metrics and writes an HTML file (plotly when available,
else a self-contained SVG fallback so the tool works in minimal images).

The port's own copy of vision_transformer_detector_tpu/utils/plotting.py, held
equal to it by tests/test_torch_self_contained.py (it imports no JAX).
"""

from __future__ import annotations

import json
from typing import List, Optional, Sequence, Tuple

Scatter = Tuple[Sequence[float], Sequence[float], str]


def read_metrics(path: str):
    """Load the trainer's jsonl metrics into (epochs, losses, ap_epochs,
    aps)."""
    epochs, losses, ap_epochs, aps = [], [], [], []
    with open(path) as f:
        for line in f:
            record = json.loads(line)
            if "loss" in record:
                epochs.append(record.get("epoch", len(epochs)))
                losses.append(record["loss"])
            if "ap" in record:
                ap_epochs.append(record.get("epoch", len(ap_epochs)))
                aps.append(record["ap"])
    return epochs, losses, ap_epochs, aps


def scatters_plot(scatters_inputs: List[Scatter],
                  titles: Tuple[str, str, str],
                  file_name: str,
                  secondary_y: bool = False,
                  secondary_y_title: Optional[str] = None) -> str:
    """Multi-trace line chart, optional secondary y-axis (loss + AP on one
    chart like vtu.py:618-675). Writes ``file_name`` and returns it."""
    try:
        return _plotly_chart(scatters_inputs, titles, file_name,
                             secondary_y, secondary_y_title)
    except ImportError:
        return _svg_chart(scatters_inputs, titles, file_name)


def _plotly_chart(scatters_inputs, titles, file_name,
                  secondary_y, secondary_y_title):
    import plotly.graph_objects as go
    from plotly.subplots import make_subplots

    if secondary_y:
        fig = make_subplots(specs=[[{"secondary_y": True}]])
    else:
        fig = go.Figure()
    for i, (x, y, name) in enumerate(scatters_inputs):
        trace = go.Scatter(x=list(x), y=list(y), name=name,
                           mode="lines+markers")
        if secondary_y and i > 0:
            fig.add_trace(trace, secondary_y=True)
        else:
            fig.add_trace(trace)
    fig.update_layout(title=titles[0], xaxis_title=titles[1],
                      yaxis_title=f"<b>{titles[2]}</b>")
    if secondary_y and secondary_y_title:
        fig.update_yaxes(title_text=f"<b>{secondary_y_title}</b>",
                         secondary_y=True)
    fig.write_html(file_name)
    return file_name


def _svg_chart(scatters_inputs, titles, file_name):
    """Dependency-free SVG line chart fallback."""
    width, height, pad = 900, 500, 60
    colors = ["#d62728", "#1f77b4", "#2ca02c", "#9467bd"]
    parts = [
        f'<svg xmlns="http://www.w3.org/2000/svg" width="{width}" '
        f'height="{height}"><rect width="100%" height="100%" fill="white"/>',
        f'<text x="{width/2}" y="24" text-anchor="middle" '
        f'font-size="16">{titles[0]}</text>',
    ]
    for i, (x, y, name) in enumerate(scatters_inputs):
        if not x:
            continue
        x = list(map(float, x))
        y = list(map(float, y))
        x0, x1 = min(x), max(x)   # zero-span handled by span_x below
        y0, y1 = min(y), max(y)
        span_x = (x1 - x0) or 1.0
        span_y = (y1 - y0) or 1.0
        points = " ".join(
            f"{pad + (xi - x0) / span_x * (width - 2 * pad):.1f},"
            f"{height - pad - (yi - y0) / span_y * (height - 2 * pad):.1f}"
            for xi, yi in zip(x, y))
        color = colors[i % len(colors)]
        parts.append(f'<polyline fill="none" stroke="{color}" '
                     f'stroke-width="1.5" points="{points}"/>')
        parts.append(f'<text x="{pad}" y="{40 + 16 * i}" fill="{color}" '
                     f'font-size="12">{name}</text>')
    parts.append("</svg>")
    html = f"<html><body>{''.join(parts)}</body></html>"
    with open(file_name, "w") as f:
        f.write(html)
    return file_name


def plot_training_curves(metrics_path: str, file_name: str) -> str:
    """The notebook's loss+AP dual-axis chart (ipynb cell 12)."""
    epochs, losses, ap_epochs, aps = read_metrics(metrics_path)
    scatters = [(epochs, losses, "loss")]
    if aps:
        scatters.append((ap_epochs, aps, "AP"))
    return scatters_plot(
        scatters, ("loss-AP-scatters", "epochs", "loss"), file_name,
        secondary_y=bool(aps), secondary_y_title="AP")
