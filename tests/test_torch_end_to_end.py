"""The port's worked example (examples/end_to_end_torch.py) runs green on
the CPU: every stage prints its JSON line and leaves its artifact, the
served detections are well-formed, and the artifact server's process is
gone afterwards. The same script runs on the card in chip_smoke.py's
``walkthrough`` phase. Also the overlay tool that draws an overfit run's
metrics against the reference's recorded run with the port's plotting
(tools/overlay_overfit_torch.py)."""

import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STAGES = ("dataset", "train", "evaluate", "plot", "visualize", "export",
          "serve")


def test_walkthrough_on_the_cpu_runs_every_stage(tmp_path):
    script = os.path.join(REPO, "examples", "end_to_end_torch.py")
    proc = subprocess.run(
        [sys.executable, script, "--device", "cpu", "--epochs", "4",
         "--workdir", str(tmp_path)], cwd=REPO, capture_output=True,
        text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = [json.loads(line) for line in proc.stdout.splitlines()
             if line.startswith("{")]
    stages = {line["stage"]: line for line in lines if "stage" in line}
    assert tuple(stages) == STAGES, sorted(stages)
    summary = lines[-1]
    assert summary["ok"] is True and summary["device"] == "cpu"
    for artifact in summary["artifacts"]:
        assert os.path.exists(os.path.join(str(tmp_path), artifact)), artifact

    assert stages["dataset"]["images"] == 16
    assert "final.pt" in stages["train"]["checkpoints"]
    assert stages["train"]["final_loss"] == stages["train"]["final_loss"]
    for key in ("AP", "AP50", "AP75", "AR@100"):
        value = stages["evaluate"][key]
        assert value == -1.0 or 0.0 <= value <= 1.0, (key, value)
    assert stages["evaluate"]["protocol"] == "coco-original"
    assert os.path.getsize(stages["plot"]["written"]) > 0
    assert stages["visualize"]["pngs"] == 16
    assert os.path.exists(stages["visualize"]["contact_sheet"])
    export = stages["export"]
    assert export["platforms"] == ["cpu"] and export["batch_sizes"] == [1, 4]
    assert export["max_abs_diff"] <= 2e-4
    for name in ("model_b1.pt2", "model_b4.pt2", "params.npz",
                 "config.json"):
        assert os.path.exists(os.path.join(export["dir"], name)), name
    serve = stages["serve"]
    assert serve["detections"] == 17 and serve["requests_ok"] == 1
    assert set(serve["image_size"]) == {"height", "width"}
    assert serve["server_exit_code"] == 0


def test_overlay_tool_draws_a_run_against_the_reference(tmp_path):
    """A metrics file with evals at two of the reference's epochs: the
    chart is written and the table carries those epochs' values."""
    metrics = tmp_path / "metrics.jsonl"
    with open(metrics, "w") as f:
        for epoch, loss, ap in ((500, 3.5, 0.4), (1500, 1.25, 0.75)):
            f.write(json.dumps({"epoch": epoch, "loss": loss}) + "\n")
            f.write(json.dumps({"epoch": epoch, "ap": ap}) + "\n")
    output = tmp_path / "overlay.html"
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, "tools",
                                      "overlay_overfit_torch.py"),
         "--metrics", str(metrics), "--output", str(output)],
        cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    result = json.loads(proc.stdout)
    assert result["plot"] == str(output) and output.stat().st_size > 0
    rows = {row["epoch"]: row for row in result["table"]}
    assert len(rows) == 13
    assert rows[500]["our_loss"] == 3.5 and rows[1500]["our_ap"] == 0.75
    assert rows[500]["ref_ap"] == 0.4522
