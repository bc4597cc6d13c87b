"""The ``train`` traffic kind: eager training steps."""

from __future__ import annotations

import math
import time
from typing import Dict, Optional

import torch

from perfbench import compare, inputs
from perfbench.harness import Run, port_model
from perfbench.reference import vit_detector as ref
from perfbench.trace import Tracer


class Driver:
    """Eager ``Trainer.train_step`` over ``distinct_batches`` batches held
    on the device. Set-up drives the same train state through its first
    three steps on batches 0-2 (the window's own call and feed) and keeps
    what the check compares: each step's loss, each leaf's first gradient
    (from Adam's first moment after one step; its norm, and the gradient
    itself on the host) and each leaf's change over the three steps. The
    window goes on from step 4."""

    def __init__(self, run: Run):
        self.run = run
        self.t = run.traffic

    def make_inputs(self) -> None:
        run, t = self.run, self.t
        self.batches = [
            (inputs.make_images(t["batch"], run.cfg, run.seed,
                                f"train.images.{r}", run.device),
             inputs.make_labels(t["batch"], run.cfg, run.seed,
                                f"train.labels.{r}", run.device))
            for r in range(t["distinct_batches"])]

    def setup(self) -> None:
        from vision_transformer_detector_tpu_torch.config import (
            LossConfig, TrainConfig)
        from vision_transformer_detector_tpu_torch.train.trainer import (
            Trainer)

        run, t = self.run, self.t
        self.make_inputs()
        model = port_model(run.port_cfg, inputs.make_weights(
            run.cfg, run.seed, run.device))
        self.trainer = Trainer(run.port_cfg, LossConfig(**t["loss"]),
                               TrainConfig(**t["train"]), device=run.device)
        self.step_fn = self.trainer.train_step
        self.state = {
            "params": model,
            "opt_state": self.trainer.optimizer.init(
                dict(model.named_parameters())),
            "step": 0,
            "dropout_rng": torch.Generator().manual_seed(
                inputs.stream_seed(run.seed, "dropout"))}
        self.first = {"losses": []}
        for s in range(3):
            self.first["losses"].append(float(self._step()))
            if s == 0:
                mu = self.state["opt_state"]["mu"]
                scale = 1.0 - self.trainer.optimizer.b1
                grads = {n: m.float() / scale for n, m in mu.items()}
                self.first["grad_norms"] = _norms(grads)
                self.first_grads = {n: g.cpu() for n, g in grads.items()}
                del grads
        theta0 = inputs.make_weights(run.cfg, run.seed, run.device)
        self.first["update_norms"] = _norms(
            {n: p.detach() - theta0[n] for n, p in model.named_parameters()})
        del theta0
        run.spans["train_step"].clear()

    def _step(self):
        batch = self.batches[self.state["step"] % len(self.batches)]
        with torch.profiler.record_function("perfbench.train_step"):
            tic = time.perf_counter()
            _, loss = self.step_fn(self.state, *batch)
            self.run.spans["train_step"].append(time.perf_counter() - tic)
        return loss

    def window(self, seconds: float) -> None:
        run = self.run
        every = self.t["loss_every"]
        steps = 0
        tic = time.perf_counter()
        while True:
            loss = self._step()
            steps += 1
            last = time.perf_counter() - tic >= seconds
            if last or steps % every == 0:
                if not math.isfinite(float(loss)):
                    run.failed += 1
            if last:
                break
        run.window_s = time.perf_counter() - tic
        run.units = run.attempted = steps
        run.images = steps * self.t["batch"]

    def trace(self, tracer: Tracer) -> None:
        tracer.begin(0)
        for _ in range(self.t["trace_units"]):
            self._step()
        tracer.end(self.t["trace_units"])

    def end_to_end(self) -> Dict[str, float]:
        return {"train_img_per_s": self.run.images / self.run.window_s}

    def release(self) -> None:
        del self.state, self.trainer, self.step_fn

    def reference(self, against: Optional[Dict[str, torch.Tensor]],
                  prec=ref.EXACT, keep: bool = False) -> dict:
        """The reference's first three steps from the same weights and
        batches, with the norm of each leaf's first gradient and, given
        ``against`` (the other side's first gradient, on the host), of its
        difference from it. With ``keep``, ``self.grads`` keeps its own
        first gradient on the host."""
        run, t = self.run, self.t
        w = inputs.make_weights(run.cfg, run.seed, run.device)
        theta0 = {n: v.clone() for n, v in w.items()}
        out = {}

        def on_step(step, weights, grads, opt):
            if step:
                return
            clipped = {n: g.clamp(-opt.clip, opt.clip)
                       for n, g in grads.items()}
            out["grad_norms"] = _norms(clipped)
            if against is not None:
                out["grad_diff_norms"] = _norms(
                    {n: g - against[n].to(g.device)
                     for n, g in clipped.items()})
            if keep:
                self.grads = {n: g.cpu() for n, g in clipped.items()}

        with ref.strict_fp32():
            out["losses"] = ref.train_steps(
                w, self.batches[:3], run.cfg, t["loss"], t["train"], 3,
                t["reference_chunk"], prec, on_step)
        out["update_norms"] = _norms({n: w[n] - theta0[n] for n in w})
        return out

    def check(self) -> Dict[str, float]:
        reference = self.reference(self.first_grads)
        del self.first_grads
        self.run.detail = {"program": self.first, "reference": reference}
        return compare.train_gaps(self.first, reference)

    def control(self) -> Dict[str, float]:
        """The reference in float8 e4m3 in the program's place; its first
        gradient is held against the float32 reference's."""
        control = self.reference(None, ref.fp8_e4m3(), keep=True)
        reference = self.reference(self.grads)
        del self.grads
        self.run.detail = {"control": control, "reference": reference}
        return compare.train_gaps(control, reference)


def _norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    names = list(tensors)
    values = torch.stack([tensors[n].float().norm() for n in names]).cpu()
    return {n: float(v) for n, v in zip(names, values)}
