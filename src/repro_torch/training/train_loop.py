"""Trainer: one training step a call, in a fault-tolerant loop.

PyTorch twin of the JAX package's ``repro.training.train_loop.Trainer``:
  * periodic async checkpoints (atomic commit) in the reference's layout,
    data-pipeline state included for exact resume;
  * preemption handling: SIGTERM/SIGINT set a flag, and the loop writes a
    final synchronous checkpoint before it stops;
  * crash/restart: :meth:`Trainer.resume` restores params + optimizer +
    pipeline state and continues exactly (a checkpoint written by the JAX
    package's trainer restores here too);
  * straggler accounting: steps exceeding ``straggler_factor`` x the
    rolling median are counted.

A step is ``loss.backward()`` through the model's ``loss_fn`` (in
bfloat16, as the reference's) and then ``adamw_update`` under
``torch.no_grad()``, which writes the float32 parameters and moments in
place. The reference's elastic restart onto another mesh and its
int8-compressed cross-pod gradients wait for a device mesh
(``ROADMAP.md``, queue 1, item 5): ``resume(mesh=...)`` raises
``NotImplementedError``.
"""
from __future__ import annotations

import signal
import statistics
import time
from typing import Dict, List, Optional

import torch

from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.data.pipeline import DataPipeline, PipelineState
from repro_torch.kernels.ops import checked_device
from repro_torch.models.layers import tree_leaves, tree_map
from repro_torch.training.optimizer import (
    AdamWConfig,
    AdamWState,
    adamw_update,
    init_adamw,
)


class Trainer:
    def __init__(
        self,
        model,
        opt_cfg: AdamWConfig,
        pipeline: DataPipeline,
        *,
        checkpoint_dir: Optional[str] = None,
        checkpoint_every: int = 50,
        remat: str = "none",
        straggler_factor: float = 3.0,
        seed: int = 0,
        device="cuda",
    ):
        self.device = checked_device(device)
        self.model = model
        self.opt_cfg = opt_cfg
        self.pipeline = pipeline
        self.remat = remat
        self.ckpt = Checkpointer(checkpoint_dir) if checkpoint_dir else None
        self.checkpoint_every = checkpoint_every
        self.straggler_factor = straggler_factor
        self.step_times: List[float] = []
        self.straggler_events = 0
        self.step = 0
        self._preempted = False

        self.params = model.init_params(seed, device=self.device)
        for p in tree_leaves(self.params):
            p.requires_grad_(True)
        self.opt_state = init_adamw(self.params)
        self.history: List[Dict[str, float]] = []

    # -- preemption -----------------------------------------------------------
    def install_signal_handlers(self) -> None:
        def _handler(signum, frame):
            self._preempted = True

        signal.signal(signal.SIGTERM, _handler)
        signal.signal(signal.SIGINT, _handler)

    # -- checkpointing --------------------------------------------------------
    def _state_tree(self):
        return {"params": self.params, "opt": self.opt_state}

    def save(self, blocking: bool = False) -> None:
        if self.ckpt is None:
            return
        extra = {"pipeline": self.pipeline.state.as_dict(), "step": self.step}
        self.ckpt.save(self.step, self._state_tree(), extra, blocking=blocking)

    def resume(self, mesh=None) -> bool:
        """Restore the latest checkpoint onto this trainer's device.
        Returns True if something was restored. A ``mesh`` (the
        reference's elastic restart) is not supported yet."""
        if mesh is not None:
            raise NotImplementedError(
                "restoring onto a device mesh waits for the port's mesh "
                "(ROADMAP.md, queue 1, item 5)")
        if self.ckpt is None:
            return False
        latest = self.ckpt.latest_step()
        if latest is None:
            return False
        tree, extra = self.ckpt.restore(latest, self._state_tree(),
                                        device=self.device)
        self.params = tree_map(lambda p: p.requires_grad_(True),
                               tree["params"])
        self.opt_state = AdamWState(*tree["opt"])
        self.step = extra["step"]
        self.pipeline.state = PipelineState.from_dict(extra["pipeline"])
        return True

    # -- the loop -------------------------------------------------------------
    def train_step(self, batch: Dict[str, torch.Tensor]) -> Dict[str, float]:
        """One step on ``batch`` (tensors on the trainer's device):
        gradients of the model's ``loss_fn``, then AdamW in place.
        Returns the metrics ``loss`` (the NLL), ``lr`` and ``grad_norm``."""
        _total, metrics = self.model.loss_fn(self.params, batch,
                                             remat=self.remat)
        _total.backward()
        grads = tree_map(lambda p: p.grad, self.params)
        with torch.no_grad():
            self.params, self.opt_state, om = adamw_update(
                self.opt_cfg, self.params, grads, self.opt_state)
        for p in tree_leaves(self.params):
            p.grad = None
        return {"loss": float(metrics["loss"].detach()),
                "lr": float(om["lr"]), "grad_norm": float(om["grad_norm"])}

    def train(self, num_steps: int) -> List[Dict]:
        for _ in range(num_steps):
            if self._preempted:
                self.save(blocking=True)
                break
            t0 = time.perf_counter()
            batch = self.pipeline.next_batch()
            # copies: the pipeline refills its buffers in place
            tb = {k: torch.tensor(batch[k], device=self.device)
                  for k in ("tokens", "labels")}
            metrics = self.train_step(tb)
            dt = time.perf_counter() - t0
            self.step += 1
            self.step_times.append(dt)
            if len(self.step_times) >= 5:
                med = statistics.median(self.step_times[-50:])
                if dt > self.straggler_factor * med:
                    self.straggler_events += 1
            self.history.append({"step": self.step, **metrics, "time": dt})
            if self.ckpt and self.step % self.checkpoint_every == 0:
                self.save()
        if self.ckpt:
            self.ckpt.wait()
        return self.history
