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
place.

With a ``mesh`` (a ``DeviceMesh`` over the default process group) the
parameters and moments are DTensors placed by ``tree_shardings`` of the
model's logical axes (FSDP over ``data``, TP over ``model``), the batch is
sharded over the batch axes, ``tp_size`` is the mesh's ``model`` size, and
each gradient is redistributed to its parameter's placements before the
update (the reduction over the data axes). ``resume(mesh=...)`` restores
onto that mesh's placements: the elastic restart.
"""
from __future__ import annotations

import signal
import statistics
import time
from typing import Dict, List, Optional

import torch

from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.common.sharding import (
    distribute_tree,
    is_distributed,
    mesh_axis_sizes,
    sharding_for,
    tree_shardings,
    use_mesh,
)
from repro_torch.data.pipeline import DataPipeline, PipelineState
from repro_torch.kernels.ops import checked_device
from repro_torch.models.layers import tree_leaves, tree_map
from repro_torch.training.optimizer import (
    AdamWConfig,
    AdamWState,
    adamw_update,
    init_adamw,
)


def _grad_as_param(p: torch.Tensor) -> torch.Tensor:
    """``p``'s gradient, for a DTensor redistributed to ``p``'s
    placements (a partial gradient is reduced over its axes)."""
    g = p.grad
    if is_distributed(p) and tuple(g.placements) != tuple(p.placements):
        g = g.redistribute(p.device_mesh, p.placements)
    return g


def _scalar(x) -> float:
    """A float of a one-element tensor or DTensor."""
    if is_distributed(x):
        x = x.full_tensor()
    return float(x.detach() if isinstance(x, torch.Tensor) else x)


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
        mesh=None,
    ):
        self.device = checked_device(device)
        self.mesh = mesh
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
        self.tp = 1
        if mesh is not None:
            self.params = distribute_tree(self.params,
                                          self._shardings(mesh), mesh)
            self.tp = mesh_axis_sizes(mesh).get("model", 1)
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

    def _shardings(self, mesh):
        """The parameters' placements on ``mesh`` (``tree_shardings``)."""
        return tree_shardings(self.model.abstract_params(),
                              self.model.param_axes(), mesh)

    # -- checkpointing --------------------------------------------------------
    def _state_tree(self):
        return {"params": self.params, "opt": self.opt_state}

    def save(self, blocking: bool = False) -> None:
        if self.ckpt is None:
            return
        extra = {"pipeline": self.pipeline.state.as_dict(), "step": self.step}
        self.ckpt.save(self.step, self._state_tree(), extra, blocking=blocking)

    def resume(self, mesh=None) -> bool:
        """Restore the latest checkpoint (optionally onto a new mesh —
        elastic restart: the parameters and moments are distributed onto
        its placements, and later steps run on it). Returns True if
        something was restored."""
        if self.ckpt is None:
            return False
        latest = self.ckpt.latest_step()
        if latest is None:
            return False
        mesh = mesh or self.mesh
        shardings = None
        if mesh is not None:
            p_sh = self._shardings(mesh)
            shardings = {"params": p_sh, "opt": AdamWState(None, p_sh, p_sh)}
            self.mesh = mesh
            self.tp = mesh_axis_sizes(mesh).get("model", 1)
        tree, extra = self.ckpt.restore(latest, self._state_tree(), shardings,
                                        mesh=mesh, device=self.device)
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
        with use_mesh(self.mesh):
            if self.mesh is not None:
                batch = {k: self._shard_batch(v) for k, v in batch.items()}
            _total, metrics = self.model.loss_fn(self.params, batch,
                                                 remat=self.remat,
                                                 tp_size=self.tp)
            _total.backward()
            grads = tree_map(_grad_as_param, self.params)
            with torch.no_grad():
                self.params, self.opt_state, om = adamw_update(
                    self.opt_cfg, self.params, grads, self.opt_state)
            for p in tree_leaves(self.params):
                p.grad = None
            return {"loss": _scalar(metrics["loss"]), "lr": _scalar(om["lr"]),
                    "grad_norm": _scalar(om["grad_norm"])}

    def _shard_batch(self, t: torch.Tensor):
        """``t [B, ...]`` (the same on every rank) as a DTensor sharded on
        its batch dim by the active rules."""
        from torch.distributed.tensor import distribute_tensor

        logical = ("batch",) + (None,) * (t.dim() - 1)
        return distribute_tensor(t, self.mesh,
                                 sharding_for(t.shape, logical, self.mesh))

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
