"""Atomic, asynchronous checkpoints in the JAX package's on-disk layout.

PyTorch twin of the JAX package's ``repro.checkpoint.checkpointer``, with
the same layout: ``<dir>/step_<N>/`` holds one ``.npy`` per leaf (its
flattened key path, ``/`` written ``__``) and ``meta.json`` (step, extra
state such as the data iterator's, and each leaf's file, shape and dtype).
Keys are the ones ``jax.tree_util`` gives the reference's trees: a dict's
keys in sorted order, and a ``NamedTuple``'s fields as ``.<name>`` (the
trainer's optimizer state is ``opt/.step``, ``opt/.mu/...``,
``opt/.nu/...``). So a checkpoint written by either package restores into
the other.

Commit protocol: write into ``step_<N>.tmp``, then rename it atomically;
a crash mid-save never corrupts the latest checkpoint, and a stray
``.tmp`` is ignored. The leaves are copied to host memory before
:meth:`Checkpointer.save` returns, and written on a background thread;
:meth:`Checkpointer.wait` joins it. The three newest checkpoints are kept.

:meth:`Checkpointer.restore` puts each leaf on the device it is given,
or, with ``shardings`` (a tree of DTensor placements, the port's
``tree_shardings``) and a ``mesh``, distributes it onto that mesh
(``distribute_tensor``): the elastic restart onto another mesh. The file
layout does not depend on the mesh. A DTensor leaf is gathered whole
before it is written (a collective: every rank calls ``save``), and only
rank 0 of the default process group writes.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _flatten(tree, prefix: Tuple[str, ...] = ()) -> Dict[str, Any]:
    """``{key path: leaf}`` in ``jax.tree_util``'s order and spelling."""
    if isinstance(tree, dict):
        out: Dict[str, Any] = {}
        for k in sorted(tree):
            out.update(_flatten(tree[k], prefix + (str(k),)))
        return out
    if _is_namedtuple(tree):
        out = {}
        for name in tree._fields:
            out.update(_flatten(getattr(tree, name), prefix + (f".{name}",)))
        return out
    return {"/".join(prefix): tree}


def _unflatten(like, leaves: Dict[str, Any], prefix: Tuple[str, ...] = ()):
    """``like``'s structure with the leaf at each key path from
    ``leaves``."""
    if isinstance(like, dict):
        return {k: _unflatten(like[k], leaves, prefix + (str(k),))
                for k in sorted(like)}
    if _is_namedtuple(like):
        return type(like)(*(_unflatten(getattr(like, name), leaves,
                                       prefix + (f".{name}",))
                            for name in like._fields))
    return leaves["/".join(prefix)]


def _to_host(leaf) -> np.ndarray:
    """A host copy of ``leaf`` (a DTensor gathered whole) that later
    in-place updates of the tensor cannot touch."""
    from torch.distributed.tensor import DTensor

    if isinstance(leaf, DTensor):
        leaf = leaf.full_tensor()
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy().copy()
    return np.array(leaf)


class Checkpointer:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None

    # -- save ----------------------------------------------------------------
    def save(self, step: int, tree, extra: Optional[Dict] = None,
             blocking: bool = False) -> None:
        self.wait()
        flat = {k: _to_host(v) for k, v in _flatten(tree).items()}
        if _rank() != 0:
            return

        def _write():
            tmp = os.path.join(self.dir, f"step_{step:09d}.tmp")
            final = os.path.join(self.dir, f"step_{step:09d}")
            if os.path.exists(tmp):
                shutil.rmtree(tmp)
            os.makedirs(tmp)
            meta = {"step": step, "extra": extra or {}, "leaves": {}}
            for key, leaf in flat.items():
                fn = key.replace("/", "__") + ".npy"
                np.save(os.path.join(tmp, fn), leaf)
                meta["leaves"][key] = {"file": fn,
                                       "shape": list(np.shape(leaf)),
                                       "dtype": str(leaf.dtype)}
            with open(os.path.join(tmp, "meta.json"), "w") as f:
                json.dump(meta, f)
            if os.path.exists(final):
                shutil.rmtree(final)
            os.rename(tmp, final)  # atomic commit
            self._gc()

        if blocking:
            _write()
        else:
            self._thread = threading.Thread(target=_write, daemon=True)
            self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _gc(self) -> None:
        steps = self.all_steps()
        for s in steps[: -self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:09d}"),
                          ignore_errors=True)

    # -- restore -------------------------------------------------------------
    def all_steps(self):
        out = []
        for d in os.listdir(self.dir):
            if d.startswith("step_") and not d.endswith(".tmp"):
                out.append(int(d.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: int, like, shardings=None, *, mesh=None,
                device="cpu"):
        """Returns ``(tree, extra)``: ``like``'s structure (nested dicts and
        ``NamedTuple``s; its leaves are not read) with every leaf loaded as
        a tensor on ``device``. ``shardings`` (optional, ``like``'s
        structure, a leaf's DTensor placements or ``None``) re-shards for
        ``mesh``: a leaf with placements becomes a DTensor on ``mesh``
        (on the mesh's device type)."""
        path = os.path.join(self.dir, f"step_{step:09d}")
        with open(os.path.join(path, "meta.json")) as f:
            meta = json.load(f)
        placements = _flatten(shardings) if shardings is not None else {}
        if placements and mesh is None:
            raise ValueError("restore: shardings need the mesh they are for")
        loaded = {}
        for key in _flatten(like):
            info = meta["leaves"][key]
            arr = torch.from_numpy(np.load(os.path.join(path, info["file"])))
            pl = placements.get(key)
            if pl is None:
                loaded[key] = arr.to(device)
                continue
            from torch.distributed.tensor import distribute_tensor

            loaded[key] = distribute_tensor(arr.to(mesh.device_type), mesh,
                                            pl)
        return _unflatten(like, loaded), meta["extra"]


def _rank() -> int:
    """This process's rank in the default process group (0 without one)."""
    import torch.distributed as dist

    return dist.get_rank() if dist.is_available() and dist.is_initialized() \
        else 0
