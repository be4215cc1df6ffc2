"""A per-device counter of the operations a step runs: FLOPs, HBM bytes,
collective bytes.

The port's counterpart of the JAX package's ``hlo_analysis.py``, which
reads a compiled SPMD program's HLO text. Here :class:`OpCounter`, a
``TorchDispatchMode``, sees every ATen operation of the step as it runs
(on real, fake or meta tensors) and counts, **per device**:

* ``flops``: the products' FLOPs by ``torch.utils.flop_counter``'s
  formulas (``mm``, ``bmm``, ``addmm``, ``baddbmm``, convolutions,
  attention); the reference's ``dot_flops`` likewise counts only dots.
  Elementwise operations count no FLOPs in either.
* ``hbm_bytes``: each operation's input and output bytes, the post-fusion
  estimate the reference makes at fusion boundaries, with no fusion here
  (eager PyTorch runs one kernel an operation). Views move nothing; a
  gather reads and writes its output's bytes; a scatter or an indexed
  write its update's; ``copy_`` its destination's twice.
* collectives: the bytes of every ``torch.distributed`` collective (the
  functional ones DTensor issues and the in-place ``c10d`` ones), by the
  reference's naive and ring formulas (:func:`collective_bytes`), per kind
  and in count.

Under DTensor the mode returns ``NotImplemented`` for an operation on
DTensors, so that DTensor first turns it into the operations it runs on
this rank's local shards and the collectives it needs, which the mode then
counts: a ``Shard(0)`` product on a 4-way mesh counts a quarter of the
FLOPs. DTensor's shape inference (its operations on fake tensors of the
global shapes) is not counted. There is no trip-count correction: Python loops unroll, so the
counter sees every iteration.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Dict, List, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten


def tensor_bytes(t: torch.Tensor) -> int:
    """A tensor's bytes (the reference's ``shape_bytes`` of its shape)."""
    return t.numel() * t.element_size()


def collective_bytes(kind: str, result_bytes: int, n: int
                     ) -> Tuple[int, int]:
    """``(naive operand bytes, ring link bytes)`` per device of one
    collective of ``kind`` whose result is ``result_bytes`` over a group of
    ``n``: all-gather and reduce-scatter move ``(n-1)/n`` of the gathered
    size on a ring, an all-reduce twice that."""
    n = max(n, 1)
    if kind == "all-gather":
        return result_bytes // n, result_bytes * (n - 1) // n
    if kind == "all-reduce":
        return result_bytes, 2 * result_bytes * (n - 1) // n
    if kind == "reduce-scatter":
        return result_bytes * n, result_bytes * (n - 1)
    if kind == "all-to-all":
        return result_bytes, result_bytes * (n - 1) // n
    return result_bytes, result_bytes   # collective-permute


@dataclasses.dataclass
class OpCosts:
    """Per-device costs, with ``HloCosts``' fields."""
    flops: int = 0
    hbm_bytes: int = 0
    collective_naive: int = 0
    collective_ring: int = 0
    collective_breakdown: Dict[str, int] = dataclasses.field(
        default_factory=dict)
    collective_count: int = 0


# collective operations by packet name -> (kind, how to find the group size)
_COLLECTIVES = {
    "_c10d_functional.all_reduce": "all-reduce",
    "_c10d_functional.all_gather_into_tensor": "all-gather",
    "_c10d_functional.reduce_scatter_tensor": "reduce-scatter",
    "_c10d_functional.all_to_all_single": "all-to-all",
    "_c10d_functional_autograd.all_gather_into_tensor": "all-gather",
    "_c10d_functional_autograd.reduce_scatter_tensor": "reduce-scatter",
    "_c10d_functional_autograd.all_to_all_single": "all-to-all",
    "c10d.allreduce_": "all-reduce",
    "c10d.allgather_": "all-gather",
    "c10d._allgather_base_": "all-gather",
    "c10d.reduce_scatter_": "reduce-scatter",
    "c10d._reduce_scatter_base_": "reduce-scatter",
    "c10d.alltoall_base_": "all-to-all",
}
# operations that move no bytes of their own
_FREE = {"_c10d_functional.wait_tensor", "_c10d_functional._wrap_tensor_autograd",
         "aten.empty", "aten.empty_like", "aten.empty_strided",
         "aten.new_empty", "aten.new_empty_strided", "aten.detach",
         "aten.lift_fresh", "aten._local_scalar_dense"}
_GATHERS = {"aten.index", "aten.index_select", "aten.gather",
            "aten.embedding", "aten.take", "aten.take_along_dim"}
# indexed writes: (position of the update among the arguments)
_SCATTERS = {"aten.index_put": 2, "aten.index_put_": 2,
             "aten._index_put_impl_": 2, "aten._index_put_impl": 2,
             "aten.scatter": 3, "aten.scatter_": 3, "aten.scatter_add": 3,
             "aten.scatter_add_": 3, "aten.index_copy": 3,
             "aten.index_copy_": 3, "aten.index_add": 3, "aten.index_add_": 3}
_META = {"aten.sym_size", "aten.sym_stride", "aten.sym_numel",
         "aten.sym_storage_offset", "aten.size", "aten.stride",
         "aten.numel", "aten.dim", "aten.is_contiguous",
         "aten.sym_is_contiguous", "aten.is_strides_like_format",
         "aten.is_non_overlapping_and_dense", "aten.storage_offset",
         "prim.layout", "prim.device"}


_STATE = threading.local()


def in_dtensor_propagation() -> bool:
    """True while DTensor infers an operation's output shapes."""
    return getattr(_STATE, "depth", 0) > 0


@contextlib.contextmanager
def marking_dtensor_propagation():
    """Mark DTensor's shape inference (:func:`in_dtensor_propagation`).

    To infer an operation's global output shape, DTensor runs it on fake
    tensors of the global shapes, under the active fake mode when there is
    one (the dry-run's): without the mark a counter under that mode could
    not tell those operations from the ones on this rank's shards."""
    from torch.distributed.tensor._sharding_prop import ShardingPropagator

    orig = ShardingPropagator._propagate_tensor_meta_non_cached

    def marked(self, *args, **kwargs):
        _STATE.depth = getattr(_STATE, "depth", 0) + 1
        try:
            return orig(self, *args, **kwargs)
        finally:
            _STATE.depth -= 1

    ShardingPropagator._propagate_tensor_meta_non_cached = marked
    try:
        yield
    finally:
        ShardingPropagator._propagate_tensor_meta_non_cached = orig


def _tensors(x) -> List[torch.Tensor]:
    return [t for t in tree_flatten(x)[0] if isinstance(t, torch.Tensor)]


def _group_size(args) -> int:
    """The size of a collective's process group, from its arguments: a
    group name (functional collectives) or a ``ProcessGroup`` (``c10d``)."""
    from torch.distributed.distributed_c10d import _resolve_process_group

    for a in tree_flatten(args)[0]:
        if isinstance(a, str):
            try:
                return _resolve_process_group(a).size()
            except (KeyError, RuntimeError, ValueError):
                continue
        if hasattr(a, "size") and not isinstance(a, torch.Tensor) \
                and callable(a.size):
            try:
                return int(a.size())
            except (TypeError, RuntimeError):
                continue
    return 1


class OpCounter(TorchDispatchMode):
    """Count a region's per-device costs into :attr:`costs`::

        with OpCounter() as oc:
            step(...)
        oc.costs.flops

    Under a ``FakeTensorMode`` (the dry-run) pass it as ``fake_mode``: only
    its tensors count as the device's."""

    def __init__(self, fake_mode=None):
        super().__init__()
        from torch.utils.flop_counter import flop_registry

        self._flops = flop_registry
        #: the ``FakeTensorMode`` whose tensors stand for the device's data
        #: (the dry-run's), if any
        self.fake_mode = fake_mode
        self.costs = OpCosts()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented   # count the local ops DTensor runs
        out = func(*args, **kwargs)
        if isinstance(func, torch._ops.OpOverload) and self._counts(
                _tensors((args, kwargs))):
            self._count(func, args, kwargs, out)
        return out

    def __enter__(self):
        self._marks = marking_dtensor_propagation()
        self._marks.__enter__()
        return super().__enter__()

    def __exit__(self, *a):
        try:
            return super().__exit__(*a)
        finally:
            self._marks.__exit__(*a)

    def _counts(self, tensors) -> bool:
        """False for an operation that is no device's work: DTensor's
        shape inference (:func:`marking_dtensor_propagation`), and any
        operation on meta tensors or on fake tensors of another fake mode
        than the region's."""
        from torch._subclasses.fake_tensor import FakeTensor

        if in_dtensor_propagation():
            return False
        for t in tensors:
            if t.device.type == "meta":
                return False
            if isinstance(t, FakeTensor) and t.fake_mode is not self.fake_mode:
                return False
        return True

    def _count(self, func, args, kwargs, out) -> None:
        name = str(func._overloadpacket)
        c = self.costs
        if name in _META or name in _FREE:
            return
        kind = _COLLECTIVES.get(name)
        if kind is not None:
            res = sum(tensor_bytes(t) for t in _tensors(out))
            if name.startswith("c10d."):   # in place: the result is the input
                res = sum(tensor_bytes(t) for t in _tensors(args[0]))
            naive, ring = collective_bytes(kind, res, _group_size(args))
            c.collective_naive += naive
            c.collective_ring += ring
            c.collective_count += 1
            c.collective_breakdown[kind] = c.collective_breakdown.get(
                kind, 0) + ring
            c.hbm_bytes += res
            return
        packet = func._overloadpacket
        if packet in self._flops:
            c.flops += int(self._flops[packet](*args, **kwargs, out_val=out))
        if func.is_view:
            return
        if name in _GATHERS:
            c.hbm_bytes += 2 * sum(tensor_bytes(t) for t in _tensors(out))
        elif name in _SCATTERS:
            pos = _SCATTERS[name]
            upd = args[pos] if len(args) > pos else None
            c.hbm_bytes += 2 * sum(tensor_bytes(t) for t in _tensors(upd))
        elif name == "aten.copy_":
            c.hbm_bytes += 2 * tensor_bytes(args[0])
        else:
            c.hbm_bytes += sum(tensor_bytes(t) for t in _tensors(args)) \
                + sum(tensor_bytes(t) for t in _tensors(out))
