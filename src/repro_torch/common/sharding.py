"""Logical-axis sharding rules (MaxText-style) with divisibility fallback,
on a ``torch.distributed`` ``DeviceMesh``.

PyTorch twin of the JAX package's ``repro.common.sharding``. Every
parameter / activation dimension carries a *logical* axis name; rules map
logical names onto physical mesh axes. ``spec_for`` degrades gracefully: a
dimension that is not divisible by its mapped mesh axes is replicated
rather than erroring, which is what lets one rule table serve ten
architectures (e.g. 8 KV heads on a 16-way model axis -> replicate).

The JAX terms map onto PyTorch's as follows:

* ``Mesh`` -> ``torch.distributed.device_mesh.DeviceMesh``
  (:func:`make_mesh`); ``AbstractMesh`` -> :class:`AbstractMesh`, axis
  names and sizes only, no process group and no device;
* ``PartitionSpec`` -> :class:`PartitionSpec`, the same entries (a tuple
  of ``None``, an axis name or a tuple of names a tensor dimension), so a
  test compares the two packages' specs entry for entry;
* ``NamedSharding`` -> DTensor placements (:func:`placements_for`):
  ``Shard(d)`` on each mesh dimension that tensor dimension ``d`` claims,
  ``Replicate()`` on the others;
* ``with_sharding_constraint`` -> ``DTensor.redistribute``
  (:func:`constrain`; a plain tensor is returned as it is);
* ``with mesh:`` -> :class:`use_mesh`.

One difference is deliberate. A tensor dimension that claims several mesh
axes (``("data", "model", "pod")`` under ``fsdp2d`` on a
``(pod, data, model)`` mesh) is sharded by DTensor in the *mesh's* order of
those axes, where JAX shards it in the order the spec lists them. The
local shapes and the bytes every collective moves are the same; only which
rank holds which block differs (``tests/test_torch_sharding_and_roofline.py``
pins it).
"""
from __future__ import annotations

import contextlib
from typing import Dict, List, Optional, Sequence, Tuple

import torch

# logical axis -> ordered tuple of physical mesh axes it may shard over.
DEFAULT_RULES: Dict[str, Tuple[str, ...]] = {
    # activations
    "batch": ("pod", "data"),
    "seq": (),          # sequence parallelism is opt-in (see sp_rules)
    "embed": (),
    "act_heads": ("model",),
    "act_ff": ("model",),
    # params: FSDP over data, TP over model; replicated over pod
    "fsdp": ("data",),
    "tensor": ("model",),
    "vocab": ("model",),
    "heads": ("model",),
    "kv_heads": ("model",),
    "expert": ("model",),
    "layers": (),
    "conv": (),
    "state": (),
    # serving pools
    "kv_pages": ("data",),
    "page": (),
    "requests": ("data",),
}


def sp_rules(base: Optional[Dict[str, Tuple[str, ...]]] = None
             ) -> Dict[str, Tuple[str, ...]]:
    """Rules with sequence parallelism enabled (long-prefill shapes)."""
    rules = dict(base or DEFAULT_RULES)
    rules["seq"] = ("model",)
    return rules


def fsdp2d_rules() -> Dict[str, Tuple[str, ...]]:
    """Pure-FSDP (ZeRO-3) strategy: batch and parameters shard over the
    in-pod axes (data, model); the pod axis stays pure DP (params
    replicated across pods, gradients all-reduced across them). No tensor
    parallelism: for dense-model training this trades per-layer activation
    all-reduces (O(tokens·d_model) each) for per-layer weight all-gathers
    (O(params/layer)). MoE keeps fsdp_tp (experts need the model axis)."""
    rules = dict(DEFAULT_RULES)
    rules["batch"] = ("data", "model", "pod")
    rules["fsdp"] = ("data", "model")
    rules["tensor"] = ()
    rules["act_heads"] = ()
    rules["act_ff"] = ()
    rules["vocab"] = ()
    rules["expert"] = ()
    return rules


STRATEGIES = {
    "fsdp_tp": lambda: dict(DEFAULT_RULES),
    "fsdp2d": fsdp2d_rules,
}

# module-level active rules: model code calls constrain() without plumbing
# rules through every layer; the launcher scopes a strategy per cell.
_ACTIVE_RULES: Dict[str, Tuple[str, ...]] = dict(DEFAULT_RULES)


class use_rules:
    def __init__(self, rules: Dict[str, Tuple[str, ...]]):
        self.rules = rules
        self._prev = None

    def __enter__(self):
        global _ACTIVE_RULES
        self._prev = _ACTIVE_RULES
        _ACTIVE_RULES = self.rules
        return self

    def __exit__(self, *a):
        global _ACTIVE_RULES
        _ACTIVE_RULES = self._prev
        return False


# ---------------------------------------------------------------------------
# meshes
# ---------------------------------------------------------------------------

class PartitionSpec(tuple):
    """One entry a tensor dimension: ``None`` (replicated), a mesh axis
    name, or a tuple of names; the JAX ``PartitionSpec``'s entries."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


class AbstractMesh:
    """Axis names and sizes only: what :func:`spec_for` and the dry-run's
    input contract read. It needs no process group and no device, as
    JAX's ``AbstractMesh`` needs none."""

    def __init__(self, axis_shapes: Sequence[int],
                 axis_names: Sequence[str]):
        self.axis_sizes = tuple(int(s) for s in axis_shapes)
        self.axis_names = tuple(axis_names)

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        n = 1
        for s in self.axis_sizes:
            n *= s
        return n

    def __repr__(self) -> str:
        return f"AbstractMesh({self.shape})"


def abstract_mesh(axis_shapes: Sequence[int], axis_names: Sequence[str]
                  ) -> AbstractMesh:
    return AbstractMesh(axis_shapes, axis_names)


def make_mesh(axis_shapes: Sequence[int], axis_names: Sequence[str], *,
              device_type: str = "cuda"):
    """A ``DeviceMesh`` of ``axis_shapes`` named ``axis_names`` over the
    default process group, which the caller starts (its world size is the
    product of the shapes); ranks fill the mesh in row-major order, as
    ``jax.make_mesh`` fills it with devices."""
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(device_type, tuple(int(s) for s in axis_shapes),
                            mesh_dim_names=tuple(axis_names))


def mesh_axis_names(mesh) -> Tuple[str, ...]:
    """The axis names of a ``DeviceMesh`` or an :class:`AbstractMesh`."""
    if isinstance(mesh, AbstractMesh):
        return mesh.axis_names
    return tuple(mesh.mesh_dim_names)


def mesh_axis_sizes(mesh) -> Dict[str, int]:
    """``{axis name: size}`` of a ``DeviceMesh`` or an :class:`AbstractMesh`
    (JAX's ``dict(mesh.shape)``)."""
    if isinstance(mesh, AbstractMesh):
        return mesh.shape
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def mesh_size(mesh) -> int:
    n = 1
    for s in mesh_axis_sizes(mesh).values():
        n *= s
    return n


_MESHES: List = []


class use_mesh:
    """The current mesh, for code that reads it without being handed one
    (``moe_ffn``): the counterpart of JAX's ``with mesh:`` (``None``: no
    mesh, a no-op). Inside it a plain tensor that meets a DTensor in an
    operator counts as replicated on the mesh (``implicit_replication``),
    as an unsharded constant does under ``jit``; it must then hold the
    same values on every rank."""

    def __init__(self, mesh):
        self.mesh = mesh
        self._stack = contextlib.ExitStack()

    def __enter__(self):
        from torch.distributed.tensor.experimental import implicit_replication

        if self.mesh is not None:      # no mesh: nothing changes
            _MESHES.append(self.mesh)
            self._stack.enter_context(implicit_replication())
        return self.mesh

    def __exit__(self, *a):
        if self.mesh is not None:
            self._stack.close()
            _MESHES.pop()
        return False


def _current_mesh():
    return _MESHES[-1] if _MESHES else None


# ---------------------------------------------------------------------------
# rules -> specs -> placements
# ---------------------------------------------------------------------------

def spec_for(
    shape: Sequence[int],
    logical: Sequence[Optional[str]],
    mesh,
    rules: Optional[Dict[str, Tuple[str, ...]]] = None,
) -> PartitionSpec:
    """Resolve logical axes for a concrete shape into a PartitionSpec.

    A mesh axis is used at most once across the whole spec; axes are
    claimed greedily left-to-right. Non-divisible dims replicate.
    """
    rules = rules or DEFAULT_RULES
    sizes = mesh_axis_sizes(mesh)
    assert len(shape) == len(logical), (shape, logical)
    used: set = set()
    out = []
    for dim, name in zip(shape, logical):
        if name is None:
            out.append(None)
            continue
        mapped = [a for a in rules.get(name, ()) if a in sizes and a not in used]
        # claim the largest divisible prefix of the mapped axes
        claimed = []
        prod = 1
        for a in mapped:
            if dim % (prod * sizes[a]) == 0:
                claimed.append(a)
                prod *= sizes[a]
        if not claimed:
            out.append(None)
        elif len(claimed) == 1:
            out.append(claimed[0])
            used.add(claimed[0])
        else:
            out.append(tuple(claimed))
            used.update(claimed)
    return PartitionSpec(*out)


def placements_for(spec: Sequence, mesh) -> tuple:
    """DTensor placements of ``spec`` on ``mesh``: ``Shard(d)`` on every
    mesh dimension that tensor dimension ``d`` claims, ``Replicate()`` on
    the others. A dimension claiming several axes is split in the mesh's
    order of them (see the module's docstring)."""
    from torch.distributed.tensor import Replicate, Shard

    names = mesh_axis_names(mesh)
    out = [Replicate() for _ in names]
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        for a in (entry if isinstance(entry, tuple) else (entry,)):
            out[names.index(a)] = Shard(d)
    return tuple(out)


def sharding_for(
    shape: Sequence[int],
    logical: Sequence[Optional[str]],
    mesh,
    rules: Optional[Dict[str, Tuple[str, ...]]] = None,
) -> tuple:
    """The placements of :func:`spec_for` (JAX: a ``NamedSharding``)."""
    return placements_for(spec_for(shape, logical, mesh, rules), mesh)


def _tree_map2(fn, tree, axes):
    """``fn(leaf, axes_leaf)`` over nested dicts (sorted keys, as
    ``jax.tree`` flattens a dict); an axes leaf is a tuple."""
    if isinstance(tree, dict):
        return {k: _tree_map2(fn, tree[k], axes[k]) for k in sorted(tree)}
    return fn(tree, axes)


def tree_specs(abstract_tree, axes_tree, mesh, rules=None):
    """Map a tree of (meta) tensors + matching logical-axes tree to a tree
    of PartitionSpecs."""
    return _tree_map2(lambda x, ax: spec_for(x.shape, ax, mesh, rules),
                      abstract_tree, axes_tree)


def tree_shardings(abstract_tree, axes_tree, mesh, rules=None):
    """The placements of :func:`tree_specs`, leaf for leaf."""
    return _tree_map2(lambda x, ax: sharding_for(x.shape, ax, mesh, rules),
                      abstract_tree, axes_tree)


def distribute_tree(tree, shardings, mesh):
    """Every tensor of ``tree`` as a DTensor on ``mesh`` with the
    placements of ``shardings`` (a matching tree); ``requires_grad`` is
    kept."""
    from torch.distributed.tensor import distribute_tensor

    def one(x, placements):
        out = distribute_tensor(x.detach(), mesh, placements)
        return out.requires_grad_(x.requires_grad)

    return _tree_map2(one, tree, shardings)


def gather_fsdp(params, axes_tree):
    """The parameters as a step computes with them: every DTensor leaf
    redistributed so that its ``fsdp`` dims are whole (the FSDP weight
    all-gather; its backward is the reduce-scatter of the gradient) while
    the tensor-parallel dims stay sharded (under the active rules). Plain
    tensors pass unchanged."""
    rules = dict(_ACTIVE_RULES)
    rules["fsdp"] = ()

    def one(x, ax):
        if not is_distributed(x):
            return x
        pl = sharding_for(x.shape, ax, x.device_mesh, rules)
        return x if tuple(x.placements) == pl else \
            x.redistribute(x.device_mesh, pl)

    return _tree_map2(one, params, axes_tree)


def constrain(x, logical: Sequence[Optional[str]]):
    """``with_sharding_constraint`` via logical names: a DTensor is
    redistributed to the placements ``logical`` resolves to on its mesh
    under the active rules; a plain tensor (no mesh) is returned
    unchanged."""
    if not is_distributed(x):
        return x
    placements = sharding_for(x.shape, logical, x.device_mesh, _ACTIVE_RULES)
    if tuple(x.placements) == placements:
        return x
    return x.redistribute(x.device_mesh, placements)


def is_distributed(x) -> bool:
    """True for a DTensor."""
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def axis_index(mesh, axis: str) -> int:
    """This rank's coordinate along ``axis`` (JAX: ``lax.axis_index``)."""
    return mesh.get_local_rank(axis)


def all_reduce(x: torch.Tensor, op: str, mesh, axes: Sequence[str]
               ) -> torch.Tensor:
    """``x`` reduced by ``op`` (``"sum"`` or ``"max"``) over the mesh axes
    ``axes``, one functional all-reduce an axis (a sum or a max over each
    axis in turn is one over all of them). Not differentiable: see
    :func:`psum_identity_grad` for the training form."""
    import torch.distributed._functional_collectives as funcol

    for a in axes:
        x = funcol.wait_tensor(funcol.all_reduce(x, op, mesh.get_group(a)))
    return x


def all_gather(x: torch.Tensor, dim: int, mesh, axis: str) -> torch.Tensor:
    """The shards of ``x`` along ``dim`` gathered over mesh axis ``axis``
    (JAX: ``all_gather(..., tiled=True)``); differentiable, its backward a
    reduce-scatter of the gradient (the FSDP weight gather)."""
    import torch.distributed._functional_collectives as funcol

    out = funcol.all_gather_tensor_autograd(x.contiguous(), dim,
                                            mesh.get_group(axis))
    return funcol.wait_tensor(out)


class _PsumIdentityGrad(torch.autograd.Function):
    """Forward: the sum over the given axes' groups. Backward: identity.
    The output is replicated over those axes, and a replicated output's
    gradient reaches every rank whole (DTensor's ``from_local``), so each
    summand's gradient is that gradient unchanged (Megatron's
    reduce-from-parallel-region; JAX's ``psum`` under ``shard_map``)."""

    @staticmethod
    def forward(ctx, x, mesh, axes):
        return all_reduce(x, "sum", mesh, axes)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


def psum_identity_grad(x: torch.Tensor, mesh, axes: Sequence[str]
                       ) -> torch.Tensor:
    """The autograd-aware sum over ``axes`` of a ``shard_map``-style
    region (:class:`_PsumIdentityGrad`)."""
    if not axes:
        return x
    return _PsumIdentityGrad.apply(x, mesh, tuple(axes))


class _ContiguousGrad(torch.autograd.Function):
    """Identity whose backward makes the gradient contiguous."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.contiguous()


def contiguous_grad(x: torch.Tensor) -> torch.Tensor:
    """``x``, with a contiguous gradient: the local input of a
    ``local_map`` region, whose gradient DTensor then reshapes by the
    global tensor's (contiguous) strides."""
    if not x.requires_grad:
        return x
    return _ContiguousGrad.apply(x)
