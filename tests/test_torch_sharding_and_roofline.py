"""The port's sharding rules and roofline against the JAX package's.

Twins of ``tests/test_sharding_and_roofline.py`` (its HLO-text tests
become tests of the op counter, ``roofline/op_analysis``), then every
arch held against ``repro``: the specs of every parameter leaf on
``SINGLE_POD`` and ``MULTI_POD`` under both strategies, ``param_axes``,
``decode_layout``, ``input_specs`` (shapes and dtypes),
``plan_decode_sharding``, ``model_flops`` and ``matmul_params``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

import repro.configs as jconfigs
import repro_torch.configs as tconfigs
from repro.common import sharding as jsh
from repro.common import types as jtypes
from repro.models import attention as jattn
from repro.models import registry as jreg
from repro.roofline import analysis as jan
from repro_torch.common import types as ttypes
from repro_torch.common.sharding import (
    DEFAULT_RULES,
    STRATEGIES,
    P,
    abstract_mesh,
    fsdp2d_rules,
    placements_for,
    spec_for,
    tree_specs,
)
from repro_torch.models import attention as tattn
from repro_torch.models import registry as treg
from repro_torch.roofline import analysis as tan
from repro_torch.roofline import hw
from repro_torch.roofline.op_analysis import (
    OpCounter,
    collective_bytes,
    tensor_bytes,
)

ARCHS = list(tconfigs.ARCHS)
SHAPES = [s.name for s in ttypes.ALL_SHAPES]
MESHES = {"single": (ttypes.SINGLE_POD, jtypes.SINGLE_POD),
          "multi": (ttypes.MULTI_POD, jtypes.MULTI_POD)}


def _mesh(shape=(2, 4), axes=("data", "model")):
    return abstract_mesh(shape, axes)


class TestSpecFor:
    def test_divisible_shards(self):
        m = _mesh()
        assert spec_for((8, 64), ("batch", None), m) == P("data", None)
        assert spec_for((16, 32), ("fsdp", "tensor"), m) == P("data", "model")

    def test_non_divisible_replicates(self):
        m = _mesh()
        # 6 % 4 != 0 -> tensor dim replicated rather than erroring
        assert spec_for((16, 6), ("fsdp", "tensor"), m) == P("data", None)
        assert spec_for((3, 6), ("fsdp", "tensor"), m) == P(None, None)

    def test_axis_used_once(self):
        m = _mesh()
        # both dims map to 'model': only the first claims it
        spec = spec_for((8, 8), ("tensor", "act_heads"), m)
        assert spec == P("model", None)

    def test_multi_axis_claim(self):
        m = _mesh((2, 4), ("pod", "data"))
        spec = spec_for((8, 4), ("batch", None), m)
        assert spec == P(("pod", "data"), None)

    def test_fsdp2d_prefix_divisibility(self):
        m = _mesh((2, 16, 16), ("pod", "data", "model"))
        r = fsdp2d_rules()
        # batch 256 claims (data, model) = 256 but NOT pod (256 % 512 != 0)
        assert spec_for((256, 128), ("batch", None), m, r) == \
            P(("data", "model"), None)


def test_multi_axis_claim_is_split_in_the_mesh_order():
    """A dim claiming ``("data", "model", "pod")`` (fsdp2d's batch) on a
    ``(pod, data, model)`` mesh: DTensor shards it over all three axes in
    the mesh's order, JAX in the spec's. Each rank's block has the same
    size; the rank holding a block differs (rank (pod=1, data=0,
    model=0) holds block 1 under JAX's order, block 256 under the mesh's)."""
    from torch.distributed.tensor import Replicate, Shard

    m = _mesh((2, 16, 16), ("pod", "data", "model"))
    spec = spec_for((1024, 8), ("batch", None), m, fsdp2d_rules())
    assert spec == P(("data", "model", "pod"), None)
    assert placements_for(spec, m) == (Shard(0), Shard(0), Shard(0))
    assert placements_for(P(None, "model"), m) == (Replicate(), Replicate(),
                                                    Shard(1))
    sizes = m.shape

    def block(coords, order):
        idx = 0
        for a in order:
            idx = idx * sizes[a] + coords[a]
        return idx

    coords = {"pod": 1, "data": 0, "model": 0}
    assert block(coords, ("data", "model", "pod")) == 1          # JAX
    assert block(coords, ("pod", "data", "model")) == 256        # DTensor
    assert 1024 // (2 * 16 * 16) == 2                            # both


# ---------------------------------------------------------------------------
# the op counter (the HLO analyzer's twin)
# ---------------------------------------------------------------------------

class TestOpCounter:
    def test_tensor_bytes(self):
        assert tensor_bytes(torch.empty(4, 8)) == 128
        assert tensor_bytes(torch.empty(10, dtype=torch.bfloat16)) == 20
        assert tensor_bytes(torch.empty(7, dtype=torch.bool)) == 7
        assert tensor_bytes(torch.empty(3, dtype=torch.int32)) == 12

    def test_collective_bytes_ring_model(self):
        naive, ring = collective_bytes("all-gather", 64 * 64 * 4, 8)
        assert naive == 64 * 64 * 4 // 8
        assert ring == 64 * 64 * 4 * 7 // 8

    def test_loop_of_products_counts_each_iteration(self):
        """FLOPs of a looped matmul scale with the loop's length (Python
        loops unroll: no trip-count correction)."""
        w = torch.randn(7, 32, 32)
        x = torch.randn(16, 32)
        with OpCounter() as oc:
            for i in range(7):
                x = torch.tanh(x @ w[i])
            x.sum()
        expected = 7 * 2 * 16 * 32 * 32
        assert oc.costs.flops == expected

    def test_sin_then_product(self):
        x = torch.randn(32, 32)
        with OpCounter() as oc:
            torch.sin(x) @ x.T
        assert oc.costs.flops >= 2 * 32 * 32 * 32
        assert oc.costs.hbm_bytes > 0


@pytest.fixture
def fake_group():
    """Rank 0 of a 4-rank fake process group, destroyed after the test."""
    from repro_torch.launch.dryrun import fake_process_group

    with fake_process_group(4):
        yield


def test_counter_counts_the_local_shard(fake_group):
    """A ``Shard(0)`` product on a 4-way mesh counts a quarter of the
    FLOPs; gathering its result counts one all-gather's ring bytes."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.common.sharding import make_mesh

    mesh = make_mesh((4,), ("data",), device_type="cpu")
    a = distribute_tensor(torch.randn(64, 32), mesh, [Shard(0)])
    b = distribute_tensor(torch.randn(32, 16), mesh, [Replicate()])
    with OpCounter() as oc:
        c = a @ b
    assert oc.costs.flops == 2 * 64 * 32 * 16 // 4
    assert oc.costs.collective_count == 0
    with OpCounter() as oc:
        c.redistribute(mesh, [Replicate()])
    assert oc.costs.collective_count == 1
    assert oc.costs.collective_ring == 64 * 16 * 4 * 3 // 4


class TestModelFlops:
    def test_dense_train_close_to_6nd(self):
        cfg = tconfigs.get_config("phi3-mini-3.8b")
        mf = tan.model_flops(cfg, ttypes.TRAIN_4K)
        n = tan.matmul_params(cfg)
        tokens = 256 * 4096
        assert mf > 6 * n * tokens  # attention + logits on top
        assert mf < 6 * n * tokens * 1.8


def test_h100_row():
    """The roofline's device is the H100 SXM: bfloat16 989 TFLOP/s dense,
    3.35 TB/s, 80 GB, NVLink 450 GB/s a direction."""
    assert hw.PEAK_FLOPS_BF16 == 989e12
    assert hw.HBM_BW == 3.35e12
    assert hw.HBM_BYTES == 80e9
    assert hw.NVLINK_BW == 450e9
    assert hw.IB_BW == 50e9
    assert not hasattr(hw, "ICI_LINK_BW")


# ---------------------------------------------------------------------------
# every arch against the JAX package
# ---------------------------------------------------------------------------

def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_leaves(tree[k], f"{prefix}{k}/"))
        return out
    return {prefix.rstrip("/"): tree}


def _jspecs(tree):
    return {k: tuple(v) for k, v in _leaves(
        jax.tree.map(lambda s: s, tree, is_leaf=lambda x: isinstance(x, JP))
    ).items()}


@pytest.mark.parametrize("arch", ARCHS)
def test_param_axes_match_jax(arch):
    tm = treg.build_model(tconfigs.get_config(arch))
    jm = jreg.build_model(jconfigs.get_config(arch))
    t = _leaves(tm.param_axes())
    j = {k: tuple(v) for k, v in _leaves(jax.tree.map(
        lambda a: a, jm.param_axes(),
        is_leaf=lambda x: isinstance(x, tuple))).items()}
    assert t == j
    tshapes = {k: tuple(v.shape) for k, v in
               _leaves(tm.abstract_params(torch.bfloat16)).items()}
    jshapes = {k: tuple(v.shape) for k, v in
               _leaves(jm.abstract_params(jnp.bfloat16)).items()}
    assert tshapes == jshapes
    assert all(v.dtype == torch.bfloat16 and v.device.type == "meta"
               for v in _leaves(tm.abstract_params(torch.bfloat16)).values())


@pytest.mark.parametrize("strategy", sorted(STRATEGIES))
@pytest.mark.parametrize("pod", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_tree_specs_match_jax(arch, pod, strategy):
    """Every parameter leaf's spec equals the JAX package's."""
    tspec, jspec = MESHES[pod]
    tm = treg.build_model(tconfigs.get_config(arch))
    jm = jreg.build_model(jconfigs.get_config(arch))
    tmesh = abstract_mesh(tspec.shape, tspec.axes)
    jmesh = jsh.abstract_mesh(jspec.shape, jspec.axes)
    t = tree_specs(tm.abstract_params(), tm.param_axes(), tmesh,
                   STRATEGIES[strategy]())
    j = jsh.tree_specs(jm.abstract_params(), jm.param_axes(), jmesh,
                       jsh.STRATEGIES[strategy]())
    assert {k: tuple(v) for k, v in _leaves(t).items()} == _jspecs(j)


def test_rules_match_jax():
    assert DEFAULT_RULES == jsh.DEFAULT_RULES
    for name in STRATEGIES:
        assert STRATEGIES[name]() == jsh.STRATEGIES[name]()


def _spec_tree(tree):
    if isinstance(tree, dict):
        return {k: _spec_tree(v) for k, v in sorted(tree.items())}
    return (tuple(tree.shape), str(tree.dtype).split(".")[-1])


@pytest.mark.parametrize("pod", sorted(MESHES))
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_layouts_and_input_specs_match_jax(arch, shape, pod):
    """``decode_layout``, ``input_specs`` (shapes and dtypes) and
    ``plan_decode_sharding`` equal the JAX package's."""
    tspec, jspec = MESHES[pod]
    tcfg, jcfg = tconfigs.get_config(arch), jconfigs.get_config(arch)
    ts = ttypes.SHAPES_BY_NAME[shape]
    js = jtypes.SHAPES_BY_NAME[shape]
    assert treg.decode_layout(tcfg, ts, tspec) == \
        jreg.decode_layout(jcfg, js, jspec)
    t = _spec_tree(treg.input_specs(tcfg, ts, tspec))
    j = _spec_tree(jreg.input_specs(jcfg, js, jspec))
    assert t == j
    assert all(v.device.type == "meta" for v in _leaves(
        treg.input_specs(tcfg, ts, tspec)).values())
    tplan = tattn.plan_decode_sharding(
        ts.global_batch, abstract_mesh(tspec.shape, tspec.axes))
    jplan = jattn.plan_decode_sharding(
        js.global_batch, jsh.abstract_mesh(jspec.shape, jspec.axes))
    assert tplan == jplan
    assert tattn.num_combine_shards(abstract_mesh(tspec.shape, tspec.axes),
                                    tplan[1]) == \
        jattn.num_combine_shards(jsh.abstract_mesh(jspec.shape, jspec.axes),
                                 jplan[1])


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_model_flops_match_jax(arch, shape):
    tcfg, jcfg = tconfigs.get_config(arch), jconfigs.get_config(arch)
    assert tan.matmul_params(tcfg) == jan.matmul_params(jcfg)
    assert tan.model_flops(tcfg, ttypes.SHAPES_BY_NAME[shape]) == \
        jan.model_flops(jcfg, jtypes.SHAPES_BY_NAME[shape])


def test_roofline_terms_divide_by_the_h100_row():
    from repro_torch.roofline.op_analysis import OpCosts

    c = OpCosts(flops=989_000_000_000, hbm_bytes=3_350_000_000,
                collective_ring=45_000_000)
    t = tan.roofline_terms(c, 2 * 989e9, 2)
    assert t.compute_s == pytest.approx(1e-3)
    assert t.memory_s == pytest.approx(1e-3)
    assert t.collective_s == pytest.approx(1e-4)
    assert t.useful_ratio == pytest.approx(1.0)
    assert np.isclose(t.hlo_flops_device, 989e9)
