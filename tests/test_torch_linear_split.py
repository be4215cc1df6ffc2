"""The numerics of the CUDA ``linear_f32`` (the prefill's float32
projections on the tensor cores), on the CPU, and the kernel on the card.

The kernel (``csrc/linear_f32.cu``) takes ``x [R, K] @ w [K, N]`` as three
TF32 products of each operand's hi and lo halves (the emulation of
``_tf32_emulation.py``), each 32-deep k-tile into zeroed accumulators,
the tiles' partial sums added in float32 in k order. On the CPU this file
holds, at phi4-mini's seven projection shapes (K 3072 and 8192; N 1024,
3072 and 8192) and data drawn as ``perfbench/weights.py`` draws the
weights (normal, standard deviation 1 / sqrt(fan-in)), that the split
product lies within the JAX package's bar (``atol = rtol = 1e-4``) of a
float64 product where one TF32 pass does not, and that the kernel's order
of additions, replayed, does too.

The card tests (they skip without a CUDA device) hold the kernel to a
float64 product at those shapes and hymba's ragged widths, within 4x
``torch.matmul``'s float32 error and 50x below one TF32 pass's; its
wrapper's refusals; and the prefill's routing: one ``TransformerLM``
prefill launches it for each per-layer projection, a decode step never."""
import numpy as np
import pytest
import torch

from _tf32_emulation import mm_one_pass, mm_split, split
from repro_torch.kernels import linear_f32 as klin
from repro_torch.kernels import ops

BAR = dict(atol=1e-4, rtol=1e-4)
ROWS = 192
BK = 32                                  # the kernel's k-tile
D, Q, KV, FF = 3072, 3072, 1024, 8192    # phi4-mini-3.8b's widths
#: (projection, K, N) of a phi4-mini layer, in the prefill's order
SHAPES = [("wq", D, Q), ("wk", D, KV), ("wv", D, KV), ("wo", Q, D),
          ("w_gate", D, FF), ("w_up", D, FF), ("w_down", FF, D)]
#: hymba-1.5b's ragged widths: d_model 1600 into itself and into 320
RAGGED = [("hymba_wq", 1600, 1600), ("hymba_wk", 1600, 320)]


def _inputs(seed, rows, k, n):
    """x ~ N(0, 1) (a normed activation) and w ~ N(0, 1 / K), float32."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((rows, k)).astype(np.float32)
    w = (rng.standard_normal((k, n)) / np.sqrt(k)).astype(np.float32)
    return torch.from_numpy(x), torch.from_numpy(w)


def _exact(x, w):
    return x.double() @ w.double()


def _err(got, want) -> float:
    return float((got.double() - want).abs().max())


def k_tile_order(x, w):
    """``x @ w`` as the kernel adds it: each k-tile's three TF32 products
    exactly (float64), rounded to float32, and the tiles' partial sums
    added in float32 in k order."""
    (xh, xl), (wh, wl) = split(x), split(w)
    d = torch.float64
    total = None
    for k0 in range(0, x.shape[1], BK):
        sl = slice(k0, k0 + BK)
        part = (xl[:, sl].to(d) @ wh[sl].to(d) + xh[:, sl].to(d) @ wl[sl].to(d)
                + xh[:, sl].to(d) @ wh[sl].to(d)).float()
        total = part if total is None else total + part
    return total


@pytest.mark.parametrize("name,k,n", SHAPES, ids=[s[0] for s in SHAPES])
def test_split_holds_the_bar_where_one_pass_does_not(name, k, n):
    """The split product lies within 1e-4 of a float64 product; one TF32
    pass misses it and lies at least 10x farther."""
    x, w = _inputs(11, ROWS, k, n)
    want = _exact(x, w)
    three, one = mm_split(x, w), mm_one_pass(x, w)
    assert torch.allclose(three.double(), want, **BAR), _err(three, want)
    assert not torch.allclose(one.double(), want, **BAR)
    assert _err(one, want) >= 10 * _err(three, want)


@pytest.mark.parametrize("name,k,n", SHAPES[3:],
                         ids=[s[0] for s in SHAPES[3:]])
def test_k_tile_order_holds_the_bar(name, k, n):
    """The kernel's order of additions (32-deep k-tiles, their partial sums
    in float32 in k order) stays within the bar of a float64 product, and
    within float32 rounding of the split product summed exactly."""
    x, w = _inputs(12, ROWS, k, n)
    want = _exact(x, w)
    got = k_tile_order(x, w)
    assert torch.allclose(got.double(), want, **BAR), _err(got, want)
    assert _err(got, mm_split(x, w).double()) < 1e-5


# ---- on the card ------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel runs only there")
    return torch.device("cuda")


@pytest.mark.parametrize("rows", [1, 17, 1000, 5120])
@pytest.mark.parametrize("name,k,n", SHAPES + RAGGED,
                         ids=[s[0] for s in SHAPES + RAGGED])
def test_kernel_against_float64(card, name, k, n, rows):
    """At most 4x torch.matmul's float32 error from a float64 product, and
    at least 50x below one TF32 pass's."""
    x, w = (t.to(card) for t in _inputs(rows + k + n, rows, k, n))
    assert not torch.backends.cuda.matmul.allow_tf32
    want = _exact(x, w)
    got = ops.linear_f32(x, w)
    torch.cuda.synchronize()
    err = _err(got, want)
    assert err <= 4 * _err(torch.matmul(x, w), want), err
    assert 50 * err <= _err(mm_one_pass(x, w), want), err


def test_kernel_on_leading_dims_and_views(card):
    """``[B, S, K]`` inputs and a layer's view of stacked weights, as the
    prefill passes them."""
    x, w = _inputs(5, 2 * 40, 256, 3 * 96)
    stacked = w.reshape(256, 3, 96).permute(1, 0, 2).contiguous()
    x, stacked = x.reshape(2, 40, 256).to(card), stacked.to(card)
    got = ops.linear_f32(x, stacked[1])
    want = _exact(x, stacked[1])
    assert got.shape == (2, 40, 96)
    assert _err(got, want) <= 4 * _err(torch.matmul(x, stacked[1]), want)


def test_wrapper_refuses(card):
    x, w = (t.to(card) for t in _inputs(3, 8, 64, 32))
    with pytest.raises(TypeError):
        ops.linear_f32(x.bfloat16(), w.bfloat16())
    with pytest.raises(ValueError, match="contiguous"):
        ops.linear_f32(x, w.t().contiguous().t())
    with pytest.raises(RuntimeError, match="requires grad"):
        ops.linear_f32(x, w.clone().requires_grad_())
    with pytest.raises(ValueError, match="multiples of 4"):
        ops.linear_f32(x[:, :62].contiguous(), w[:62].contiguous())


def test_prefill_routes_its_projections(card):
    """A Libra prefill of a small dense config launches the kernel 7 times
    a layer (wq, wk, wv, wo, w_gate, w_up, w_down), and so does the
    baselines' ``prefill_dense``; its decode steps never do, and
    torch.matmul stays in full float32."""
    from repro_torch.common.types import ModelConfig
    from repro_torch.models.registry import build_model
    from repro_torch.serving.engine import LibraEngine

    cfg = ModelConfig(name="tiny-dense", family="dense", num_layers=2,
                      d_model=128, num_heads=4, num_kv_heads=2, head_dim=32,
                      d_ff=256, vocab_size=512, act="swiglu")
    model = build_model(cfg, page_size=16)
    params = model.init_params(3, device=card)
    eng = LibraEngine(model, params, max_batch=2, max_len=64, page_size=16,
                      device=card)
    calls = []

    def counted(kind, fn):
        def call(*a, **kw):
            n0 = klin.LAUNCHES["linear_f32"]
            out = fn(*a, **kw)
            calls.append((kind, klin.LAUNCHES["linear_f32"] - n0))
            return out
        return call
    model.prefill = counted("prefill", model.prefill)
    model.decode_step = counted("decode", model.decode_step)
    rng = np.random.default_rng(0)
    for n in (40, 23):
        eng.submit(rng.integers(1, 500, n).astype(np.int32),
                   max_new_tokens=3)
    eng.run()
    assert calls[0] == ("prefill", 7 * cfg.num_layers)
    assert len(calls) > 1
    assert calls[1:] == [("decode", 0)] * (len(calls) - 1)
    # the baselines' prefill too
    n0 = klin.LAUNCHES["linear_f32"]
    tokens = torch.from_numpy(rng.integers(1, 500, (2, 32)).astype(np.int32))
    model.prefill_dense(params, tokens.to(card),
                        torch.tensor([32, 20], dtype=torch.int32,
                                     device=card), 48)
    assert klin.LAUNCHES["linear_f32"] - n0 == 7 * cfg.num_layers
    assert not torch.backends.cuda.matmul.allow_tf32
