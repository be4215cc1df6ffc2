"""Core configuration types shared across the framework.

Every architecture (dense / MoE / SSM / hybrid / enc-dec / VLM backbone) is
described by a single ``ModelConfig``; the evaluation grid's input shapes
(``ShapeSpec``), logical meshes (``MeshSpec``) and cells (``RunShape``)
are plain Python, copied from the JAX package's.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Architecture description. Field semantics follow the assignment table."""

    name: str
    family: str  # dense | moe | ssm | hybrid | encdec | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 -> d_model // num_heads

    # --- MoE ---
    num_experts: int = 0
    num_shared_experts: int = 0
    top_k: int = 0
    expert_d_ff: int = 0
    # experts padded up so EP divides the model axis
    expert_pad_to: int = 0
    router_aux_coef: float = 0.001

    # --- SSM / hybrid ---
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    # hymba: sliding-window size for local-attention layers; layers in
    # ``global_attn_layers`` use full attention.
    window: int = 0
    global_attn_layers: Tuple[int, ...] = ()
    # xlstm: one sLSTM block every `slstm_every` blocks (rest mLSTM)
    slstm_every: int = 0

    # --- enc-dec (whisper) ---
    enc_layers: int = 0
    enc_frames: int = 0  # precomputed frame embeddings from the conv stub

    # --- vlm (internvl) ---
    img_tokens: int = 0  # precomputed patch embeddings from the ViT stub

    # --- common knobs ---
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    act: str = "swiglu"  # swiglu | gelu
    # minicpm depth/width residual scaling (mu-p style)
    residual_scale: float = 1.0
    embed_scale: float = 1.0
    logit_soft_cap: float = 0.0
    qk_norm: bool = False  # qwen3-style
    # --- the port's own, beyond the JAX package's fields (defaults: its
    # behaviour) ---
    # qwen2-style bias on the q, k and v projections (bq, bk, bv)
    qkv_bias: bool = False
    # False: a MoE router keeps its top-k softmax probabilities as they
    # are (qwen2-moe's norm_topk_prob false); True renormalises them
    norm_topk: bool = True

    # training schedule hint (minicpm uses WSD)
    lr_schedule: str = "cosine"  # cosine | wsd

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)
        assert self.num_heads % max(self.num_kv_heads, 1) == 0, self.name

    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim

    @property
    def padded_experts(self) -> int:
        if self.num_experts == 0:
            return 0
        return max(self.num_experts, self.expert_pad_to or self.num_experts)

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def has_full_attention(self) -> bool:
        """True if any layer uses unwindowed full attention (quadratic)."""
        if self.family == "ssm":
            return False
        if self.family == "hybrid":
            # hymba keeps a few global-attention layers but is dominated by
            # sliding window + SSM -> sub-quadratic treatment per assignment.
            return False
        return True

    def param_count(self) -> int:
        """Approximate parameter count (exact for our implementations)."""
        from repro_torch.models.registry import count_params_from_config

        return count_params_from_config(self)

    def active_param_count(self) -> int:
        """Parameters a token reaches: a ``moe`` config's ``top_k`` routed
        experts, not all of them."""
        from repro_torch.models.registry import count_params_from_config

        return count_params_from_config(self, active_only=True)


#: the fields ``ModelConfig`` has beyond the JAX package's, at the defaults
#: that keep its behaviour (every registry arch leaves them there)
PORT_ONLY_DEFAULTS = {"qkv_bias": False, "norm_topk": True}


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    """One input-shape point from the assignment."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode

    @property
    def is_serve(self) -> bool:
        return self.kind in ("prefill", "decode")


TRAIN_4K = ShapeSpec("train_4k", 4096, 256, "train")
PREFILL_32K = ShapeSpec("prefill_32k", 32768, 32, "prefill")
DECODE_32K = ShapeSpec("decode_32k", 32768, 128, "decode")
LONG_500K = ShapeSpec("long_500k", 524288, 1, "decode")
ALL_SHAPES = (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)
SHAPES_BY_NAME = {s.name: s for s in ALL_SHAPES}


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """Logical device-mesh description (axis names × sizes)."""

    shape: Tuple[int, ...]
    axes: Tuple[str, ...]

    @property
    def num_devices(self) -> int:
        n = 1
        for s in self.shape:
            n *= s
        return n

    def axis_size(self, name: str) -> int:
        if name not in self.axes:
            return 1
        return self.shape[self.axes.index(name)]


SINGLE_POD = MeshSpec((16, 16), ("data", "model"))
MULTI_POD = MeshSpec((2, 16, 16), ("pod", "data", "model"))


@dataclasses.dataclass(frozen=True)
class RunShape:
    """A fully-resolved (arch, shape, mesh) cell of the evaluation grid."""

    arch: str
    shape: ShapeSpec
    mesh: MeshSpec

    @property
    def cell(self) -> str:
        pod = "multipod" if "pod" in self.mesh.axes else "singlepod"
        return f"{self.arch}/{self.shape.name}/{pod}"
