"""Configuration dataclasses of the PyTorch port.

The same fields and defaults as the JAX package's configs, so one set of
numbers describes a run in either framework. One name differs:
``OptimizerConfig.use_kernels`` is the counterpart of ``use_pallas`` —
``True`` runs the hand-written CUDA kernels' numerics (the fused update and
the one-pass error-feedback encode), ``False`` the plain per-worker
``local_step`` numerics.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

Family = str  # 'dense' | 'moe' | 'ssm' | 'audio' | 'vlm' | 'hybrid' | 'lstm'


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Architecture hyper-parameters (transformer backbone or LSTM)."""

    name: str
    family: Family
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                      # 0 -> d_model // n_heads
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    act: str = "swiglu"                    # 'swiglu' | 'gelu' | 'relu'
    # --- MoE ---
    n_experts: int = 0                     # 0 -> dense FFN
    top_k: int = 1
    moe_every: int = 1                     # MoE layer every k-th layer
    dense_d_ff: int = 0                    # FFN width of non-MoE layers (0 -> d_ff)
    shared_expert: bool = False            # llama4-style always-on shared expert
    capacity_factor: float = 1.25
    router_aux_loss: float = 0.01
    # --- SSM (mamba2 / SSD) ---
    ssm_state: int = 0                     # N (state dim); 0 -> no SSM path
    ssm_expand: int = 2                    # d_inner = expand * d_model
    ssm_head_dim: int = 64
    ssm_chunk: int = 64                    # SSD chunk length
    ssm_conv: int = 4                      # depthwise conv width
    # --- hybrid (hymba): both attn and ssm paths in parallel ---
    hybrid: bool = False
    # --- enc-dec (audio) ---
    n_encoder_layers: int = 0              # >0 -> encoder-decoder model
    # --- VLM ---
    cross_attn_every: int = 0              # >0 -> cross-attn layer every k-th layer
    n_image_tokens: int = 0                # patch-embedding tokens per sample
    # --- attention variants ---
    sliding_window: int = 0                # 0 -> full causal attention
    long_context_mode: str = ""            # '' | 'sliding_window' | 'ssm'
    # --- LSTM (paper's Big LSTM) ---
    lstm_proj: int = 0                     # LSTM-2048-512 projection size
    # --- beyond-paper performance knobs of the transformer families ---
    attn_tp_pad: bool = False
    attn_remat: bool = False
    fused_xent: bool = False
    moe_group_tokens: bool = False
    seq_parallel: bool = False
    attn_bf16_probs: bool = False
    expert_axes_2d: bool = False
    ssm_pallas: bool = False
    # --- numerics ---
    param_dtype: str = "bfloat16"
    accum_dtype: str = "float32"
    # provenance
    source: str = ""                       # citation for the config

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // max(self.n_heads, 1))
        if self.n_experts and self.dense_d_ff == 0:
            object.__setattr__(self, "dense_d_ff", self.d_ff)

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    @property
    def is_encdec(self) -> bool:
        return self.n_encoder_layers > 0

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def n_ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim if self.ssm_state else 0

    def param_count(self) -> int:
        """Analytic parameter count, as the reference counts it (exact but
        for the hybrid layer's fourth norm, see ``models/counting.py``)."""
        from repro_torch.models.counting import count_params
        return count_params(self)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One input shape: sequence length and global batch."""

    name: str
    seq_len: int
    global_batch: int
    kind: str                              # 'train' | 'prefill' | 'decode'

    @property
    def is_decode(self) -> bool:
        return self.kind == "decode"


@dataclasses.dataclass(frozen=True)
class SyncConfig:
    """Everything about the sync round, in one block (core/sync_engine.py).

    The *when* (policy), the *what* (wire codec), and the *how* (fused vs
    three-pass error-feedback encode) of the communication rounds.
    """

    # 'fixed_h'  -> sync every H-th step;
    # 'adaptive' -> sync once the drift accumulated since the last sync
    #               crosses threshold, never before h_min local steps,
    #               always by h_max (0 -> 4·H).
    policy: str = "fixed_h"
    threshold: float = 0.0
    h_min: int = 1
    h_max: int = 0
    # 'update_norm' (relative parameter movement per step) or
    # 'grad_staleness' (relative ‖g_t − g_last_sync‖²)
    drift_metric: str = "update_norm"
    # ''/'fp32' | 'bf16' | 'int8' (per-block int8 + fp32 scales)
    compression: str = ""
    block: int = 256                       # elements per quantization block
    # one-pass EF encode (kernels/sync_fused.py) instead of three passes
    fused: bool = True


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    """Paper algorithms 1-4 plus plain SGD.

    The sync round is read through the :class:`SyncConfig` view
    (``cfg.sync``); the flat field names below are its storage, so
    ``dataclasses.replace`` works on them. :meth:`from_sync` constructs
    from an explicit block.
    """

    name: str = "local_adaalter"           # 'sgd'|'adagrad'|'adaalter'|'local_sgd'|'local_adaalter'
    lr: float = 0.5                        # paper default (8 workers x bs 256)
    eps: float = 1.0                       # paper: eps = 1
    b0: float = 1.0                        # paper: b0 = 1
    H: int = 4                             # paper's best comm/noise trade-off
    warmup_steps: int = 600                # paper: 600
    grad_clip: float = 0.0                 # global-norm clip; 0 -> off
    use_kernels: bool = False              # fused CUDA update + EF kernels
    # flat parameter plane (core/flatspace.py): params and optimizer state
    # packed into a few aligned fp32 planes at init; a step is one update
    # launch over the plane and a sync round one EF encode per half and one
    # mean. Train state bitwise equal to the per-leaf layout under the same
    # schedule. local_adaalter only; needs eps > 0.
    flat: bool = False
    # observability (obs/): the steps also return the raw gradients' L2
    # norm (``metrics['grad_norm']``). Off by default, so an uninstrumented
    # run computes nothing extra; train_loop turns it on under
    # ``trace_out`` / ``metrics_out``.
    obs_metrics: bool = False
    # --- flat aliases of the SyncConfig block (read ``cfg.sync`` instead) ---
    sync_policy: str = "fixed_h"
    sync_threshold: float = 0.0
    h_min: int = 1
    h_max: int = 0
    drift_metric: str = "update_norm"
    compression: str = ""
    compression_block: int = 256
    sync_fused: bool = True

    #: SyncConfig field -> flat OptimizerConfig alias.
    _SYNC_ALIASES = {
        "policy": "sync_policy", "threshold": "sync_threshold",
        "h_min": "h_min", "h_max": "h_max", "drift_metric": "drift_metric",
        "compression": "compression", "block": "compression_block",
        "fused": "sync_fused",
    }

    def __post_init__(self):
        # the zero slot padding of the flat planes stays zero through the
        # update only because eps > 0 keeps rsqrt(B² + t'·eps²) finite there
        if self.flat and self.eps <= 0:
            raise ValueError(
                "flat mode requires eps > 0: FlatSpace's zero slot padding "
                "survives the update only because rsqrt(B² + t'·eps²) stays "
                f"finite on zero pads (got eps={self.eps!r})")

    @property
    def sync(self) -> SyncConfig:
        """The sync-round configuration as one coherent block."""
        return SyncConfig(**{k: getattr(self, alias)
                             for k, alias in self._SYNC_ALIASES.items()})

    @classmethod
    def from_sync(cls, sync: SyncConfig, **kwargs) -> "OptimizerConfig":
        """Construct with an explicit :class:`SyncConfig` block; ``kwargs``
        are the non-sync fields (``name``, ``lr``, ``H``, ...)."""
        return cls(**{alias: getattr(sync, k)
                      for k, alias in cls._SYNC_ALIASES.items()}, **kwargs)


@dataclasses.dataclass(frozen=True)
class ParallelismPlan:
    """How the mesh axes are used for a given (arch, shape).

    local_axes : mesh axes enumerating local-SGD workers (replicas diverge
                 between syncs; synced every H steps by Local AdaAlter).
    grad_axes  : mesh axes over which gradients are pmean'd EVERY step
                 (classic data parallelism inside a worker).
    fsdp_axes  : mesh axes over which each worker's params/optimizer state
                 are sharded (ZeRO-3); must be a subset of grad_axes.
    tp_axis    : tensor-parallel axis name.

    In the port the mesh is a grid of ranks (``launch/mesh.py``): its
    ``data`` axis the workers, its ``model`` axis the shards of a worker;
    ``n_workers`` takes the axes' sizes. What decides something in the
    port: ``local_axes`` (the workers) and ``grad_axes`` (the synchronous
    gradient mean) of a run with ranks; ``tp_axis``, down which a flat
    plane splits into sub-planes, one a rank
    (``sharding.partition.plane_shard_axes``), and a per-leaf run splits
    its weights (tensor parallelism, ``sharding.partition.
    TensorParallel``); and ``remat``, the
    rematerialisation of the transformer groups in training
    (``models/transformer.py::apply_stack``); ``fsdp_axes``, over which a
    one-model run splits each leaf and its state (FSDP,
    ``launch/steps.py::_leaf_programs``, leaf by leaf as
    ``sharding.specs.param_shardings`` says, beside tensor parallelism
    over ``model``: tiles); ``weight_gather_serving`` (serving above 20 B
    parameters: each rank's tiles at rest, a layer group's parts gathered
    over ``data`` as it runs, ``launch/serving.py::WeightGather``).
    """

    local_axes: Tuple[str, ...] = ("data",)
    grad_axes: Tuple[str, ...] = ()
    fsdp_axes: Tuple[str, ...] = ()
    tp_axis: str = "model"
    weight_gather_serving: bool = False
    remat: str = "none"                    # 'none' | 'full' | 'dots'

    def n_workers(self, mesh_shape: Dict[str, int]) -> int:
        n = 1
        for ax in self.local_axes:
            n *= mesh_shape[ax]
        return n


def reduced(cfg: ModelConfig, *, n_layers: int = 2, d_model: int = 256,
            max_experts: int = 4, vocab: int = 512) -> ModelConfig:
    """A smoke-test-sized member of the same architecture family (the JAX
    package's ``configs.base.reduced``, field for field)."""
    n_heads = max(4, min(cfg.n_heads, 8))
    n_kv = n_heads if cfg.n_kv_heads == cfg.n_heads else max(1, n_heads // 4)
    head_dim = max(16, d_model // n_heads)
    d_model = n_heads * head_dim
    changes = dict(
        n_layers=n_layers,
        d_model=d_model,
        n_heads=n_heads,
        n_kv_heads=n_kv,
        head_dim=head_dim,
        d_ff=4 * d_model if cfg.d_ff else 0,
        dense_d_ff=4 * d_model if cfg.dense_d_ff else 0,
        vocab_size=vocab,
        n_experts=min(cfg.n_experts, max_experts),
        n_encoder_layers=n_layers if cfg.is_encdec else 0,
        cross_attn_every=2 if cfg.cross_attn_every else 0,
        n_image_tokens=16 if cfg.cross_attn_every else 0,
        ssm_state=min(cfg.ssm_state, 16) if cfg.ssm_state else 0,
        ssm_head_dim=32 if cfg.ssm_state else 64,
        ssm_chunk=16 if cfg.ssm_state else 64,
        sliding_window=min(cfg.sliding_window, 64) if cfg.sliding_window else 0,
        lstm_proj=min(cfg.lstm_proj, 64) if cfg.lstm_proj else 0,
        moe_every=cfg.moe_every,
        name=cfg.name + "-smoke",
    )
    return dataclasses.replace(cfg, **changes)
