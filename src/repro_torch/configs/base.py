"""Model/architecture configuration system (the port's copy of
``repro/configs/base.py``, unchanged: the port imports nothing of ``repro``).

Every assigned architecture is a ``ModelCfg`` built from a repeating layer
``pattern`` (tuple of LayerSpec).  Heterogeneous stacks (gemma2 local/global,
recurrentgemma R-R-A, xlstm 7:1) scan over the pattern period so the lowered
HLO is O(period), not O(n_layers); the remainder (n_layers % period) is
unrolled.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    """One layer position inside the repeating pattern."""
    mixer: str = "attn"        # attn | mla | rglru | mlstm | slstm
    ffn: str = "mlp"           # mlp | moe | none
    window: Optional[int] = None  # sliding-window size for local attention
    cross_attn: bool = False   # decoder cross-attention (whisper)


@dataclasses.dataclass(frozen=True)
class MoECfg:
    num_experts: int
    top_k: int
    d_expert: int              # per-expert FFN hidden size
    num_shared: int = 0        # shared (always-on) experts (deepseek)
    d_shared: int = 0          # hidden size of the fused shared-expert MLP
    capacity_factor: float = 1.25
    norm_topk: bool = True


@dataclasses.dataclass(frozen=True)
class MLACfg:
    kv_lora_rank: int = 512
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class EncDecCfg:
    enc_layers: int
    enc_seq: int               # fixed encoder length (whisper: 1500 frames)


@dataclasses.dataclass(frozen=True)
class VLMCfg:
    num_image_tokens: int      # stub frontend: precomputed patch embeddings


@dataclasses.dataclass(frozen=True)
class RecurrentCfg:
    d_rnn: int = 0             # RG-LRU width (0 -> d_model)
    conv_width: int = 4
    mlstm_proj_factor: float = 2.0  # xLSTM mLSTM block up-projection


@dataclasses.dataclass(frozen=True)
class ModelCfg:
    name: str
    family: str                # dense | moe | hybrid | ssm | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab: int
    pattern: tuple[LayerSpec, ...] = (LayerSpec(),)
    prelude: tuple[LayerSpec, ...] = ()  # unrolled layers before the scan group

    # attention options
    rope_theta: float = 10_000.0
    use_rope: bool = True
    qk_norm: bool = False
    qkv_bias: bool = False
    attn_softcap: float = 0.0      # gemma2: 50.0
    final_softcap: float = 0.0     # gemma2: 30.0
    query_scale: Optional[float] = None  # override 1/sqrt(head_dim)
    parallel_block: bool = False   # command-r: attn & ffn in parallel
    post_norms: bool = False       # gemma2 sandwich norms

    # misc
    act: str = "silu"              # silu | gelu
    norm: str = "rmsnorm"          # rmsnorm | layernorm
    tie_embeddings: bool = True
    embed_scale: bool = False      # gemma: x *= sqrt(d_model)
    norm_eps: float = 1e-6

    moe: Optional[MoECfg] = None
    mla: Optional[MLACfg] = None
    encdec: Optional[EncDecCfg] = None
    vlm: Optional[VLMCfg] = None
    rnn: RecurrentCfg = RecurrentCfg()

    # training
    param_dtype: str = "float32"
    activation_dtype: str = "bfloat16"
    attn_chunk: int = 1024         # q-chunk for blockwise attention
    remat: bool = True             # the reference's; the port keeps no remat
    # The reference's cost-probe mode (its XLA dry run unrolls the layer
    # scan so cost analysis sees every FLOP).  The port runs every layer
    # eagerly and its dry run (launch/dryrun.py) counts each product as it
    # runs, so nothing reads this flag there.
    unroll_scans: bool = False
    # Causal flash attention through kernel 3 (csrc/flash_attention.cu) in
    # the serving steps.  Off in the configs, so the dry run traces the
    # plain attention, as the reference's dry run lowers it.
    use_flash_kernel: bool = False

    # whether attention is sub-quadratic end-to-end (pure local/recurrent) —
    # gates the long_500k shape (DESIGN.md §5)
    subquadratic: bool = False

    def with_(self, **kw) -> "ModelCfg":
        return dataclasses.replace(self, **kw)

    @property
    def period(self) -> int:
        return len(self.pattern)

    @property
    def n_patterned(self) -> int:
        return self.n_layers - len(self.prelude)

    @property
    def n_scan_periods(self) -> int:
        return self.n_patterned // self.period

    @property
    def n_remainder(self) -> int:
        return self.n_patterned % self.period

    def layer_specs(self) -> list[LayerSpec]:
        return list(self.prelude) + [self.pattern[i % self.period]
                                     for i in range(self.n_patterned)]


@dataclasses.dataclass(frozen=True)
class ShapeCfg:
    """One assigned input-shape cell."""
    name: str                  # train_4k | prefill_32k | decode_32k | long_500k
    kind: str                  # train | prefill | decode
    seq_len: int
    global_batch: int


TRAIN_4K = ShapeCfg("train_4k", "train", 4_096, 256)
PREFILL_32K = ShapeCfg("prefill_32k", "prefill", 32_768, 32)
DECODE_32K = ShapeCfg("decode_32k", "decode", 32_768, 128)
LONG_500K = ShapeCfg("long_500k", "decode", 524_288, 1)

ALL_SHAPES = (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)


def shapes_for(cfg: ModelCfg) -> list[ShapeCfg]:
    """The live shape cells for an arch (long_500k needs sub-quadratic
    attention — DESIGN.md §5 skip table)."""
    out = [TRAIN_4K, PREFILL_32K, DECODE_32K]
    if cfg.subquadratic:
        out.append(LONG_500K)
    return out


def smoke_config(cfg: ModelCfg) -> ModelCfg:
    """Reduced same-family config for CPU smoke tests: same pattern/features,
    tiny dims."""
    kw = dict(
        # prelude + two scanned periods + a remainder layer iff the full
        # config has one
        n_layers=(len(cfg.prelude) + 2 * cfg.period
                  + (1 if cfg.n_remainder else 0)),
        d_model=64,
        n_heads=4,
        n_kv_heads=min(cfg.n_kv_heads, 2) if cfg.n_kv_heads < cfg.n_heads else 4,
        head_dim=16,
        d_ff=128 if cfg.d_ff else 0,
        vocab=256,
        attn_chunk=32,
    )
    if cfg.moe:
        kw["moe"] = dataclasses.replace(cfg.moe, num_experts=8, top_k=2,
                                        d_expert=32,
                                        d_shared=64 if cfg.moe.num_shared else 0)
    if cfg.mla:
        kw["mla"] = MLACfg(kv_lora_rank=32, qk_nope_dim=16, qk_rope_dim=8,
                           v_head_dim=16)
    if cfg.encdec:
        kw["encdec"] = EncDecCfg(enc_layers=2, enc_seq=24)
    if cfg.vlm:
        kw["vlm"] = VLMCfg(num_image_tokens=8)
    if cfg.rnn.d_rnn:
        kw["rnn"] = dataclasses.replace(cfg.rnn, d_rnn=64)
    # shrink local windows below the smoke seq-len
    if any(s.window for s in cfg.pattern):
        kw["pattern"] = tuple(
            dataclasses.replace(s, window=16) if s.window else s
            for s in cfg.pattern)
    return cfg.with_(**kw)
