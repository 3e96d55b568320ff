"""The ten assigned architectures (the port's copy of
``repro/configs/archs.py``, data unchanged; sources noted per entry, see
DESIGN.md §5 for mapping decisions).  The port serves ``qwen3-0.6b``; the
others are here so that configs compare like with like."""

from __future__ import annotations

from repro_torch.configs.base import (EncDecCfg, LayerSpec, MLACfg,
                                      ModelCfg, MoECfg, RecurrentCfg,
                                      VLMCfg)

_dense = (LayerSpec(mixer="attn", ffn="mlp"),)


# [vlm] hf:llava-hf/llava-v1.6 (34B backbone); anyres tiling -> stub frontend
LLAVA_NEXT_34B = ModelCfg(
    name="llava-next-34b", family="vlm", n_layers=60, d_model=7168,
    n_heads=56, n_kv_heads=8, head_dim=128, d_ff=20480, vocab=64000,
    pattern=_dense, rope_theta=5_000_000.0, tie_embeddings=False,
    vlm=VLMCfg(num_image_tokens=576),
)

# [dense] hf:CohereForAI/c4ai-command-r-plus; GQA kv=8, no-bias, parallel block
COMMAND_R_PLUS_104B = ModelCfg(
    name="command-r-plus-104b", family="dense", n_layers=64, d_model=12288,
    n_heads=96, n_kv_heads=8, head_dim=128, d_ff=33792, vocab=256000,
    pattern=_dense, rope_theta=75_000_000.0, parallel_block=True,
    qk_norm=True, tie_embeddings=True, norm="layernorm", norm_eps=1e-5,
)

# [dense] arXiv:2408.00118; local+global alternating, logit softcaps
GEMMA2_2B = ModelCfg(
    name="gemma2-2b", family="dense", n_layers=26, d_model=2304,
    n_heads=8, n_kv_heads=4, head_dim=256, d_ff=9216, vocab=256000,
    pattern=(LayerSpec(mixer="attn", ffn="mlp", window=4096),
             LayerSpec(mixer="attn", ffn="mlp")),
    act="gelu", attn_softcap=50.0, final_softcap=30.0,
    query_scale=256.0 ** -0.5, post_norms=True, tie_embeddings=True,
    embed_scale=True,
)

# [dense] hf:Qwen/Qwen3-0.6B; qk_norm, GQA
QWEN3_0_6B = ModelCfg(
    name="qwen3-0.6b", family="dense", n_layers=28, d_model=1024,
    n_heads=16, n_kv_heads=8, head_dim=128, d_ff=3072, vocab=151936,
    pattern=_dense, rope_theta=1_000_000.0, qk_norm=True,
    tie_embeddings=True,
)

# [dense] hf:Qwen/CodeQwen1.5-7B; qwen1.5 arch (MHA kv=32, qkv bias)
CODEQWEN15_7B = ModelCfg(
    name="codeqwen1.5-7b", family="dense", n_layers=32, d_model=4096,
    n_heads=32, n_kv_heads=32, head_dim=128, d_ff=13440, vocab=92416,
    pattern=_dense, rope_theta=1_000_000.0, qkv_bias=True,
    tie_embeddings=False,
)

# [audio] arXiv:2212.04356; enc-dec, conv frontend STUB (frame embeddings)
WHISPER_LARGE_V3 = ModelCfg(
    name="whisper-large-v3", family="audio", n_layers=32, d_model=1280,
    n_heads=20, n_kv_heads=20, head_dim=64, d_ff=5120, vocab=51866,
    pattern=(LayerSpec(mixer="attn", ffn="mlp", cross_attn=True),),
    use_rope=False, act="gelu", norm="layernorm", tie_embeddings=True,
    encdec=EncDecCfg(enc_layers=32, enc_seq=1500),
)

# [hybrid] arXiv:2402.19427 (Griffin); RG-LRU + local attn, 1 attn : 2 rec
RECURRENTGEMMA_2B = ModelCfg(
    name="recurrentgemma-2b", family="hybrid", n_layers=26, d_model=2560,
    n_heads=10, n_kv_heads=1, head_dim=256, d_ff=7680, vocab=256000,
    pattern=(LayerSpec(mixer="rglru", ffn="mlp"),
             LayerSpec(mixer="rglru", ffn="mlp"),
             LayerSpec(mixer="attn", ffn="mlp", window=2048)),
    act="gelu", tie_embeddings=True, embed_scale=True,
    rnn=RecurrentCfg(d_rnn=2560, conv_width=4),
    subquadratic=True,
)

# [moe] hf:Qwen/Qwen3-30B-A3B; 128 experts top-8
QWEN3_MOE_30B_A3B = ModelCfg(
    name="qwen3-moe-30b-a3b", family="moe", n_layers=48, d_model=2048,
    n_heads=32, n_kv_heads=4, head_dim=128, d_ff=768, vocab=151936,
    pattern=(LayerSpec(mixer="attn", ffn="moe"),),
    rope_theta=1_000_000.0, qk_norm=True, tie_embeddings=False,
    moe=MoECfg(num_experts=128, top_k=8, d_expert=768),
)

# [moe] arXiv:2405.04434 (DeepSeek-V2-Lite); MLA kv_lora=512, layer-0 dense,
# 64 routed top-6 + 2 shared (assignment text ambiguity resolved per
# DESIGN.md §8)
DEEPSEEK_V2_LITE_16B = ModelCfg(
    name="deepseek-v2-lite-16b", family="moe", n_layers=27, d_model=2048,
    n_heads=16, n_kv_heads=16, head_dim=128, d_ff=10944, vocab=102400,
    # layer 0 is a dense-FFN MLA layer (prelude); layers 1-26 are MLA + MoE
    pattern=(LayerSpec(mixer="mla", ffn="moe"),),
    prelude=(LayerSpec(mixer="mla", ffn="mlp"),),
    rope_theta=10_000.0, tie_embeddings=False,
    moe=MoECfg(num_experts=64, top_k=6, d_expert=1408, num_shared=2,
               d_shared=2816),
    mla=MLACfg(kv_lora_rank=512, qk_nope_dim=128, qk_rope_dim=64,
               v_head_dim=128),
)

# [ssm] arXiv:2405.04517; mLSTM:sLSTM 7:1
XLSTM_350M = ModelCfg(
    name="xlstm-350m", family="ssm", n_layers=24, d_model=1024,
    n_heads=4, n_kv_heads=4, head_dim=256, d_ff=0, vocab=50304,
    pattern=tuple([LayerSpec(mixer="mlstm", ffn="none")] * 7
                  + [LayerSpec(mixer="slstm", ffn="none")]),
    use_rope=False, tie_embeddings=False,
    rnn=RecurrentCfg(conv_width=4, mlstm_proj_factor=2.0),
    subquadratic=True,
)

ARCHS: dict[str, ModelCfg] = {c.name: c for c in [
    LLAVA_NEXT_34B, COMMAND_R_PLUS_104B, GEMMA2_2B, QWEN3_0_6B,
    CODEQWEN15_7B, WHISPER_LARGE_V3, RECURRENTGEMMA_2B, QWEN3_MOE_30B_A3B,
    DEEPSEEK_V2_LITE_16B, XLSTM_350M,
]}
