"""phi3.5-moe-42b-a6.6b: 16 experts top-2, every layer
[hf:microsoft/Phi-3.5-MoE-instruct; hf].

Closest family to the paper's own Phi-3.5 accuracy evaluation; this is the
default arch for the H-FA representative perf cell.
"""
from repro_torch.configs.base import ModelConfig, register

PHI3_5_MOE_42B = register(ModelConfig(
    name="phi3.5-moe-42b-a6.6b",
    family="moe",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_head=128,
    d_ff=6400,
    vocab_size=32064,
    n_experts=16,
    moe_top_k=2,
    moe_every=1,
    attn_impl="fa2",
    param_dtype="bfloat16",
))
