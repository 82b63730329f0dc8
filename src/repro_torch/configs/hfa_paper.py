"""hfa-paper-mini: Phi-3.5-mini-like dense config (the paper's own eval
model family, Table I) with the H-FA attention kernel enabled end-to-end."""
from repro_torch.configs.base import ModelConfig, register

HFA_PAPER_MINI = register(ModelConfig(
    name="hfa-paper-mini",
    family="dense",
    n_layers=32,
    d_model=3072,
    n_heads=32,
    n_kv_heads=32,
    d_head=96,
    d_ff=8192,
    vocab_size=32064,
    attn_impl="hfa_pallas",
    param_dtype="bfloat16",
))
