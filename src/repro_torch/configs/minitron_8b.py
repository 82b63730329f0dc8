"""minitron-8b: width-pruned Nemotron-4 [arXiv:2407.14679; hf]."""
from repro_torch.configs.base import ModelConfig, register

MINITRON_8B = register(ModelConfig(
    name="minitron-8b",
    family="dense",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_head=128,
    d_ff=16384,
    vocab_size=256000,
    attn_impl="fa2",
    param_dtype="bfloat16",
))
