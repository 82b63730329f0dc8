"""qwen1.5-4b: QKV bias, MHA-style GQA kv=20 [hf:Qwen/Qwen1.5 family; hf].

Note: 20 heads do not divide a 16-way model axis; the reference's TPU
sharding rules degrade head sharding to replication for this arch.  The
port's paged tensor parallelism takes any tp that divides the 20 KV heads
(2, 4, 5, ...; ``serving/engine.py::check_parallel``).
"""
from repro_torch.configs.base import ModelConfig, register

QWEN1_5_4B = register(ModelConfig(
    name="qwen1.5-4b",
    family="dense",
    n_layers=40,
    d_model=2560,
    n_heads=20,
    n_kv_heads=20,
    d_head=128,
    d_ff=6912,
    vocab_size=151936,
    qkv_bias=True,
    attn_impl="fa2",
    param_dtype="bfloat16",
))
