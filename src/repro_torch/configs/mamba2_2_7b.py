"""mamba2-2.7b: attention-free SSD [arXiv:2405.21060; unverified].

H-FA is inapplicable (no softmax).  The decode state is O(1) in the
sequence length.  The reference's paged engine does not serve it, so the
serving CLIs fall back to the dense fixed-batch loop.
"""
from repro_torch.configs.base import ModelConfig, register

MAMBA2_2_7B = register(ModelConfig(
    name="mamba2-2.7b",
    family="ssm",
    n_layers=64,
    d_model=2560,
    n_heads=0,
    n_kv_heads=0,
    d_head=0,
    d_ff=0,
    vocab_size=50280,
    m_expand=2,
    m_headdim=64,
    m_dstate=128,
    m_conv=4,
    param_dtype="bfloat16",
))
