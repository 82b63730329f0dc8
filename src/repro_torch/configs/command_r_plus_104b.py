"""command-r-plus-104b: large dense GQA, no biases [hf:CohereForAI; unverified]."""
from repro_torch.configs.base import ModelConfig, register

COMMAND_R_PLUS_104B = register(ModelConfig(
    name="command-r-plus-104b",
    family="dense",
    n_layers=64,
    d_model=12288,
    n_heads=96,
    n_kv_heads=8,
    d_head=128,
    d_ff=33792,
    vocab_size=256000,
    attn_impl="fa2",
    param_dtype="bfloat16",
    optimizer="adafactor",   # >= 100B: factored second moment
    microbatches=4,
))
