"""Model configs of the port: the ``ModelConfig`` of the reference and,
in ``REGISTRY``, every architecture the reference's paged engine serves -
the dense qwen3-1.7b, qwen1.5-4b, minitron-8b, command-r-plus-104b and
the paper's hfa-paper-mini, and the MoE granite-moe-1b-a400m and
phi3.5-moe-42b-a6.6b - and the SSM mamba2-2.7b, which the reference
serves through its dense loop.  The reference's hybrid, encoder-decoder
and VLM configs are not registered (ROADMAP.md Queue 1 item 13b)."""
from repro_torch.configs.base import ModelConfig, get_config, REGISTRY  # noqa: F401
from repro_torch.configs import (  # noqa: F401
    minitron_8b,
    qwen3_1_7b,
    qwen1_5_4b,
    command_r_plus_104b,
    granite_moe_1b,
    phi3_5_moe_42b,
    hfa_paper,
    mamba2_2_7b,
)
