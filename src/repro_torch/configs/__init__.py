"""Model configs of the port: the ``ModelConfig`` of the reference and
the architectures registered so far (qwen3-1.7b)."""
from repro_torch.configs.base import ModelConfig, get_config, REGISTRY  # noqa: F401
from repro_torch.configs import qwen3_1_7b  # noqa: F401
