"""Architecture registry of the port.

``get_arch(name)`` returns a ported architecture's full config and
``reduced(cfg)`` its smoke-test variant. Only the paper's Big LSTM is
ported so far; the JAX package's other architectures raise.
"""
from repro_torch.configs import biglstm
from repro_torch.configs.base import (ModelConfig, OptimizerConfig,
                                      ShapeConfig, SyncConfig, reduced)

#: architectures the port can build.
ARCHS = {biglstm.CONFIG.name: biglstm.CONFIG}

#: the JAX package's architectures that the port does not build yet.
NOT_PORTED = (
    "llama4-maverick-400b-a17b", "mamba2-370m", "seamless-m4t-large-v2",
    "qwen2-7b", "llama3-405b", "minitron-4b", "phi4-mini-3.8b",
    "llama-3.2-vision-11b", "hymba-1.5b", "phi3.5-moe-42b-a6.6b",
)


def get_arch(name: str) -> ModelConfig:
    if name in ARCHS:
        return ARCHS[name]
    if name in NOT_PORTED:
        raise NotImplementedError(
            f"arch {name!r} is not ported to PyTorch yet (ROADMAP Queue 1: "
            "transformer families, SSM); ported: " f"{sorted(ARCHS)}")
    raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)}")


__all__ = ["ARCHS", "ModelConfig", "OptimizerConfig", "ShapeConfig",
           "SyncConfig", "get_arch", "reduced"]
