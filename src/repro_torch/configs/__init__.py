"""Architecture and shape registry of the port.

``get_arch(name)`` returns a ported architecture's full config,
``get_shape(name)`` one of the four assigned input shapes and
``reduced(cfg)`` a smoke-test variant. The paper's Big LSTM, mamba2-370m
and the dense decoders (qwen2-7b, phi4-mini-3.8b, minitron-4b) are ported
so far; the JAX package's other architectures raise.
"""
from repro_torch.configs import (biglstm, mamba2_370m, minitron_4b,
                                 phi4_mini_3_8b, qwen2_7b)
from repro_torch.configs.base import (ModelConfig, OptimizerConfig,
                                      ShapeConfig, SyncConfig, reduced)
from repro_torch.configs.shapes import SHAPES, get_shape

#: architectures the port can build.
ARCHS = {m.CONFIG.name: m.CONFIG for m in (
    mamba2_370m, qwen2_7b, minitron_4b, phi4_mini_3_8b, biglstm)}

#: the JAX package's architectures that the port does not build yet.
NOT_PORTED = (
    "llama4-maverick-400b-a17b", "seamless-m4t-large-v2", "llama3-405b",
    "llama-3.2-vision-11b", "hymba-1.5b", "phi3.5-moe-42b-a6.6b",
)


def get_arch(name: str) -> ModelConfig:
    if name in ARCHS:
        return ARCHS[name]
    if name in NOT_PORTED:
        raise NotImplementedError(
            f"arch {name!r} is not ported to PyTorch yet (ROADMAP Queue 1 "
            "item 10: MoE, VLM and audio families, then hymba; llama3-405b "
            "with item 9, several devices); ported: "
            f"{sorted(ARCHS)}")
    raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)}")


__all__ = ["ARCHS", "SHAPES", "ModelConfig", "OptimizerConfig",
           "ShapeConfig", "SyncConfig", "get_arch", "get_shape", "reduced"]
