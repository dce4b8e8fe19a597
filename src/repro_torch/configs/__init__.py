"""Architecture and shape registry of the port.

``get_arch(name)`` returns a ported architecture's full config,
``get_shape(name)`` one of the four assigned input shapes and
``reduced(cfg)`` a smoke-test variant. Every architecture of the JAX
package is registered. llama3-405b (405.9 B parameters) trains and
serves through the normal entry points under its plan (one model, FSDP
over ``data`` beside tensor parallelism over ``model``): reduced, or cut
in depth, on one card.
"""
from repro_torch.configs import (biglstm, hymba_1_5b, llama3_405b,
                                 llama4_maverick_400b_a17b,
                                 llama_3_2_vision_11b, mamba2_370m,
                                 minitron_4b, phi3_5_moe_42b_a6_6b,
                                 phi4_mini_3_8b, qwen2_7b,
                                 seamless_m4t_large_v2)
from repro_torch.configs.base import (ModelConfig, OptimizerConfig,
                                      ParallelismPlan, ShapeConfig,
                                      SyncConfig, reduced)
from repro_torch.configs.shapes import SHAPES, get_shape

#: architectures the port can build.
ARCHS = {m.CONFIG.name: m.CONFIG for m in (
    llama4_maverick_400b_a17b, mamba2_370m, seamless_m4t_large_v2, qwen2_7b,
    minitron_4b, phi4_mini_3_8b, llama_3_2_vision_11b, phi3_5_moe_42b_a6_6b,
    hymba_1_5b, biglstm, llama3_405b)}

#: the JAX package's architectures that the port does not build yet.
NOT_PORTED = ()


def get_arch(name: str) -> ModelConfig:
    if name in ARCHS:
        return ARCHS[name]
    if name in NOT_PORTED:
        raise NotImplementedError(
            f"arch {name!r} is not ported to PyTorch yet; ported: "
            f"{sorted(ARCHS)}")
    raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)}")


__all__ = ["ARCHS", "SHAPES", "ModelConfig", "OptimizerConfig",
           "ParallelismPlan", "ShapeConfig", "SyncConfig", "get_arch",
           "get_shape", "reduced"]
