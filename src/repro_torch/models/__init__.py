from .common import GQAPlan, ModelConfig, plan_gqa
from .transformer import (ArchPlan, DenseLM, decode_step, forward_lm,
                          init_cache, init_params, make_plan, seed_cache)

__all__ = ["ModelConfig", "GQAPlan", "plan_gqa", "ArchPlan", "DenseLM",
           "make_plan", "init_params", "forward_lm", "init_cache",
           "seed_cache", "decode_step"]
