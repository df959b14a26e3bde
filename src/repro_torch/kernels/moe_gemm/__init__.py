from .ops import moe_expert_ffn, tc_plan
from .ref import moe_expert_ffn_ref, moe_expert_ffn_split_ref

__all__ = ["moe_expert_ffn", "moe_expert_ffn_ref", "moe_expert_ffn_split_ref",
           "tc_plan"]
