"""Training substrate of the port: optimizer, data pipeline,
checkpointing (the port of ``repro/training``)."""
from .optimizer import (adamw_init, adamw_update, cosine_lr,
                        global_grad_norm)

__all__ = ["adamw_init", "adamw_update", "cosine_lr", "global_grad_norm"]
