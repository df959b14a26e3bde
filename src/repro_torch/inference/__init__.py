from .disagg import DisaggCoordinator, DisaggMetrics, PrefillPool
from .engine import GenerationResult, InferenceEngine
from .faults import FaultInjector, FaultPlan
from .kv_cache import BundleIntegrityError, KVBundle
from .router import Router, RouterMetrics
from .scheduler import ContinuousBatcher, Request, ServeMetrics
from .spec import (ReplicaSpec, ServeSpec, SpecError, build_engine,
                   build_prefill_pool, build_replica, make_injector)

__all__ = ["InferenceEngine", "GenerationResult", "ContinuousBatcher",
           "Request", "ServeMetrics", "FaultPlan", "FaultInjector",
           "KVBundle", "BundleIntegrityError", "PrefillPool",
           "DisaggCoordinator", "DisaggMetrics", "Router", "RouterMetrics",
           "ReplicaSpec", "ServeSpec", "SpecError", "build_engine",
           "build_prefill_pool", "build_replica", "make_injector"]
