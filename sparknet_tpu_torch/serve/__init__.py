"""Serving: dynamic batching, bucket padding, checkpoint hot reload (under
the fleet's rollout gate when one is set), int8 weight-only serving, the
multi-model router over a shared pool (remote replicas, hedging,
coalesced formation, the SLO ledger), the HTTP and binary frame data
planes (with the shared-memory transport) behind tenant and priority
admission, and the serve CLI (with `--autoscale`: the fleet control
plane of `sparknet_tpu_torch.fleet`).

Exports the names `sparknet_tpu.serve` exports; the fleet's and the SLO
ledger's names live in `sparknet_tpu_torch.fleet` and
`sparknet_tpu_torch.obs`, as in the JAX package."""
from ..model.quant import QuantConfig
from .admission import (PRIORITIES, PriorityAdmission, PriorityShedError,
                        TenantAdmission, TenantLimitError,
                        parse_priority)
from .batcher import (DeadlineExpiredError, DynamicBatcher,
                      QueueFullError, RequestCancelledError,
                      ServeRequest)
from .binary_frontend import BinaryClient, BinaryFrontend, binary_infer
from .buckets import derive_buckets, fill_ratio, size_hist_from_jsonl
from .http_frontend import BackendAdapter, HttpFrontend, http_infer
from .model_manager import ModelManager, ServeModelError
from .router import (ModelRouter, NoReplicaError, Replica, RouterConfig,
                     UnknownModelError, heartbeat_fill, heartbeat_health)
from .server import (OUTPUTS_KEY, InferenceServer, ServeConfig,
                     encode_outputs, parity_batch, pop_outputs,
                     zeros_batch)
from .wire import WireError

__all__ = [
    "DynamicBatcher", "QueueFullError", "DeadlineExpiredError",
    "RequestCancelledError", "ServeRequest",
    "ModelManager", "ServeModelError",
    "InferenceServer", "ServeConfig", "zeros_batch", "parity_batch",
    "OUTPUTS_KEY", "encode_outputs", "pop_outputs",
    "QuantConfig", "derive_buckets", "fill_ratio", "size_hist_from_jsonl",
    "ModelRouter", "RouterConfig", "Replica", "NoReplicaError",
    "UnknownModelError", "heartbeat_health", "heartbeat_fill",
    "HttpFrontend", "http_infer", "BackendAdapter",
    "BinaryFrontend", "BinaryClient", "binary_infer", "WireError",
    "TenantAdmission", "TenantLimitError",
    "PriorityAdmission", "PriorityShedError", "PRIORITIES",
    "parse_priority",
]
