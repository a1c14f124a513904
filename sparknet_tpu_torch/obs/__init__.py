"""Observability: the metrics registry, the host-side span tracer, request
tracing, the status server, run metadata, the pod view, and the SLO
ledger — the metrics history (`history`: multi-resolution rings, JSONL
shards, /timeseries) and the burn-rate alerter over it (`slo`:
/slo/status, the fleet's page escalation, retrospective reports).

Exports the names `sparknet_tpu.obs` exports for the SLO ledger."""
from .history import HistoryConfig, MetricsHistory, read_history_shards
from .slo import BurnRateAlerter, SloSpec, build_report

__all__ = [
    "HistoryConfig", "MetricsHistory", "read_history_shards",
    "BurnRateAlerter", "SloSpec", "build_report",
]
