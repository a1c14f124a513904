"""Observability: the metrics registry, the host-side span tracer, request
tracing, the status server, run metadata, the pod view, and the SLO
ledger — the metrics history (`history`: multi-resolution rings, JSONL
shards, /timeseries) and the burn-rate alerter over it (`slo`:
/slo/status, the fleet's page escalation, retrospective reports).

The device telemetry (`device`: the card's memory gauges and the
process-wide compile-event record, `note_compile` /
`attach_compile_metrics`, with the warm-up cache's verdict) and
`summary`, the `sparknet-metrics` JSONL reader
(`python -m sparknet_tpu_torch.obs.summary`).

Exports the names `sparknet_tpu.obs` exports for the SLO ledger and the
compile-event record."""
from .device import (DeviceTelemetry, attach_compile_metrics, compile_stats,
                     note_compile, timed_compile)
from .history import HistoryConfig, MetricsHistory, read_history_shards
from .slo import BurnRateAlerter, SloSpec, build_report

__all__ = [
    "DeviceTelemetry", "attach_compile_metrics", "compile_stats",
    "note_compile", "timed_compile",
    "HistoryConfig", "MetricsHistory", "read_history_shards",
    "BurnRateAlerter", "SloSpec", "build_report",
]
