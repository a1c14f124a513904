"""Summarize a sparknet_tpu_torch metrics JSONL (loss curve tail,
step-time breakdown table, health-event audit trail). A thin runnable
wrapper over `sparknet_tpu_torch.obs.summary`, as the JAX package's
`scripts/metrics_summary.py` wraps its own:

    python -m sparknet_tpu_torch.scripts.metrics_summary run/training_metrics_*.jsonl
"""
import sys

from ..obs.summary import main

if __name__ == "__main__":
    sys.exit(main())
