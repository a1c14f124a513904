"""`sparknet_tpu_torch.batch` — bulk inference at fleet scale
(SparkNet's FeaturizerApp grown from a single-process demo into a fleet
workload). The counterpart of `sparknet_tpu/batch/`: the same manifest,
part objects, JSONL rows, counters and CLI flags, over the port's
binary client and serving replicas.

A batch job is a dataset swept through the serving fleet as a SCAVENGER
tenant: every request goes out `priority=low`, `tenant=batch`, so the
admission stack (serve/admission.py) sheds it FIRST whenever online
traffic needs the capacity — the job soaks idle cycles, it never buys
them at the online SLO's expense. The fleet side of the bargain lives in
fleet/policy.py: scavenger backlog is excluded from the autoscaler's
demand signals (the fleet must not grow to chase work that exists to
fill slack), and a `batch_starvation_s` clock bounds how long sustained
pressure may keep the door welded shut.

  - `manifest.py`: the work-unit plan + resumable job manifest with
    manifest-LAST commit semantics (the sharded-checkpoint writers'
    rule): each unit's `part-*.npz` is fully written before the
    `MANIFEST.json` row that makes it count, so a kill -9 at ANY point
    resumes from completed units only — never a torn or double row.
  - `store.py`: one read/write/exists surface over local paths and
    gs:// | s3:// buckets (riding the data/gcs.py, data/s3.py clients;
    local writes are temp+rename atomic to match the buckets' atomic
    object semantics).
  - `driver.py`: the `sparknet-batch` console entry
    (`python -m sparknet_tpu_torch.batch.driver`) — shards the input
    into units, dispatches them across the replica fleet over the
    binary transport (chunked streaming replies), retries unit failures
    with full jitter on a DIFFERENT replica (a replica death mid-unit
    is a retry, not a job failure), and reports fleet-aggregate rows/s
    and cost-per-million-embeddings.
"""
from .driver import BatchConfig, BatchDriver, main
from .manifest import (MANIFEST_NAME, load_manifest, new_manifest,
                       part_name, pending_units, plan_units,
                       save_manifest)
from .store import (delete, exists, is_bucket, join, list_names,
                    read_bytes, write_bytes)

__all__ = [
    "BatchConfig", "BatchDriver", "main",
    "MANIFEST_NAME", "plan_units", "new_manifest", "load_manifest",
    "save_manifest", "pending_units", "part_name",
    "read_bytes", "write_bytes", "exists", "delete", "list_names",
    "join", "is_bucket",
]
