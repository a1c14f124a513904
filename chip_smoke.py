#!/usr/bin/env python3
"""Chip smoke of the PyTorch/CUDA port: does the port serve and train
CaffeNet on the card, through the ImageNet app from JPEG shards too,
cached and streamed, from a directory and from a bucket, watched by its
telemetry, through the loss of a worker, behind an HTTP port that
hot-reloads a training step under traffic, with per-shard checkpoints, a
host trace, the profiler and the relaunch supervisor, behind a router
with a remote replica over the binary wire and shared memory, as a
fleet that grows, rolls out, heals and shrinks itself on its SLO, and as
a bulk-inference job over two replicas that share a warm-up cache,
with ZeRO state sharding and the logical checkpoint layout, and does it
train and serve a serialized AlexNet graph (the second backend) and serve
CaffeNet from raw pixels, does its sequence-parallel attention hold
exact attention at a 32k-token context, and are its convergence
studies' rounds the trainer's rounds?

Run from the root of a checkout on a machine with one CUDA card:

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero before the result line:

1. Environment: the card's name and power limit (nvidia-smi), the torch and
   CUDA versions; then every CUDA kernel of the port is built from
   `sparknet_tpu_torch/csrc/` (one nvcc per source, all at once: lrn_fwd,
   lrn_bwd, maxpool_bwd), with each kernel's ptxas line.
2. Kernel vs plain: `lrn_fwd` at CaffeNet's serve shapes (norm1 27x27x96,
   norm2 13x13x256, buckets 1, 8 and 128, float32 and bfloat16) against the
   plain PyTorch version on the same inputs, bit for bit (the kernel repeats
   the plain version's operations in its order). Each case prints its max
   abs error and its times (CUDA events over many launches after warm-up,
   cycling through enough inputs to exceed the 50 MB L2): kernel, plain
   version, `F.local_response_norm` (the library yardstick, which the port
   never calls) and the bound (bytes over 3.35 TB/s vs operations over 67
   TFLOP/s f32, whichever is larger). These times are host-paced, so a call shorter
   than its wrapper's Python shows the host's launch rate; the kernel is
   also timed with its calls back to back on the card (`device_ms`: calls
   queued while a sleep kernel holds the stream), and the host's time to
   queue one of those calls is `host_ms`.
2b. The training kernels against their plain versions, same inputs, one
   line per case with the same timings (the library yardstick of a
   backward is a backward-only `torch.autograd.grad` over a graph of
   `F.local_response_norm` / `F.max_pool2d` built once):
   - `lrn_fwd` with the scale output at norm1/norm2 for batches 100 and
     256, float32 and bfloat16: y bit-equal to the y-only call and to the
     plain version, the scale bit-equal to the plain version's;
   - `lrn_bwd` in both modes (saved scale, recomputed scale) at the same
     shapes: bit-equal to its plain version;
   - `maxpool_bwd` at CaffeNet's pool1/pool2/pool5 for batch 256,
     cifar10_quick's ceil-mode pool1 (100, 32, 32, 32) -> 16x16 and one
     pad > 0 shape, float32 and bfloat16, on tie-heavy inputs (a few
     integer levels, clipped at 0), and pool1/2/5 in bfloat16 also on
     dense ones (ReLU of a Gaussian): bit-equal to its plain version, and
     the positions that receive gradient equal the plain version's.
   No tolerance is needed: each kernel repeats its plain version's
   operations in the same order, so any difference fails.
3. Serve: full-width CaffeNet (crop 227, 1000 classes) with seeded random
   weights on the card behind the port's InferenceServer, buckets
   (1, 8, 64, 128), outputs ("prob",). Launch counters are zeroed, then a
   lone request, a burst of 128, a burst of 40 and four steady bursts of
   128 are served; the counters are read after. Checks: every future
   resolves; every prob row is finite, of shape (1000,) and sums to 1
   within 1e-4; buckets 1 and 128 were served; lrn_fwd launched twice per
   forward; the burst of 128 matches a forward of the same rows with the
   plain LRN selected (OpsImpl(lrn="plain")) within atol 1e-6 / rtol 1e-4;
   and two requests match a CPU forward of the same net and weights within
   atol 1e-5 (convolution sum order differs between cuDNN and the CPU).
   Then one bucket-128 forward is profiled (host stacking, host->device
   copy, device kernels by name, the share of the forward's wall time in
   which no kernel ran).
4. Train: `apps.train_loop.train` on the card in a world of one, with
   full-width CaffeNet (`zoo.caffenet(batch=256, crop=227,
   n_classes=1000)`) under the ImageNet app's solver and bfloat16, τ = 5,
   6 rounds, on seeded int8 images (mean-subtracted pixel range), one
   evaluation at round 0. Launch counters are zeroed before and read
   after. Checks: every round's loss and health finite, nonfinite == 0;
   the params moved; lrn_fwd, lrn_bwd (recompute mode) and maxpool_bwd
   launched exactly 2, 2 and 3 times per step (plus lrn_fwd's 2 for the
   evaluation forward), no scale output written. Then one float32 round
   at local batch 100, where the saved-scale route runs (2 scale-writing
   lrn_fwd and 2 lrn_bwd per step); then the same 6 bfloat16 rounds with
   pool_impl="plain" for the pool route A/B (each route's first round is
   its warm-up; the median of the other 5 and their spread); then, on one
   fixed float32 batch of 256 and the dropout-free net, the gradients of
   the kernel
   route (OpsImpl()) against the plain route (OpsImpl(lrn="plain",
   pool="plain")), with cuDNN's deterministic algorithms for this
   comparison: per tensor, a relative L2 error within 1e-6 plus twice
   that of two runs of the plain route (cuDNN and cuBLAS may still sum in
   another order from run to run; the kernels themselves are bit-equal to
   their plain versions). Prints per-round wall time, img/s, peak device
   memory, the pool route A/B, and one profiled training step.
5. Checkpoint: the same CaffeNet, solver, bfloat16 and τ = 5 through
   `apps.train_loop.train` with `checkpoint_dir` (every 2 rounds) in a
   world of one, on other seeded images, with cuDNN's deterministic
   algorithms for the whole phase:
   - 4 rounds with synchronous writes;
   - 2 rounds with async writes, then a second `train()` that resumes
     to round 4: every param and momentum tensor torch.equal to the
     first run's, equal step-4 digests, every step verifies;
   - a `.caffemodel` of the first run's params through
     `TorchNet.save_weights` and `load_weights` into a fresh net: its
     bucket-128 float32 forward equal to the source net's bit for bit;
   - 6 rounds with the health supervisor and a NaN injected at round 3:
     exactly one rollback (to step 2, retry 1, lr_scale = lr_backoff),
     every later round finite with nonfinite 0, finite final params,
     and the steps written after it untagged (the monitor clears its
     anomaly window when it rolls back) and carrying the health state.
   Each run's launch counts are zeroed before and read after: lrn_fwd,
   lrn_bwd and maxpool_bwd 2, 2 and 3 per executed step, a retried round
   counted again. Prints each round's wall time, each save's, restore's
   and stage-1 snapshot's seconds and bytes, and the step sizes on disk.
6. ImageNet: full-width CaffeNet (crop 227, 1000 classes, b256, τ = 5,
   bfloat16, the app's solver) through the ImageNet app in a world of one,
   with cuDNN's deterministic algorithms. A corpus of 2560 train JPEGs in
   8 tar shards and 256 val JPEGs (256x256, `data/imagenet.py:
   write_synthetic_shards`, PIL) is written to a temporary directory.
   - The app's own `main()` trains one round (the warm-up) and evaluates
     once: the round's loss finite with nonfinite 0, the eval accuracy line
     present, lrn_fwd / lrn_bwd / maxpool_bwd 2 / 2 / 3 per step plus
     lrn_fwd's 2 per eval forward.
   - `prepare_data` (the app's decode and mean image, timed), then the
     same `train()` that `main()` calls on that data, 4 rounds a run:
     levers on (the defaults: the round-prep thread, h2d_prefetch,
     donate_batches, collect_async; log_every 1, telemetry on) and levers
     off (those three off and each round prepared on the main thread:
     the synchronous loop), in 2 alternating pairs. Per round: loss,
     round_s, the breakdown (t_data_ms, t_h2d_ms, t_round_ms,
     t_collect_ms / t_collect_bg_ms, the round prep's own t_prep_ms) and
     the H2D bytes; per run: their medians and ranges over the warm rounds,
     img/s and the preprocessing route (native or numpy). Checks: every
     loss finite with nonfinite 0; every run's losses and final flat
     params torch.equal to the first run's; launches 2 / 2 / 3 per step;
     each run's first round, as `train_round` received it (placed on the
     card when the levers are on), torch.equal to `prepare_round_batches`
     on the host.
7. Stream: the same CaffeNet, solver, bfloat16, b256 and τ = 5 through
   the ImageNet app's streaming ingest (`--stream always`,
   `data/streaming.py`) on phase 6's corpus, in a world of one, with
   cuDNN's deterministic algorithms:
   - the app's own `main()`: one round and one evaluation, with
     `checkpoint_dir` for the mean sidecar: the round's loss finite with
     nonfinite 0, the eval line present, launches 2 / 2 / 3 per step plus
     lrn_fwd's 2 per eval forward; the streamed mean image within 1
     float32 ulp of phase 6's cached mean;
   - resume through the stream cursor with `ingest_sources=2` (two shard
     readers, shards j::2), `checkpoint_every=2` (async writes): 6 rounds
     uninterrupted; 4 rounds, then a second `train()` that resumes to
     round 6. Every param and momentum tensor and every loss equal
     (`torch.equal`); step 4's `extra["stream"]` is the cursor after
     round 4's data (both runs), not the prefetched round 5's; the
     uninterrupted run's first round, as `train_round` received it on the
     card, torch.equal to the host's `prepare_round_batches` on a fresh
     source;
   - the same shards served as `gs://` by `tests/fake_stores.py:
     serve_dir_for_ingest` on localhost: two rounds' raw batches and
     cursors equal the local stream's bit for bit; the uninterrupted
     run's last step saved to `gs://` restores equal, tensor for tensor.
   Prints per round loss, round_s, t_data_ms, t_prep_ms, img/s with the
   data wait and the streaming thread's decode seconds; per run its
   launches and the process's peak RSS; the stream cursor of every step.
8. Elastic: the same CaffeNet, solver, bfloat16, b256 and τ = 5 through
   `apps.train_loop.train` in a world of one, on seeded int8 images, with
   cuDNN's deterministic algorithms:
   - run "watched": `status_port=0`, `pod_port=0`, `heartbeat_path`,
     `pod_dir`, `checkpoint_dir` every 2 rounds, and `elastic`
     (`expected_workers=2`, `min_workers=1`, `tau_adapt`, no poll
     interval, no re-probe backoff, `dead_probes=2`). The round hook beats
     a nominal worker 1 with a small `round_s` — so this rank is the slow
     one and runs a shorter τ — and backdates that beat after round 3.
     While the run is live the hook scrapes `/metrics` (the train
     families, the membership gauges, the card's memory gauges) and
     `/pod/status` (workers 0 and 1, epoch 0). After it: the run left by
     ElasticRelaunch, exit code 75, at round 6 (suspected at 4, probed at
     5 and 6), with one `resize` event with dead ["1"]; the boundary step
     6 was written by the loop's main thread and verifies; both heartbeat
     files have the JAX package's schema and say "resize" at epoch 1;
     every round launched lrn_fwd / lrn_bwd / maxpool_bwd 2 / 2 / 3 times
     per executed step (a round under a τ vector runs fewer steps; at
     least one did), and every loss is finite.
   - run "resume 4 -> 1": step 6 is written again as a 4-rank replica
     step (params rows the run's, momentum rows the run's times four
     seeded factors, `n_devices` 4) and `train(resume=True)` runs 2
     rounds at a world of one: the log says "ELASTIC resume", the
     restored params are torch.equal to the step's row 0 and the
     restored momentum to numpy `reduce_momentum_rows(rows,
     "norm_rescale")` uploaded; both rounds finite, launches as above.
   Prints per round the boundary's own cost (the membership poll and
   decision, `t_member_ms`, and the loop's heartbeat writes) beside
   round_s,
   round_s against phase 4's, every save's seconds and bytes (the
   boundary save marked), the 4-row step's bytes and restore seconds, and
   one `/metrics` scrape over HTTP in ms beside the registry's own render.
9. Serve over HTTP: the port's serving replica on the card — full-width
   CaffeNet (crop 227, 1000 classes) with seeded weights, float32,
   `max_batch=128`, buckets (1, 8, 64, 128), outputs ("prob",), a
   `checkpoint_dir` polled every 0.2 s, `status_port=0` and a heartbeat,
   behind an `HttpFrontend` on port 0 with a `TenantAdmission` door.
   Launch counters are zeroed before the server starts and read after its
   traffic. 8 keep-alive client threads send npz requests through
   `http_infer`: a warm-up, a steady pass of 8 x 64 (img/s and the
   client-side p50/p99 beside phase 3's in-process img/s), a traced pass
   (request tracing on: each stage's mean ms on the server), then traffic
   during which step 1 — the weights of seed 1 in the JAX package's
   monolithic format, through the port's checkpoint store — is written,
   installed, and a step 2 with one byte of its arrays flipped is
   published and rejected. Checks: every response 200 with a step, at
   least 1024 requests in all; each client's steps never decrease; after
   the swap a fixed request's prob `torch.equal` to the seed-1 net's
   forward at bucket 1; step 2 rejected as corrupt (swaps_total
   {outcome="rejected"} 1, the heartbeat's rollbacks 1, serving on step
   1); /healthz 200 on the status server and the frontend; /metrics with
   the serve families, `transport="http"`, the swap counters and
   `sparknet_serve_model_freshness_seconds`; lrn_fwd 2 launches per
   traffic forward plus 2 per canary forward, all float32. Then a second
   server with `quant="int8"` installs the same step: its parity canary
   passes, its prob is within QuantConfig's rtol/atol of the f32 lane's on
   the same requests, and its lrn_fwd launches are bfloat16 (2 per traffic
   and quantized canary forward; the parity reference forward is f32).
   Prints the connections opened, commit-to-install seconds, the canary
   ms, freshness_s at install, and the f32 and int8 bucket-128 forward
   times (wall and device).
10. Per-shard and supervised: the same CaffeNet, solver, bfloat16, b256
   and τ = 5 through `apps.train_loop.train` in a world of one, on
   seeded int8 images, with cuDNN's deterministic algorithms:
   - the two layouts, 4 rounds each with `checkpoint_every=2`:
     `checkpoint_sharded="off"` and `"on"` (the latter with `trace_out`
     and `profile_dir`). Checks: the "on" steps are `format: "sharded"`
     with one shard file and its digest; every step of both verifies;
     `restore_flat` of the two step-4s equal key for key, bit for bit;
     a second `train()` resuming from the per-shard step 2 to round 4 is
     `torch.equal`, tensor for tensor, to the uninterrupted "on" run;
     launches 2 / 2 / 3 per step. Prints each layout's stage-1, save and
     restore seconds and bytes;
   - the host trace parses, with `round_prep`, `h2d_prefetch` and
     `checkpoint_write` spans and one `flush` instant per round; the
     profile directory holds round 1's trace: device time by kernel name
     (the top rows, down to the last of the port's kernels); each of the
     port's kernels appears in it (its records printed beside the launch
     counters' exact 2 / 2 / 3 per step: a process that profiled before
     can miss a window's first kernels), and a cuDNN convolution ranks
     in the top 10;
   - the relaunch supervisor (`python -m sparknet_tpu_torch.parallel.
     supervise --nproc 1`) over a child process running phase 8's
     watched configuration with `checkpoint_sharded="on"` to round 8,
     its nominal worker 1 silent after round 3: the first launch exits 75
     at round 6 with a verified per-shard boundary step, the supervisor
     relaunches with no strike, the second launch logs "ELASTIC resume",
     runs rounds 6-7 and exits 0; the summary reads launches 2,
     relaunches 1, strikes 0, code 0; each launch's kernels 2 / 2 / 3
     per executed step. Prints the relaunch's seconds (from the exit 75
     to the next `train()`);
   - a port `ModelManager` on the card installs the per-shard step 4; its
     bucket-1 prob `torch.equal` to that of a net loaded from the
     monolithic step 4.
11. Router and binary wire: a `ModelRouter(workers=2, hedge=True,
   coalesce=True, status_port=0)` in this process with two lanes,
   full-width CaffeNet (crop 227, 1000 classes, float32, `max_batch=128`,
   buckets (1, 8, 64, 128), outputs ("prob",)) and LeNet; the CaffeNet
   lane installs step 1 (the seed-0 weights in the JAX package's
   monolithic format) from a checkpoint directory through the port's
   store, and so does a remote replica: the serve CLI (`python -m
   sparknet_tpu_torch.serve.app --model caffenet --binary-port 0
   --checkpoint-dir ...`) in a child process on the same card, added as
   `spkn://127.0.0.1:<port>`. An `HttpFrontend` and a `BinaryFrontend`
   front the router. Launch counters are zeroed before the router starts.
   8 closed-loop client threads make a warm-up and three steady passes of
   8 x 64 CaffeNet requests: `BinaryClient` with shm, `BinaryClient`
   inline, `http_infer` (npz); a LeNet trickle runs beside them. Checks:
   every reply from step 1, at least 1536 CaffeNet requests answered; the
   shm pass moves no payload byte through a socket (frontend and clients)
   and every one through segments (the frontend's shm counters); a
   4th pass drains the remote replica mid-traffic: every request answers,
   and the 64 after it all go to the local lane; one traced request per
   transport prints the server's stages; a fixed request alone is
   `torch.equal` over shm, inline, HTTP and the router to the lane's
   direct bucket-1 forward (built as the server builds it, deterministic
   cuDNN), and the remote replica's within 1e-6; hedges within the budget,
   each request answered once (routed legs = requests + hedges);
   /metrics with `sparknet_serve_routed_total` by model and replica and
   both transports; lrn_fwd 2 launches per CaffeNet forward of this
   process (traffic and canary), float32, and 2 per forward of the child,
   which prints its counts at exit. Prints img/s and client p50/p99 per
   transport beside phases 9 and 3, the traced stages, hedges fired, won
   and cancelled, and coalesced picks.
12. The fleet: a `ModelRouter(workers=2, history=True, status_port=0)`
   in this process with one full-width CaffeNet lane (crop 227, 1000
   classes, float32, `max_batch=128`, buckets (1, 8, 64, 128), outputs
   ("prob",)) that installs step 1 (the seed-0 weights) from a checkpoint
   directory under a rollout gate, with `slo_p99_ms = S` and
   `slo_availability = 0.999` (its `SloSpec` reads the router's routed
   latency, which covers the grown replicas' replies); a
   `BinaryFrontend` behind a
   `PriorityAdmission` door; a `FleetController` (every 0.5 s, replicas
   1..2, a 4 s window, the alerter's pages attached) growing replicas
   through `SubprocessReplicaProvider`: the port's serve CLI in child
   processes on the same card, each counting its forwards and lrn_fwd
   launches. S comes from a calibration pass on a lone server: the
   largest latency-histogram bound at most half the burst's server-side
   p50 and at least 3x the trickle's client p99, the median of three 3 s
   windows (printed, with the host's load). Launch counters are
   zeroed before the router starts. Then, in order: a burst of 8
   closed-loop clients with 64 requests each in flight (priority high):
   the page fires, the pressure reaches `page_pressure`, a
   normal-priority request is shed, the controller grows a replica
   ("slo_burn" in the audit) and it answers routed requests over
   spkn://; step 2 is saved under the burst: the lane adopts it as the
   canary, then the child (read from its heartbeat), then the gate reads
   fleet-wide in the JAX `write_gate` schema; a corrupt step 3 (one
   flipped byte): the canary rejects it, the rollout halts, the gate
   denies it; the child is killed with SIGKILL: the controller names it
   dead and grows a replacement. The burst ends; a fixed request to the
   replacement alone is within 1e-6 of the lane's direct bucket-1
   forward. A trickle of 1 client: the page resolves, the controller
   drains and retires the replacement with no request dropped;
   /fleet/status, /slo/status and /timeseries answer with the JAX
   package's keys; every reply came from step 1 or 2, and from step 2
   after it went fleet-wide; `python -m sparknet_tpu_torch.obs.slo`
   builds the report from the history shards, and each of its windows
   that missed S has a window the clients' own replies missed within
   one history slot, and the reverse; lrn_fwd 2 launches per CaffeNet
   forward in this process and in each child, float32. Prints the
   calibration and S, the grow decision to the new replica's first
   routed reply, img/s and client p50 / p99 before and after the grow,
   the page's fire and resolve seconds, the rollout's canary to
   fleet-wide seconds and the history's sample ms.
13. Bulk inference and the warm-up cache: step 1 (the seed-0 weights) of
   full-width CaffeNet (crop 227, 1000 classes, float32) in a checkpoint
   directory; two replicas grown through `SubprocessReplicaProvider(
   compile_cache_dir=<an empty directory>)` (the serve CLI with buckets
   (1, 8, 64, 128) and `--binary-port`, each child counting its forwards,
   lrn_fwd launches and nvcc builds): child A on the cold directory,
   child B on the same directory once A is up. Checks: A ran nvcc once,
   for lrn_fwd, and recorded at least one `cache_hit="false"` compile
   event (its first serve_bucket event carries the build its server ran
   before the install canary); B ran it zero times and recorded no
   `cache_hit="false"` compile event. Then a seeded 512-row 227x227x3 input goes through
   `python -m sparknet_tpu_torch.batch.driver` (fc7, 64-row units,
   window 16, concurrency 2, tenant batch at priority low, paced): the
   driver is SIGKILLed after 2 committed units, resumed in this process,
   and child A is SIGKILLed while the resumed job has a unit on it.
   Checks: the job is done with `units_skipped_resume` the units
   committed before the kill; every row in exactly one part, parts and
   manifest rows one for one; a retry of kind error, its unit committed
   by child B; each row's fc7 within `BATCH_FC7_RTOL` (relative to the
   largest |fc7|) of a direct bucket-128 forward here with the same
   weights; lrn_fwd 2 launches per forward in each child, float32; the
   `sparknet-metrics` batch view over the driver's JSONLs reads the unit
   commits and the retry trail, and `python -m
   sparknet_tpu_torch.obs.summary --selfcheck` exits 0 on the card with
   every view. Prints each child's spawn-to-port seconds and compile
   events, the rows/s of both runs, the largest fc7 difference and the
   phase's seconds.
14. The trainers beyond parity: full-width CaffeNet (crop 227, 1000
   classes), bfloat16, b256, τ = 5, 10 rounds (collected inline, so a
   round's time is its period on the card) of seeded int8 images,
   cuDNN's deterministic algorithms, a world of one, through
   `apps.train_loop.train` with `trainer_impl="shard_map"` (the
   reference run), then `"named"` with `state_sharding` "replicated",
   "momentum" and "full" (twice: a step written with
   `checkpoint_sharded="on"`, then "off"). Checks: each named run's
   losses, final params and momentum `torch.equal` to the reference
   run's (at one rank the gather, the reduce-scatter and the division
   by 1 are exact); lrn_fwd / lrn_bwd / maxpool_bwd 2 / 2 / 3 launches a
   step in every run; the "full" run's two steps restore to the same
   flat map bit for bit, stamped `layout="logical"`,
   `state_sharding="full"`; each restores into a `ParallelTrainer` and a
   "momentum" `ShardedTrainer` with params and momentum `torch.equal` to
   the run's (the one logical momentum taken as it is: the JAX
   `adapt_state` rule). Prints each run's warm rounds, peak memory and
   at-rest state, the FLOPs an image from `utils/flops.py`, and an MFU
   line for phase 4's and each of this phase's warm rounds against the
   card's dense bf16 peak, with the card's name and power limit.
15. The graph backend and the raw-pixel door, float32, cuDNN's
   deterministic algorithms:
   - (a) `build_alexnet_graph(batch=256, n_classes=1000)` (227x227x3,
     in-graph Momentum 0.9) through `apps.graph_common.train_graph` (the
     port's `run_loop` over a `GraphTrainer`) in a world of one, τ = 5,
     3 rounds, on seeded int8 NHWC images: every loss and health scalar
     finite, nonfinite 0, the variables finite; 2 rounds saved and a
     second run resumed to round 3 is `torch.equal` (every variable and
     slot) to the uninterrupted run; one `GraphTrainer.train_round` is
     `torch.equal` to 5 `GraphNet.step` calls on the same batches (a
     world of one averages to itself); `set_weights` leaves every slot
     `torch.equal`. Prints the warm rounds' ms and img/s.
   - (b) the trained graph as JSON (its baked initial values dropped)
     plus a weights npz, built by `serve.app.build_net(graph=...)` as
     `serve.app --graph g.json --weights w.npz` builds it, behind the
     port's InferenceServer with buckets (1, 8, 64, 128), outputs
     ("prob",): 128 queued requests form one bucket-128 batch whose
     replies are `torch.equal` to `GraphNet.forward` of the same padded
     bucket; then a lone request and a burst of 8; every prob row finite,
     of 1000, summing to 1 within 1e-4.
   - (c) full-width CaffeNet (seed 0) behind an InferenceServer with an
     `ImagePreprocessor` (crop 227, a seeded mean image): 128 queued
     uint8 3x256x256 requests (one bucket-128 batch), a lone one and a
     burst of 8; the bucket-128 and bucket-1 replies `torch.equal` to the
     net's forward of the host-decoded, zero-padded bucket; lrn_fwd 2
     launches per forward (counted from before the server starts).
16. Sequence-parallel attention (no kernel of the port: its products and
   softmax are PyTorch ops), B=1, H=8, D=128, on seeded q, k, v:
   - (a) one rank's work of a 4-card ring at L=32768: query shards 0 and
     3 (8192 tokens each) through the ring's order of four
     `block_accumulate` calls over 8192-token KV blocks (shard r holds KV
     shard (r - t) mod 4 at step t), then `finalize_accumulator`, under
     "float32" (TF32 off) and "bfloat16", causal and not. Each case runs
     once to warm up, then forward and backward of sum(o**2) timed (host
     clock around synchronized work) with `max_memory_allocated` of the
     timed run; the output rows and the gradients in q_r, k and v are held
     to exact `attention` over the whole sequence, one head at a time
     (one head's float32 scores are 4.3 GB; all eight heads' forward and
     backward would not fit on the card): the largest |error| over the
     largest |reference| at most 1e-4 under "float32" and 3e-2 under
     "bfloat16" (`ATTN_TOL`). Prints the ms, the peak memory and the
     FLOPs (4·B·H·Lq·L·D forward, 3x that with the backward).
   - (b) `make_ring_attention` on a world of one NCCL group, ring and
     Ulysses, causal and not, at L=8192, float32: the output within 1e-4
     (relative to its largest value) of exact attention.
   Launch counters are zeroed before and read after: the path runs none
   of the port's kernels (its products and softmax are PyTorch calls), so
   all stay 0. Prints the `{"attention": {...}}` line before the kernels
   line.
17. The convergence studies (`sparknet_tpu_torch/scripts/parity_synth.py`
   and `parity_caffenet.py`) at a world of one, cuDNN's deterministic
   algorithms; launch counters zeroed before and read after each part:
   - (a) cifar10_quick (b100, float32, seed-0 weights): one study round
     at W = 1, τ = 10 on synthetic CIFAR is `torch.equal` (loss, params,
     momentum) to `ParallelTrainer.train_round` at one rank from the same
     params and batches; then `parity_synth.run` at W = 4, τ = 10 for 5
     rounds (8000 train, 1000 test images): every round loss finite and
     the last below the first. maxpool_bwd 1 launch a step (pool1).
   - (b) full-width CaffeNet (b256, crop 227, 64 classes, bfloat16, the
     study's solver, dropout on): one study round at W = 1, τ = 5 on
     seeded uint8 256x256 images, a seeded mean and host-drawn crop
     offsets is `torch.equal` to the trainer's round on the same prepared
     batches with the same round key (so the same dropout generators);
     the card-side `prep` of step 0 is `torch.equal` to the mean
     subtraction and crop done on the host.
   - (c) `parity_caffenet.run` at W = 2, τ = 5 for 3 rounds on an
     in-memory corpus of 2560 such images (256 val): every round loss
     finite.
   lrn_fwd / lrn_bwd / maxpool_bwd 2 / 2 / 3 launches a CaffeNet step,
   plus lrn_fwd's 2 per evaluation forward. Prints each part's steps,
   synchronized ms and launches.
18. The kernels line, `{"kernels": [...]}` (lrn_fwd's row carries phases
   12's, 13's and 15's launches and forwards per process, every row phase
   14's launches per run and phase 17's per part), then the result line
   `{"ok": true, "device": {...}}` as the last line of standard output.

Exits non-zero without a result when no CUDA card is visible or when the
`sparknet_tpu_torch` package is not beside this script.
"""
from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12       # H100 SXM HBM3 (NVIDIA data sheet)
F32_OPS_PER_S = 67e12           # H100 SXM f32 outside the tensor cores
L2_BYTES = 50 * 2 ** 20

LRN_SHAPES = {"norm1": (27, 27, 96), "norm2": (13, 13, 256)}
LRN_BUCKETS = (1, 8, 128)
LRN_PARAMS = dict(local_size=5, alpha=1e-4, beta=0.75, k=1.0)  # zoo._lrn
SERVE_BUCKETS = (1, 8, 64, 128)
#: phase 9's hold on the int8 lane's fc8 logits against the f32 lane's:
#: max abs difference over the f32 logits' largest magnitude. About 4x
#: the drift of full-width CaffeNet's int8 lane (weight rounding and
#: bfloat16 activations) on random inputs; a stale, zeroed or garbled
#: answer is off by the order of the logits themselves
INT8_FC8_REL = 0.05
TRAIN_LRN_BATCHES = (100, 256)
# (name, NHWC x shape, kernel, stride, pad); the first three are one
# CaffeNet training step's MAX pools at batch 256 (TRAIN_POOLS)
POOL_CASES = (("pool1", (256, 55, 55, 96), 3, 2, 0),
              ("pool2", (256, 27, 27, 256), 3, 2, 0),
              ("pool5", (256, 13, 13, 256), 3, 2, 0),
              ("cifar_pool1", (100, 32, 32, 32), 3, 2, 0),
              ("pad1", (64, 13, 13, 256), 3, 2, 1))
TRAIN_POOLS = ("pool1", "pool2", "pool5")
# apps/imagenet_app.py:default_config — the ImageNet app's solver
IMAGENET_SOLVER = dict(base_lr=0.01, momentum=0.9, weight_decay=0.0005,
                       lr_policy="step", gamma=0.1, stepsize=100000,
                       max_iter=450000)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def time_ms(fn, inputs, min_iters: int = 20) -> float:
    """Mean ms per call over many calls, CUDA events, after warm-up; the
    calls cycle through `inputs` so repeated calls do not hit in L2."""
    import torch
    for i in range(min(len(inputs), 5)):
        fn(inputs[i])
    torch.cuda.synchronize()
    iters = max(min_iters, len(inputs))
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(inputs[i % len(inputs)])
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def _dev_us(e) -> float:
    """A profiler row's own device time, µs."""
    return getattr(e, "self_device_time_total",
                   getattr(e, "self_cuda_time_total", 0.0))


def device_ms(fn, inputs, iters: int = 20):
    """(device ms per call with the calls back to back on the card, or None
    when it cannot be measured; host ms per call): the stream is held by a
    sleep kernel while
    the host queues the calls between two CUDA events, so the host's
    launch overhead (the wrappers' Python) does not pace them as it does
    in `time_ms`. The sleep lasts four times the host's queueing time (at
    2 GHz; the card's clock is at most 1.98 GHz, so at least that long).
    If queueing took more than half of it — the host was slower than
    estimated — it is measured again over half as many calls (at least 2)
    with a longer sleep; after 8 tries the host could not get ahead of the
    card, and the time is reported as not measured. The host time is the
    queueing time of the last try over its calls: the wrapper's Python and
    the launch, unpaced by the card. Warm-up first; the calls cycle through
    `inputs` as `time_ms`'s do."""
    import torch
    for i in range(min(len(inputs), 5)):
        fn(inputs[i])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn(inputs[0])
    host_s = time.perf_counter() - t0
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    for _ in range(8):
        torch.cuda.synchronize()
        sleep_s = min(max(5e-3, 4 * iters * host_s), 2.0)
        torch.cuda._sleep(int(sleep_s * 2e9))
        t0 = time.perf_counter()
        start.record()
        for i in range(iters):
            fn(inputs[i % len(inputs)])
        end.record()
        queued_s = time.perf_counter() - t0
        end.synchronize()
        host_s = queued_s / iters
        if queued_s <= sleep_s / 2:
            return start.elapsed_time(end) / iters, host_s * 1e3
        iters = max(2, iters // 2)
    print(f"device_ms: not measured: the host could not queue {iters} calls"
          f" ahead of the card ({queued_s:.3f} s to queue)", flush=True)
    return None, host_s * 1e3


#: the times of a row of the kernels line: the kernel, its plain version
#: and the library call, host-paced (`time_ms`); the kernel back to back
#: on the card (`device_ms`, None when not measured) and the host's time
#: to issue one call (`host_ms`)
TIME_KEYS = ("ms", "plain_ms", "library_ms", "device_ms", "host_ms")


def _timings(fns: dict, inputs, kernels=("ms",)) -> dict:
    """`time_ms` of each function in `fns`, under its key; for the keys in
    `kernels`, also `device_ms` under device_<key> and host_<key>."""
    out = {key: time_ms(fn, inputs) for key, fn in fns.items()}
    for key in kernels:
        out[f"device_{key}"], out[f"host_{key}"] = device_ms(fns[key],
                                                            inputs)
    return out


def _add(a, b):
    """a + b, None (not measured) if either is."""
    return None if a is None or b is None else a + b


def _fmt_times(t: dict) -> str:
    dev = t["device_ms"]
    return (f"kernel_ms={t['ms']:.5f} plain_ms={t['plain_ms']:.5f} "
            f"library_ms={t['library_ms']:.5f} kernel_device_ms="
            f"{'not measured' if dev is None else f'{dev:.5f}'} "
            f"kernel_host_ms={t['host_ms']:.5f}")


def lrn_bound(n: int, h: int, w: int, c: int, itemsize: int,
              local_size: int) -> dict:
    """Least time for one LRN forward: bytes (x read once, y written once)
    over HBM bandwidth vs f32 operations over the f32 peak. Operations per
    element: one multiply per window term, one add between terms, two for
    the scale, three for scale^-0.75 (rsqrt, sqrt, multiply), one for the
    output multiply — with the window clipped at the channel edges."""
    half = (local_size - 1) // 2
    per_row = sum(2 * (min(ch + half, c - 1) - max(ch - half, 0) + 1) + 5
                  for ch in range(c))
    rows = n * h * w
    nbytes = 2 * rows * c * itemsize
    ops = rows * per_row
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return {"bytes": nbytes, "ops": ops, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def phase_kernels(card: str) -> dict:
    """lrn_fwd vs its plain version at the serve shapes; returns the
    aggregate row of the kernels line."""
    import torch
    import torch.nn.functional as F

    from sparknet_tpu_torch.ops.cuda_lrn import lrn_fwd
    from sparknet_tpu_torch.ops.lrn import lrn_plain

    p = LRN_PARAMS
    gen = torch.Generator(device="cuda").manual_seed(0)
    agg = {**dict.fromkeys(TIME_KEYS, 0.0), "bound_ms": 0.0,
           "max_abs_err": 0.0, "bound_by": "bytes"}
    for layer, (h, w, c) in LRN_SHAPES.items():
        for n in LRN_BUCKETS:
            for dtype in (torch.float32, torch.bfloat16):
                itemsize = torch.finfo(dtype).bits // 8
                one = n * h * w * c * itemsize
                nbuf = max(2, min(512, math.ceil(2.5 * L2_BYTES / one)))
                xs = (50.0 * torch.randn((nbuf, n, h, w, c), generator=gen,
                                         device="cuda")).to(dtype)
                x = xs[0]
                yk = lrn_fwd(x, **p)
                yp = lrn_plain(x, **p)
                torch.cuda.synchronize()
                max_err = float((yk.float() - yp.float()).abs().max())
                ok = torch.equal(yk, yp)
                fns = {"ms": lambda t: lrn_fwd(t, **p),
                       "plain_ms": lambda t: lrn_plain(t, **p),
                       "library_ms": lambda t: F.local_response_norm(
                           t.permute(0, 3, 1, 2), p["local_size"],
                           alpha=p["alpha"], beta=p["beta"], k=p["k"])}
                t = _timings(fns, xs)
                b = lrn_bound(n, h, w, c, itemsize, p["local_size"])
                dname = str(dtype).replace("torch.", "")
                print(f"lrn_fwd {layer} n={n} {dname} shape=({n},{h},{w},"
                      f"{c}) max_abs_err={max_err:.3e} tol=[bitwise] "
                      f"{'PASS' if ok else 'FAIL'} {_fmt_times(t)} "
                      f"bound_ms={b['bound_ms']:.5f} ({b['bound_by']}, "
                      f"{b['bytes']} B) achieved_GBps="
                      f"{b['bytes'] / t['ms'] / 1e6:.1f} [{card}]",
                      flush=True)
                if not ok:
                    fail(f"lrn_fwd disagrees with the plain version at "
                         f"{layer} n={n} {dname}: max abs err {max_err}")
                agg["max_abs_err"] = max(agg["max_abs_err"], max_err)
                if dtype == torch.float32 and n == 128:
                    # one bucket-128 forward's LRN work
                    if b["bound_by"] != "bytes":
                        agg["bound_by"] = b["bound_by"]
                    for key in TIME_KEYS:
                        agg[key] = _add(agg[key], t[key])
                    agg["bound_ms"] += b["bound_ms"]
                del xs, yk, yp
    return agg


def _window_terms(c: int, local_size: int) -> list:
    """Each channel's clipped LRN window size."""
    half = (local_size - 1) // 2
    return [min(ch + half, c - 1) - max(ch - half, 0) + 1 for ch in range(c)]


def _bound(nbytes: int, ops: int) -> dict:
    """The larger of bytes over HBM bandwidth and f32 operations over the
    f32 peak, in ms."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return {"bytes": nbytes, "ops": ops, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def lrn_fwd_scale_bound(rows: int, c: int, itemsize: int,
                        local_size: int) -> dict:
    """lrn_fwd with the scale: x read once, y and the scale written once;
    operations as `lrn_bound`."""
    ops = rows * sum(2 * t + 5 for t in _window_terms(c, local_size))
    return _bound(3 * rows * c * itemsize, ops)


def lrn_bwd_bound(rows: int, c: int, itemsize: int, local_size: int,
                  saved: bool) -> dict:
    """lrn_bwd: x, dy (and the saved scale) read once, dx written once.
    Operations per element: scale^-beta 3, ratio 3 (saved: two products
    and a division) or 5 (recompute: three products, rsqrt and its
    square), the ratio window's adds, 4 for dx; recompute adds the x^2
    window (one product per term, the adds between them) and 2 for the
    scale."""
    terms = _window_terms(c, local_size)
    if saved:
        per_row = sum(3 + 3 + (t - 1) + 4 for t in terms)
    else:
        per_row = sum((2 * t - 1) + 2 + 3 + 5 + (t - 1) + 4 for t in terms)
    return _bound((4 if saved else 3) * rows * c * itemsize, rows * per_row)


def maxpool_bwd_bound(x_shape, y_shape, kernel: int, itemsize: int) -> dict:
    """maxpool_bwd: x, y and dy read once, dx written once. Operations:
    each window's first-max search over its k*k positions and one add of
    its dy."""
    nx = math.prod(x_shape)
    ny = math.prod(y_shape)
    return _bound(2 * (nx + ny) * itemsize, ny * (kernel * kernel + 1))


def _nbuf(one_bytes: int, cap: int = 64) -> int:
    """Input copies to cycle through so repeated calls miss in L2."""
    return max(2, min(cap, math.ceil(2.5 * L2_BYTES / one_bytes)))


def _dname(dtype) -> str:
    return str(dtype).replace("torch.", "")


def phase_lrn_train_kernels(card: str) -> dict:
    """lrn_fwd with the scale output and lrn_bwd in both modes against
    their plain versions at the training shapes; returns the rows of the
    kernels line (keyed by what they time)."""
    import torch
    import torch.nn.functional as F

    from sparknet_tpu_torch.ops.cuda_lrn import lrn_bwd, lrn_fwd
    from sparknet_tpu_torch.ops.lrn import (lrn_bwd_plain, lrn_plain,
                                            lrn_plain_with_scale)

    p = LRN_PARAMS
    ls, a, b, k = p["local_size"], p["alpha"], p["beta"], p["k"]
    gen = torch.Generator(device="cuda").manual_seed(1)
    out = {"max_abs_err": 0.0, "cases": {}}
    for layer, (h, w, c) in LRN_SHAPES.items():
        for n in TRAIN_LRN_BATCHES:
            for dtype in (torch.float32, torch.bfloat16):
                itemsize = torch.finfo(dtype).bits // 8
                rows = n * h * w
                nbuf = _nbuf(rows * c * itemsize)
                xs = (50.0 * torch.randn((nbuf, n, h, w, c), generator=gen,
                                         device="cuda")).to(dtype)
                dys = torch.randn((nbuf, n, h, w, c), generator=gen,
                                  device="cuda").to(dtype)
                x, dy = xs[0], dys[0]
                y, scale = lrn_fwd(x, **p, with_scale=True)
                y_only = lrn_fwd(x, **p)
                py, pscale = lrn_plain_with_scale(x, **p)
                dx_saved = lrn_bwd(x, dy, scale, ls, a, b, k)
                dx_re = lrn_bwd(x, dy, None, ls, a, b, k)
                pdx_saved = lrn_bwd_plain(x, dy, pscale, ls, a, b, k)
                pdx_re = lrn_bwd_plain(x, dy, None, ls, a, b, k)
                torch.cuda.synchronize()
                pairs = {"y": (y, py), "y_only": (y_only, py),
                         "scale": (scale, pscale),
                         "dx_saved": (dx_saved, pdx_saved),
                         "dx_recompute": (dx_re, pdx_re)}
                errs = {name: float((g.float() - w_.float()).abs().max())
                        for name, (g, w_) in pairs.items()}
                ok = all(torch.equal(g, w_) for g, w_ in pairs.values())
                out["max_abs_err"] = max([out["max_abs_err"]]
                                         + list(errs.values()))
                idx = list(range(nbuf))
                scales = [lrn_fwd(xs[i], **p, with_scale=True)[1]
                          for i in idx]
                xg = [xs[i].permute(0, 3, 1, 2).detach().requires_grad_()
                      for i in idx]
                ylib = [F.local_response_norm(t, ls, alpha=a, beta=b, k=k)
                        for t in xg]
                fns = {
                    "fwd_scale": lambda i: lrn_fwd(xs[i], **p,
                                                   with_scale=True),
                    "fwd_y": lambda i: lrn_fwd(xs[i], **p),
                    "plain_fwd_scale": lambda i: lrn_plain_with_scale(
                        xs[i], **p),
                    "plain_fwd_y": lambda i: lrn_plain(xs[i], **p),
                    "lib_fwd": lambda i: F.local_response_norm(
                        xs[i].permute(0, 3, 1, 2), ls, alpha=a, beta=b, k=k),
                    "bwd_saved": lambda i: lrn_bwd(xs[i], dys[i], scales[i],
                                                   ls, a, b, k),
                    "bwd_recompute": lambda i: lrn_bwd(xs[i], dys[i], None,
                                                       ls, a, b, k),
                    "plain_bwd_saved": lambda i: lrn_bwd_plain(
                        xs[i], dys[i], scales[i], ls, a, b, k),
                    "plain_bwd_recompute": lambda i: lrn_bwd_plain(
                        xs[i], dys[i], None, ls, a, b, k),
                    "lib_bwd": lambda i: torch.autograd.grad(
                        ylib[i], xg[i], dys[i].permute(0, 3, 1, 2),
                        retain_graph=True),
                }
                t = _timings(fns, idx, kernels=("fwd_scale", "fwd_y",
                                                "bwd_saved", "bwd_recompute"))
                bounds = {
                    "fwd_scale": lrn_fwd_scale_bound(rows, c, itemsize, ls),
                    "fwd_y": lrn_bound(n, h, w, c, itemsize, ls),
                    "bwd_saved": lrn_bwd_bound(rows, c, itemsize, ls, True),
                    "bwd_recompute": lrn_bwd_bound(rows, c, itemsize, ls,
                                                   False)}
                dn = _dname(dtype)
                print(f"lrn_train {layer} n={n} {dn} shape=({n},{h},{w},{c})"
                      f" bitwise={'PASS' if ok else 'FAIL'} max_abs_err "
                      f"y={errs['y']:.1e} y_vs_y_only={errs['y_only']:.1e} "
                      f"scale={errs['scale']:.1e} dx_saved="
                      f"{errs['dx_saved']:.1e} dx_recompute="
                      f"{errs['dx_recompute']:.1e} tol=[bitwise] [{card}]",
                      flush=True)
                for kind, plain_key, lib_key in (
                        ("fwd_scale", "plain_fwd_scale", "lib_fwd"),
                        ("fwd_y", "plain_fwd_y", "lib_fwd"),
                        ("bwd_saved", "plain_bwd_saved", "lib_bwd"),
                        ("bwd_recompute", "plain_bwd_recompute", "lib_bwd")):
                    bd = bounds[kind]
                    row = {"ms": t[kind], "plain_ms": t[plain_key],
                           "library_ms": t[lib_key],
                           "device_ms": t[f"device_{kind}"],
                           "host_ms": t[f"host_{kind}"]}
                    print(f"lrn_train   {kind:13s} {layer} n={n} {dn} "
                          f"{_fmt_times(row)} bound_ms={bd['bound_ms']:.5f} "
                          f"({bd['bound_by']}, {bd['bytes']} B) "
                          f"achieved_GBps={bd['bytes'] / row['ms'] / 1e6:.1f}"
                          f" [{card}]", flush=True)
                    out["cases"][(kind, layer, n, dn)] = {**row, **bd}
                if not ok:
                    fail(f"LRN training kernels disagree with their plain "
                         f"versions at {layer} n={n} {dn}: {errs}")
                del xs, dys, scales, xg, ylib
    return out


def phase_pool_kernels(card: str) -> dict:
    """maxpool_bwd against its plain version on tie-heavy inputs, and at
    the training step's pools (pool1/2/5, batch 256, bfloat16) also on
    dense ones; returns the rows of the kernels line, keyed by (case,
    dtype, input)."""
    import torch

    from sparknet_tpu_torch.ops.cuda_pool import maxpool_bwd
    from sparknet_tpu_torch.ops.pooling import (_max_forward,
                                                maxpool_bwd_plain)

    gen = torch.Generator(device="cuda").manual_seed(2)
    out = {"max_abs_err": 0.0, "cases": {}}
    for name, shape, kern, stride, pad in POOL_CASES:
        for dtype in (torch.float32, torch.bfloat16):
            dn = _dname(dtype)
            kinds = ("ties", "dense") if name in TRAIN_POOLS and \
                dtype == torch.bfloat16 else ("ties",)
            for kind in kinds:
                itemsize = torch.finfo(dtype).bits // 8
                nbuf = _nbuf(math.prod(shape) * itemsize, cap=8)
                if kind == "ties":
                    # a few integer levels, clipped at 0 (post-ReLU)
                    xs = torch.randint(-2, 4, (nbuf,) + shape, generator=gen,
                                       device="cuda").clamp_(min=0)
                else:
                    # ReLU of a Gaussian: ties only among the zeros
                    xs = torch.randn((nbuf,) + shape, generator=gen,
                                     device="cuda").clamp_(min=0)
                xs = xs.to(dtype)
                x_nchw = [xs[i].permute(0, 3, 1, 2) for i in range(nbuf)]
                ys = [_max_forward(t, kern, stride, pad).permute(0, 2, 3, 1)
                      .contiguous() for t in x_nchw]
                dys = [torch.randn(ys[0].shape, generator=gen,
                                   device="cuda").to(dtype)
                       for _ in range(nbuf)]
                got = maxpool_bwd(xs[0], ys[0], dys[0], kern, stride, pad)
                want = maxpool_bwd_plain(xs[0], ys[0], dys[0], kern, stride,
                                         pad)
                torch.cuda.synchronize()
                err = float((got.float() - want.float()).abs().max())
                same_pos = torch.equal(got != 0, want != 0)
                ok = torch.equal(got, want) and same_pos
                out["max_abs_err"] = max(out["max_abs_err"], err)
                idx = list(range(nbuf))
                xg = [t.detach().requires_grad_() for t in x_nchw]
                ylib = [_max_forward(t, kern, stride, pad) for t in xg]
                t = _timings({
                    "ms": lambda i: maxpool_bwd(xs[i], ys[i], dys[i], kern,
                                                stride, pad),
                    "plain_ms": lambda i: maxpool_bwd_plain(
                        xs[i], ys[i], dys[i], kern, stride, pad),
                    "library_ms": lambda i: torch.autograd.grad(
                        ylib[i], xg[i], dys[i].permute(0, 3, 1, 2),
                        retain_graph=True)}, idx)
                bd = maxpool_bwd_bound(shape, tuple(ys[0].shape), kern,
                                       itemsize)
                print(f"maxpool_bwd {name} {dn} {kind} x={shape} -> y="
                      f"{tuple(ys[0].shape)} k={kern} s={stride} pad={pad} "
                      f"max_abs_err={err:.1e} same_positions={same_pos} "
                      f"tol=[bitwise] {'PASS' if ok else 'FAIL'} "
                      f"{_fmt_times(t)} bound_ms={bd['bound_ms']:.5f} "
                      f"({bd['bound_by']}, {bd['bytes']} B) achieved_GBps="
                      f"{bd['bytes'] / t['ms'] / 1e6:.1f} [{card}]",
                      flush=True)
                out["cases"][(name, dn, kind)] = {**t, **bd}
                if not ok:
                    fail(f"maxpool_bwd disagrees with its plain version at "
                         f"{name} {dn} {kind}: max abs err {err}, same "
                         f"positions {same_pos}")
                del xs, x_nchw, ys, dys, xg, ylib
    return out


def phase_serve(card: str, device: str = "cuda", crop: int = 227) -> dict:
    """Full-width CaffeNet through the port's InferenceServer; returns the
    lrn_fwd launch count of the run. (`device` and `crop` let the serve
    phase be rehearsed on the CPU at a small crop.)"""
    import numpy as np
    import torch

    from sparknet_tpu_torch import precision, zoo
    from sparknet_tpu_torch.model.layers import OpsImpl
    from sparknet_tpu_torch.net_api import TorchNet
    from sparknet_tpu_torch.ops.cuda_lrn import lrn_fwd
    from sparknet_tpu_torch.serve.server import InferenceServer, ServeConfig

    precision.set_policy("float32")
    spec = zoo.caffenet(batch=128, crop=crop, n_classes=1000)
    t0 = time.perf_counter()
    net = TorchNet(spec, seed=0, device=device)
    print(f"serve: TorchNet(caffenet {crop}/1000) on {net.device} built in "
          f"{time.perf_counter() - t0:.2f}s", flush=True)
    rng = np.random.default_rng(1)
    # mean-subtracted pixel scale; 169 distinct requests
    payloads = [{"data": (50.0 * rng.standard_normal((crop, crop, 3))
                          ).astype(np.float32)} for _ in range(169)]
    cfg = ServeConfig(model_name="caffenet", max_batch=128,
                      buckets=SERVE_BUCKETS, outputs=("prob",),
                      max_wait_ms=50.0)
    server = InferenceServer(net, cfg).start()
    try:
        lrn_fwd.launches = 0
        t0 = time.perf_counter()
        lone = server.submit(payloads[0]).result(timeout=300)
        burst = [server.submit(p) for p in payloads[1:129]]
        burst_out = [f.result(timeout=300) for f in burst]
        tail = [server.submit(p) for p in payloads[129:169]]
        tail_out = [f.result(timeout=300) for f in tail]
        cold_s = time.perf_counter() - t0
        cold = server.status()
        server.reset_counters()
        t1 = time.perf_counter()
        steady = []
        for _ in range(4):
            futs = [server.submit(p) for p in payloads[1:129]]
            steady += [f.result(timeout=300) for f in futs]
        steady_s = time.perf_counter() - t1
        launches = lrn_fwd.launches
        warm = server.status()
        batch_log = list(server.batch_log)
    finally:
        server.stop()

    results = [lone] + burst_out + tail_out + steady
    for i, r in enumerate(results):
        prob = r["prob"]
        if prob.shape != (1000,) or not np.isfinite(prob).all():
            fail(f"request {i}: prob shape {prob.shape}, finite "
                 f"{np.isfinite(prob).all()}")
        if abs(float(prob.sum(dtype=np.float64)) - 1.0) > 1e-4:
            fail(f"request {i}: prob sums to {prob.sum()}")
    buckets = sorted({b for _, b in batch_log})
    if not {1, 128} <= set(buckets):
        fail(f"buckets 1 and 128 must both serve, served {buckets}")
    forwards = len(batch_log)
    if launches != 2 * forwards:
        fail(f"lrn_fwd launched {launches} times over {forwards} forwards "
             f"(want 2 per forward)")
    print(f"serve: {len(results)} requests answered in {forwards} forwards, "
          f"buckets served {buckets}, lrn_fwd launches {launches} "
          f"(2 per forward) [{card}]", flush=True)
    print(f"serve: cold pass (1 + 128 + 40 requests, first forward of each "
          f"bucket included): {169 / cold_s:.1f} img/s, p50 "
          f"{cold['p50_ms']} ms, p99 {cold['p99_ms']} ms [{card}]",
          flush=True)
    print(f"serve: steady pass (4 bursts of 128): {512 / steady_s:.1f} "
          f"img/s, p50 {warm['p50_ms']} ms, p99 {warm['p99_ms']} ms "
          f"[{card}]", flush=True)
    if device == "cuda":
        print(f"serve: peak device memory "
              f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB "
              f"[{card}]", flush=True)

    # the served burst vs the same rows through the plain LRN
    batch = {"data": np.stack([p["data"] for p in payloads[1:129]]),
             "label": np.zeros((128, 1), np.int32)}
    plain = net.forward(batch, ["prob"], ops=OpsImpl(lrn="plain"))["prob"]
    served = np.stack([r["prob"] for r in burst_out])
    err = float(np.abs(served - plain).max())
    print(f"serve: bucket-128 prob vs plain-LRN forward: max abs err "
          f"{err:.3e} (tol atol 1e-6 rtol 1e-4)", flush=True)
    if not np.allclose(served, plain, rtol=1e-4, atol=1e-6):
        fail(f"served prob disagrees with the plain-LRN forward ({err})")

    # the served answers vs a CPU forward of the same net and weights
    cpu = TorchNet(spec, seed=0, device="cpu")
    ref = cpu.forward({"data": batch["data"][:2],
                       "label": batch["label"][:2]}, ["prob"])["prob"]
    err = float(np.abs(served[:2] - ref).max())
    print(f"serve: prob vs CPU forward (same seed, 2 requests): max abs err "
          f"{err:.3e} (tol atol 1e-5)", flush=True)
    if not np.allclose(served[:2], ref, rtol=0, atol=1e-5):
        fail(f"served prob disagrees with the CPU forward ({err})")
    if device == "cuda":
        profile_forward(net, [p["data"] for p in payloads[1:129]], card)
    return {"launches": launches, "steady_img_s": 512 / steady_s}


def profile_forward(net, rows, card: str, top: int = 12) -> None:
    """Where one bucket-128 batch's time goes: the host stacking the
    request rows, the synchronous host->device copy, and the device
    kernels of one `TorchNet.forward` by name (torch.profiler), with the
    share of the forward's wall time in which no kernel ran (copies do not
    count as kernel time)."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    t0 = time.perf_counter()
    stacked = np.stack(rows)
    t_stack = time.perf_counter() - t0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    torch.from_numpy(stacked).to("cuda")
    torch.cuda.synchronize()
    t_h2d = time.perf_counter() - t0
    batch = {"data": stacked, "label": np.zeros((len(rows), 1), np.int32)}
    net.forward(batch, ["prob"])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        net.forward(batch, ["prob"])
        wall = time.perf_counter() - t0

    # device-side events only: a CPU op's self device time repeats the
    # time of the kernels it launched
    rows_ = sorted((e for e in prof.key_averages()
                    if str(e.device_type).endswith("CUDA") and _dev_us(e) > 0),
                   key=_dev_us, reverse=True)
    copies = sum(_dev_us(e) for e in rows_
                 if e.key.startswith(("Memcpy", "Memset"))) / 1e3
    kernels = sum(_dev_us(e) for e in rows_) / 1e3 - copies
    print(f"profile: bucket-128 batch: host stack {t_stack * 1e3:.2f} ms, "
          f"H2D copy {t_h2d * 1e3:.2f} ms ({stacked.nbytes} B), forward "
          f"wall {wall * 1e3:.2f} ms, device kernels {kernels:.2f} ms, "
          f"device copies {copies:.2f} ms, kernel idle share "
          f"{max(0.0, 1 - kernels / (wall * 1e3)):.3f} [{card}]",
          flush=True)
    for e in rows_[:top]:
        print(f"profile:   {_dev_us(e) / 1e3:9.3f} ms  x{e.count:<4d} "
              f"{e.key[:90]}", flush=True)


def _zero_counts() -> None:
    from sparknet_tpu_torch.ops.cuda_lrn import lrn_bwd, lrn_fwd
    from sparknet_tpu_torch.ops.cuda_pool import maxpool_bwd
    lrn_fwd.launches = lrn_fwd.scale_launches = lrn_fwd.bf16_launches = 0
    lrn_bwd.launches = maxpool_bwd.launches = 0


def _read_counts() -> dict:
    from sparknet_tpu_torch.ops.cuda_lrn import lrn_bwd, lrn_fwd
    from sparknet_tpu_torch.ops.cuda_pool import maxpool_bwd
    return {"lrn_fwd": lrn_fwd.launches,
            "lrn_fwd_scale": lrn_fwd.scale_launches,
            "lrn_bwd": lrn_bwd.launches, "maxpool_bwd": maxpool_bwd.launches}


def _capture_logger():
    """A Logger that keeps every metrics record (rounds and events) in
    memory, in `.records`."""
    from sparknet_tpu_torch.utils.logger import Logger

    class Capture(Logger):
        def __init__(self):
            super().__init__(echo=False)
            self.records = []
            self.lines = []

        def log(self, message, i=None):
            self.lines.append(message)

        def metrics(self, step, **kv):
            self.records.append(dict(kv, round=step))

    return Capture()


def _train_run(card: str, cfg, spec, train_ds, test_ds, label: str,
               device: str) -> dict:
    """One `train()` call with its launch counts zeroed before and read
    after; returns the per-round records, counts, final state and peak
    device memory."""
    import torch

    from sparknet_tpu_torch.apps.train_loop import train

    log = _capture_logger()
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    t0 = time.perf_counter()
    state = train(cfg, spec, train_ds, test_ds, logger=log, device=device)
    if device == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _read_counts()
    peak = (torch.cuda.max_memory_allocated() / 2 ** 30
            if device == "cuda" else 0.0)
    rounds = [r for r in log.records if "loss" in r]
    for r in rounds:
        print(f"train[{label}]: round {r['round']} loss {r['loss']:.6f} "
              f"grad_norm {r.get('grad_norm')} nonfinite {r.get('nonfinite')}"
              f" round_s {r['round_s']:.4f} img/s {r['images_per_sec']:.1f} "
              f"(the round; the data wait t_data_ms {r.get('t_data_ms')} "
              f"comes before it) [{card}]", flush=True)
    print(f"train[{label}]: {len(rounds)} rounds in {wall:.2f}s wall "
          f"(set-up included), launches {counts}, peak device memory "
          f"{peak:.2f} GiB [{card}]", flush=True)
    for r in rounds:
        vals = [r["loss"], r.get("grad_norm", 0.0)]
        if not all(math.isfinite(v) for v in vals) or r.get("nonfinite"):
            fail(f"train[{label}] round {r['round']}: loss {r['loss']}, "
                 f"grad_norm {r.get('grad_norm')}, nonfinite "
                 f"{r.get('nonfinite')}")
    if len(rounds) != cfg.max_rounds:
        fail(f"train[{label}]: {len(rounds)} rounds logged, want "
             f"{cfg.max_rounds}")
    return {"rounds": rounds, "counts": counts, "state": state,
            "peak_gib": peak}


def _expect_counts(label: str, counts: dict, want: dict) -> None:
    if counts != want:
        fail(f"train[{label}]: launches {counts}, want {want}")


def phase_train(card: str, device: str = "cuda", crop: int = 227,
                batch: int = 256, small_batch: int = 100, tau: int = 5,
                rounds: int = 6, n_classes: int = 1000) -> dict:
    """Full-width CaffeNet through `apps.train_loop.train` (module
    docstring, phase 4); returns the launch counts of the main run. The
    arguments let the phase be rehearsed on the CPU at a small size, where
    the counts are those of kernel launches, so all zero."""
    import dataclasses
    import tempfile

    import numpy as np
    import torch

    from sparknet_tpu_torch import precision, zoo
    from sparknet_tpu_torch.data.dataset import ArrayDataset
    from sparknet_tpu_torch.model.layers import OpsImpl
    from sparknet_tpu_torch.model.net import CompiledNet
    from sparknet_tpu_torch.solver import SolverConfig, value_and_grad
    from sparknet_tpu_torch.utils.config import RunConfig

    r = np.random.default_rng(0)
    n = tau * batch
    # int8 pixels: a mean-subtracted range at a quarter of f32's host bytes
    data = r.integers(-128, 128, (n, crop, crop, 3), dtype=np.int8)
    labels = r.integers(0, n_classes, (n, 1)).astype(np.int32)
    train_ds = ArrayDataset({"data": data, "label": labels})
    test_ds = ArrayDataset({"data": data[:batch], "label": labels[:batch]})
    solver = SolverConfig(**IMAGENET_SOLVER)
    kernels = device == "cuda"
    with tempfile.TemporaryDirectory() as tmp:
        base = RunConfig(model="caffenet", n_classes=n_classes, crop=crop,
                         solver=solver, tau=tau, local_batch=batch,
                         max_rounds=rounds, eval_every=rounds,
                         eval_batch=batch, precision="bfloat16", seed=0,
                         workdir=tmp)
        spec = zoo.caffenet(batch=batch, crop=crop, n_classes=n_classes)
        main = _train_run(card, base, spec, train_ds, test_ds,
                          f"caffenet {crop}/{n_classes} b{batch} bf16 "
                          f"tau{tau}", device)
        steps = tau * rounds
        if kernels:
            _expect_counts("main", main["counts"], {
                "lrn_fwd": 2 * steps + 2, "lrn_fwd_scale": 0,
                "lrn_bwd": 2 * steps, "maxpool_bwd": 3 * steps})
        init = CompiledNet.compile(spec).init_params(
            torch.Generator().manual_seed(base.seed), torch.device("cpu"))
        still = [f"{l}/{p}" for l, lp in init.items() for p, w in lp.items()
                 if torch.equal(w, main["state"].params[l][p].detach()
                                .cpu())]
        if still:
            fail(f"train: params did not move: {still}")
        print(f"train: every param tensor moved from its seeded init; "
              f"launches per step lrn_fwd "
              f"{(main['counts']['lrn_fwd'] - 2) / steps:g} (+2 for the "
              f"round-0 evaluation forward), lrn_bwd "
              f"{main['counts']['lrn_bwd'] / steps:g} (recompute), "
              f"maxpool_bwd {main['counts']['maxpool_bwd'] / steps:g}",
              flush=True)
        warm = [x["round_s"] for x in main["rounds"][1:]]

        # the saved-scale route: a batch that is not a multiple of 128
        small = dataclasses.replace(base, local_batch=small_batch,
                                    max_rounds=1, eval_every=0,
                                    precision="float32")
        sub = ArrayDataset({"data": data[:tau * small_batch],
                            "label": labels[:tau * small_batch]})
        saved = _train_run(card, small, zoo.caffenet(
            batch=small_batch, crop=crop, n_classes=n_classes), sub, None,
            f"b{small_batch} f32 saved-scale", device)
        if kernels:
            _expect_counts("saved-scale", saved["counts"], {
                "lrn_fwd": 2 * tau, "lrn_fwd_scale": 2 * tau,
                "lrn_bwd": 2 * tau, "maxpool_bwd": 3 * tau})

        # the pool route A/B: the same rounds with the plain MAX-pool
        # backward; each route's first round is its warm-up
        plain = _train_run(card, dataclasses.replace(
            base, eval_every=0, pool_impl="plain"), spec, train_ds, None,
            "pool=plain", device)
        if kernels:
            _expect_counts("pool=plain", plain["counts"], {
                "lrn_fwd": 2 * steps, "lrn_fwd_scale": 0,
                "lrn_bwd": 2 * steps, "maxpool_bwd": 0})
        plain_warm = [x["round_s"] for x in plain["rounds"][1:]]

        def spread(xs):
            return (f"median {statistics.median(xs) * 1e3:.2f} ms [min "
                    f"{min(xs) * 1e3:.2f}, max {max(xs) * 1e3:.2f}] over "
                    f"{len(xs)} warm rounds")

        print(f"train: pool route A/B, rounds of {tau} steps at batch "
              f"{batch}: auto (kernel) {spread(warm)} = "
              f"{tau * batch / statistics.median(warm):.1f} img/s; plain "
              f"{spread(plain_warm)} = "
              f"{tau * batch / statistics.median(plain_warm):.1f} img/s "
              f"[{card}]", flush=True)

    # kernel route vs plain route gradients, one fixed f32 batch
    precision.set_policy("float32")
    free = spec.replace(layers=tuple(
        dataclasses.replace(l, dropout=dataclasses.replace(
            l.dropout, dropout_ratio=0.0)) if l.type == "Dropout" else l
        for l in spec.layers))
    net = CompiledNet.compile(free)
    params = net.init_params(torch.Generator().manual_seed(0),
                             torch.device(device))
    for lp in params.values():
        for w in lp.values():
            w.requires_grad_(True)
    xb = {"data": torch.from_numpy(np.ascontiguousarray(data[:batch])).to(
              device).float(),
          "label": torch.from_numpy(labels[:batch]).to(device)}
    # cuDNN's deterministic algorithms for this comparison only: the
    # routes then differ only where the kernels would
    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    grads = {}
    try:
        for route, ops in (("kernel", OpsImpl()),
                           ("plain", OpsImpl(lrn="plain", pool="plain")),
                           ("plain again", OpsImpl(lrn="plain",
                                                   pool="plain"))):
            _zero_counts()
            loss, grads[route] = value_and_grad(net.loss_fn(ops=ops), params,
                                                xb)
            print(f"grads[{route}]: loss {float(loss):.6f}, launches "
                  f"{_read_counts()}", flush=True)
    finally:
        torch.backends.cudnn.deterministic = det

    def rel_errors(a, b):
        return sorted(((float(torch.linalg.vector_norm(
            (a[l][p] - g).double()) / max(float(torch.linalg.vector_norm(
                g.double())), 1e-30)), f"{l}/{p}")
            for l, lp in b.items() for p, g in lp.items()), reverse=True)

    kp = rel_errors(grads["kernel"], grads["plain"])
    pp = rel_errors(grads["plain again"], grads["plain"])
    worst, spread = kp[0][0], pp[0][0]
    print(f"grads: kernel route vs plain route, f32 batch {batch}, "
          f"dropout-free, cuDNN deterministic: worst relative L2 error "
          f"{worst:.3e} ({', '.join(f'{n} {e:.1e}' for e, n in kp[:3])}); "
          f"plain vs plain {spread:.3e} ({', '.join(f'{n} {e:.1e}' for e, n in pp[:3])}); "
          f"tol 1e-6 + 2 x plain-vs-plain [{card}]", flush=True)
    if not worst <= 1e-6 + 2 * spread:
        fail(f"kernel-route gradients disagree with the plain route: "
             f"relative L2 {worst} (plain vs plain {spread})")
    if device == "cuda":
        precision.set_policy("bfloat16")
        profile_step(net, params, xb, solver, card)
    precision.set_policy("float32")
    return {"launches": main["counts"], "steps": steps,
            "saved_launches": saved["counts"], "warm_round_s": warm,
            "plain_pool_round_s": plain_warm, "peak_gib": main["peak_gib"],
            "grad_rel_l2": worst}


def _dir_bytes(path: str) -> int:
    return sum(os.path.getsize(os.path.join(root, f))
               for root, _, files in os.walk(path) for f in files)


def phase_checkpoint(card: str, device: str = "cuda", crop: int = 227,
                     batch: int = 256, tau: int = 5,
                     n_classes: int = 1000) -> dict:
    """Checkpoints, resume and rollback of full-width CaffeNet through
    `apps.train_loop.train` (module docstring, phase 5); returns the
    launch counts and the save and restore times. The arguments let the
    phase be rehearsed on the CPU at a small size (counts then 0)."""
    import dataclasses
    import shutil
    import tempfile
    import threading

    import numpy as np
    import torch

    from sparknet_tpu_torch import precision, zoo
    from sparknet_tpu_torch.apps.train_loop import train
    from sparknet_tpu_torch.data.dataset import ArrayDataset
    from sparknet_tpu_torch.net_api import TorchNet
    from sparknet_tpu_torch.parallel.trainer import ParallelTrainer
    from sparknet_tpu_torch.solver import SolverConfig
    from sparknet_tpu_torch.utils import checkpoint as ckpt
    from sparknet_tpu_torch.utils.config import RunConfig
    from sparknet_tpu_torch.utils.health import HealthConfig

    r = np.random.default_rng(1)
    n = tau * batch
    data = r.integers(-128, 128, (n, crop, crop, 3), dtype=np.int8)
    labels = r.integers(0, n_classes, (n, 1)).astype(np.int32)
    train_ds = ArrayDataset({"data": data, "label": labels})
    spec = zoo.caffenet(batch=batch, crop=crop, n_classes=n_classes)
    kernels = device == "cuda"
    root = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    # every save, restore and stage-1 snapshot of this phase, timed
    timed = []
    lock = threading.Lock()
    originals = (ckpt.save, ckpt.restore_flat, ckpt.restore_newest_verified,
                 ParallelTrainer.checkpoint_tree)

    def note(what, t0, nbytes, step):
        with lock:
            timed.append({"what": what, "s": time.perf_counter() - t0,
                          "bytes": nbytes, "step": step,
                          "thread": threading.current_thread().name})

    def flat_bytes(flat):
        return sum(int(a.numel() * a.element_size())
                   if isinstance(a, torch.Tensor) else int(a.nbytes)
                   for a in flat.values())

    def save(directory, tree, *, step, extra=None):
        t0 = time.perf_counter()
        path = originals[0](directory, tree, step=step, extra=extra)
        note("save", t0, _dir_bytes(path), step)
        return path

    def restore_flat(directory, step=None):
        t0 = time.perf_counter()
        out = originals[1](directory, step)
        note("restore", t0, flat_bytes(out[0]), out[1])
        return out

    def restore_newest_verified(directory, skip_anomalous=False):
        t0 = time.perf_counter()
        out = originals[2](directory, skip_anomalous=skip_anomalous)
        if out is not None:
            note("rollback restore", t0, flat_bytes(out[0]), out[1])
        return out

    def checkpoint_tree(self, state):
        t0 = time.perf_counter()
        tree = originals[3](self, state)
        note("stage 1 (gather + host copy)", t0, None, None)
        return tree

    ckpt.save, ckpt.restore_flat = save, restore_flat
    ckpt.restore_newest_verified = restore_newest_verified
    ParallelTrainer.checkpoint_tree = checkpoint_tree
    # cuDNN's deterministic algorithms: the resumed run must be bit-equal
    # to the uninterrupted one (the kernels are deterministic already)
    det = (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    steps_of = {}

    def run(label, cfg, n_rounds):
        log = _capture_logger()
        if device == "cuda":
            torch.cuda.synchronize()
        _zero_counts()
        t0 = time.perf_counter()
        state = train(cfg, spec, train_ds, None, logger=log, device=device)
        if device == "cuda":
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = _read_counts()
        rounds = [x for x in log.records if "loss" in x]
        for x in rounds:
            print(f"checkpoint[{label}]: round {x['round']} loss "
                  f"{x['loss']} nonfinite {x.get('nonfinite')} round_s "
                  f"{x['round_s']:.4f} [{card}]", flush=True)
        print(f"checkpoint[{label}]: {len(rounds)} rounds in {wall:.2f}s "
              f"wall (set-up and checkpoints included), launches {counts} "
              f"[{card}]", flush=True)
        if len(rounds) != n_rounds:
            fail(f"checkpoint[{label}]: {len(rounds)} rounds run, want "
                 f"{n_rounds}")
        executed = n_rounds * tau  # a retried round runs its steps again
        steps_of[label] = executed
        if kernels:
            _expect_counts(label, counts, {
                "lrn_fwd": 2 * executed, "lrn_fwd_scale": 0,
                "lrn_bwd": 2 * executed, "maxpool_bwd": 3 * executed})
        return state, log.records, counts

    try:
        base = RunConfig(model="caffenet", n_classes=n_classes, crop=crop,
                         solver=SolverConfig(**IMAGENET_SOLVER), tau=tau,
                         local_batch=batch, eval_every=0,
                         precision="bfloat16", seed=0, workdir=root,
                         checkpoint_every=2)
        dir_a, dir_b, dir_c = (os.path.join(root, d) for d in "abc")
        # 1. uninterrupted, synchronous writes
        full, _, c1 = run("uninterrupted", dataclasses.replace(
            base, max_rounds=4, checkpoint_dir=dir_a,
            checkpoint_async=False), 4)
        # 2. interrupted after round 2 and resumed, async writes
        _, _, c2a = run("first half", dataclasses.replace(
            base, max_rounds=2, checkpoint_dir=dir_b), 2)
        resumed, _, c2b = run("resumed", dataclasses.replace(
            base, max_rounds=4, checkpoint_dir=dir_b, resume=True), 2)
        for kind in ("params", "momentum"):
            a, b = getattr(full, kind), getattr(resumed, kind)
            bad = [f"{l}/{p}" for l in a for p in a[l]
                   if not torch.equal(a[l][p], b[l][p])]
            if bad:
                fail(f"checkpoint: the resumed run's {kind} differ from the "
                     f"uninterrupted run's: {bad}")
        if resumed.it != full.it:
            fail(f"checkpoint: resumed it {resumed.it} != {full.it}")
        sizes = {}
        for d in (dir_a, dir_b):
            for name in sorted(os.listdir(d)):
                path = os.path.join(d, name)
                if not ckpt.verify(path):
                    fail(f"checkpoint: {path} does not verify")
                sizes[f"{os.path.basename(d)}/{name}"] = _dir_bytes(path)
        metas = [json.load(open(os.path.join(d, "step-4", "meta.json")))
                 for d in (dir_a, dir_b)]
        if metas[0]["digests"] != metas[1]["digests"]:
            fail("checkpoint: step-4 digests of the uninterrupted and the "
                 "resumed run differ")
        print(f"checkpoint: the resumed run equals the uninterrupted one "
              f"(torch.equal on every param and momentum tensor, it "
              f"{full.it}); step-4 digests equal; every step verifies; "
              f"step sizes on disk in bytes {sizes} [{card}]", flush=True)

        # 4. weights: .caffemodel out of run 1's params, into a fresh net
        precision.set_policy("float32")
        spec128 = zoo.caffenet(batch=128, crop=crop, n_classes=n_classes)
        src = TorchNet(spec128, seed=0, device=device)
        src.params = {l: {p: t.detach().clone() for p, t in lp.items()}
                      for l, lp in full.params.items()}
        path = os.path.join(root, "caffenet.caffemodel")
        t0 = time.perf_counter()
        src.save_weights(path)
        t_save = time.perf_counter() - t0
        dst = TorchNet(spec128, seed=1, device=device)
        t0 = time.perf_counter()
        dst.load_weights(path)
        t_load = time.perf_counter() - t0
        rows = {"data": data[:128], "label": labels[:128]}
        a, b = src.forward(rows)["prob"], dst.forward(rows)["prob"]
        if not (np.array_equal(a, b) and np.isfinite(a).all()):
            fail(f"checkpoint: the .caffemodel round trip's bucket-128 "
                 f"forward differs (max abs {np.abs(a - b).max()})")
        print(f"checkpoint: .caffemodel of run 1's params "
              f"({os.path.getsize(path)} bytes) saved in {t_save:.3f}s, "
              f"loaded into a fresh net in {t_load:.3f}s; its bucket-128 "
              f"float32 forward equals the source net's bit for bit "
              f"[{card}]", flush=True)
        shutil.rmtree(dir_a)
        shutil.rmtree(dir_b)

        # 3. rollback: a NaN injected at round 3 (injection poisons float
        # inputs only, so this run's images are float32; the default
        # min_history keeps spike classification off for its 6 rounds)
        health = HealthConfig(inject_nan_rounds=(3,))
        train_ds = ArrayDataset({"data": data.astype(np.float32),
                                 "label": labels})
        roll, recs, c3 = run("rollback", dataclasses.replace(
            base, max_rounds=6, checkpoint_dir=dir_c, health=health), 8)
        events = [x for x in recs if x.get("event") == "rollback"]
        if len(events) != 1 or (events[0]["target_step"], events[0]["retry"],
                                events[0]["lr_scale"]) != \
                (2, 1, health.lr_backoff):
            fail(f"checkpoint: rollback events {events}, want one with "
                 f"target_step 2, retry 1, lr_scale {health.lr_backoff}")
        order = [x for x in recs if "loss" in x or x.get("event")]
        after = order[order.index(events[0]) + 1:]
        later = [x for x in after if "loss" in x]
        if [x["round"] for x in later] != [2, 3, 4, 5] or not all(
                x["loss"] is not None and math.isfinite(x["loss"])
                and x.get("nonfinite") == 0 for x in later):
            fail(f"checkpoint: rounds after the rollback {later}")
        if not all(bool(torch.isfinite(t).all()) for lp in
                   roll.params.values() for t in lp.values()):
            fail("checkpoint: the final params after the rollback are not "
                 "finite")
        tags = {}
        for name in sorted(os.listdir(dir_c)):
            extra = json.load(open(os.path.join(
                dir_c, name, "meta.json"))).get("extra", {})
            tags[name] = {"anomalous": extra.get("anomalous", False),
                          "health": extra.get("health")}
        # the monitor clears its anomaly window when it rolls back, so
        # the steps written after the incident are not tagged
        if tags.get("step-4") != {"anomalous": False, "health": {
                "retry": 1, "lr_scale": health.lr_backoff,
                "rollbacks": 1}} or tags.get("step-6", {}).get("anomalous"):
            fail(f"checkpoint: step tags after the rollback {tags}")
        print(f"checkpoint: one rollback to step 2 (retry 1, lr_scale "
              f"{health.lr_backoff}); rounds 2-5 after it finite with "
              f"nonfinite 0; final params finite; steps {tags} [{card}]",
              flush=True)
        ckpt.retain(dir_c, keep=2)
    finally:
        ckpt.save, ckpt.restore_flat, ckpt.restore_newest_verified = \
            originals[:3]
        ParallelTrainer.checkpoint_tree = originals[3]
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = \
            det
        precision.set_policy("float32")
        shutil.rmtree(root, ignore_errors=True)
    for t in timed:
        print(f"checkpoint: {t['what']}"
              + (f" step {t['step']}" if t["step"] is not None else "")
              + f": {t['s']:.3f}s"
              + (f", {t['bytes']} bytes" if t["bytes"] is not None else "")
              + f" (thread {t['thread']}) [{card}]", flush=True)
    return {"launches": {"uninterrupted": c1, "first half": c2a,
                         "resumed": c2b, "rollback": c3},
            "steps": steps_of, "timed": timed}


def _stats(xs) -> str:
    if not xs:
        return "n/a"
    return (f"median {statistics.median(xs):.3f} [min {min(xs):.3f}, max "
            f"{max(xs):.3f}]")


def write_corpus(data_dir: str, n_train: int = 2560, n_val: int = 256,
                 shards: int = 8, size: int = 256,
                 n_classes: int = 1000) -> None:
    """The ImageNet phases' corpus (module docstring, phase 6): JPEG tar
    shards of random pixels by `write_synthetic_shards` (PIL)."""
    from sparknet_tpu_torch.data.imagenet import write_synthetic_shards

    t0 = time.perf_counter()
    write_synthetic_shards(data_dir, n_shards=shards,
                           per_shard=n_train // shards,
                           n_classes=n_classes, size=size, seed=0)
    write_synthetic_shards(data_dir, n_shards=1, per_shard=n_val,
                           n_classes=n_classes, size=size, seed=1,
                           prefix="val")
    print(f"imagenet: corpus of {n_train} train JPEGs in {shards} "
          f"shards and {n_val} val JPEGs, {size}x{size}, written in "
          f"{time.perf_counter() - t0:.2f}s", flush=True)


def phase_imagenet(card: str, data_dir: str, device: str = "cuda",
                   crop: int = 227, batch: int = 256, tau: int = 5,
                   n_classes: int = 1000, n_val: int = 256, pairs: int = 2,
                   rounds: int = 4) -> dict:
    """Full-width CaffeNet through the ImageNet app on the JPEG shards of
    `write_corpus` in `data_dir` (module docstring, phase 6); returns each
    run's launch counts and steps, and the cached mean image. The
    arguments let the phase be rehearsed on the CPU at a small size
    (counts then 0)."""
    import argparse
    import dataclasses
    import glob
    import shutil
    import tempfile

    import numpy as np
    import torch

    from sparknet_tpu_torch.apps import imagenet_app
    from sparknet_tpu_torch.apps.train_loop import (prepare_round_batches,
                                                    resolve_spec, train)
    from sparknet_tpu_torch.data.dataset import RoundSampler
    from sparknet_tpu_torch.parallel.trainer import ParallelTrainer

    kernels = device == "cuda"
    root = tempfile.mkdtemp(prefix="chip_smoke_imagenet_")
    det = (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
    # the levers-on and levers-off runs must be bit-equal
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    launches, steps_of = {}, {}
    orig_round = ParallelTrainer.train_round
    try:
        common = [f"n_classes={n_classes}", f"crop={crop}",
                  f"local_batch={batch}", f"tau={tau}", "seed=0"]
        dev_args = ["--device", "cpu"] if device == "cpu" else []

        # 1. the app's own main(): one warm-up round and one evaluation
        work = os.path.join(root, "main")
        _zero_counts()
        t0 = time.perf_counter()
        imagenet_app.main(["--data-dir", data_dir, *dev_args, *common,
                           f"workdir={work}", "max_rounds=1",
                           "eval_every=1"])
        if device == "cuda":
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = _read_counts()
        (jsonl,) = glob.glob(os.path.join(work, "training_metrics_*.jsonl"))
        recs = [json.loads(line) for line in open(jsonl)]
        losses = [x for x in recs if "loss" in x]
        accs = [x for x in recs if "test_accuracy" in x]
        print(f"imagenet[main]: {len(losses)} round in {wall:.2f}s wall "
              f"(decode, mean and set-up included): loss "
              f"{[x['loss'] for x in losses]}, test accuracy "
              f"{[x['test_accuracy'] for x in accs]}, launches {counts} "
              f"[{card}]", flush=True)
        if len(losses) != 1 or not all(
                x["loss"] is not None and math.isfinite(x["loss"])
                and x.get("nonfinite") == 0 for x in losses):
            fail(f"imagenet[main]: round records {losses}")
        if len(accs) != 1:
            fail(f"imagenet[main]: no eval accuracy line in {recs}")
        evals = -(-n_val // min(1000, n_val))  # eval_batch 1000
        launches["main"], steps_of["main"] = counts, tau
        if kernels:
            _expect_counts("imagenet main", counts, {
                "lrn_fwd": 2 * tau + 2 * evals, "lrn_fwd_scale": 0,
                "lrn_bwd": 2 * tau, "maxpool_bwd": 3 * tau})

        # 2. the same prepared data through the same train(): levers on
        # (the defaults, the round-prep thread) and off (the synchronous
        # loop) in alternating pairs
        p = argparse.ArgumentParser()
        imagenet_app.add_data_args(p)
        args = p.parse_args(["--data-dir", data_dir])
        cfg = imagenet_app.default_config().with_overrides(
            *common, f"data_dir={data_dir}", f"max_rounds={rounds}",
            "eval_every=0", "log_every=1", "telemetry=true")
        train_ds, test_ds, pp_train, _, info = imagenet_app.prepare_data(
            cfg, args)
        print(f"imagenet: decode {info['decode_s']:.3f}s, mean image "
              f"{info['mean_s']:.3f}s for {len(train_ds)} images; "
              f"preprocessing route {info['route']} [{card}]", flush=True)
        spec = resolve_spec(cfg, data=(batch, 3, crop, crop),
                            label=(batch, 1))
        want = prepare_round_batches(
            RoundSampler(train_ds, 1, batch, tau, seed=cfg.seed), 0, tau,
            cfg.seed, pp_train, torch.bfloat16)
        settings = {
            "on": (dict(h2d_prefetch=True, donate_batches=True,
                        collect_async=True), True),
            "off": (dict(h2d_prefetch=False, donate_batches=False,
                         collect_async=False), False)}
        first = []

        def capture(self, state, batches, rng, lr_scale=1.0):
            out = orig_round(self, state, batches, rng, lr_scale)
            if not first:
                # synchronous copies: the round's slot is not reused yet
                first.append({k: (v.cpu() if isinstance(v, torch.Tensor)
                                  else torch.from_numpy(np.asarray(v)))
                              for k, v in batches.items()})
            return out

        ParallelTrainer.train_round = capture
        ref = None
        order = [("on", "off") if i % 2 == 0 else ("off", "on")
                 for i in range(pairs)]
        for i, (a, b) in enumerate(order):
            for name in (a, b):
                levers, prefetch = settings[name]
                label = f"{name} {i}"
                run_cfg = dataclasses.replace(
                    cfg, workdir=os.path.join(root, label.replace(" ", "_")),
                    **levers)
                log = _capture_logger()
                first.clear()
                if device == "cuda":
                    torch.cuda.synchronize()
                _zero_counts()
                t0 = time.perf_counter()
                state = train(run_cfg, spec, train_ds, None, logger=log,
                              batch_transform=pp_train, device=device,
                              prefetch=prefetch)
                if device == "cuda":
                    torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                counts = _read_counts()
                launches[label], steps_of[label] = counts, rounds * tau
                recs = [x for x in log.records if "loss" in x]
                if len(recs) != rounds or not all(
                        x["loss"] is not None and math.isfinite(x["loss"])
                        and x.get("nonfinite") == 0 for x in recs):
                    fail(f"imagenet[{label}]: round records {recs}")
                for x in recs:
                    print(f"imagenet[{label}]: round {x['round']} loss "
                          f"{x['loss']:.6f} round_s {x['round_s']:.4f} "
                          f"data {x['t_data_ms']:.2f} h2d "
                          f"{x['t_h2d_ms']:.2f} round {x['t_round_ms']:.2f} "
                          f"collect {x['t_collect_ms']:.2f} collect_bg "
                          f"{x.get('t_collect_bg_ms', 0.0):.2f} prep "
                          f"{x['t_prep_ms']:.2f} ms; h2d_bytes "
                          f"{int(x['h2d_bytes'])} [{card}]", flush=True)
                warm = recs[1:]
                ms = {k: [x[k] for x in warm if k in x] for k in (
                    "t_data_ms", "t_h2d_ms", "t_round_ms", "t_collect_ms",
                    "t_collect_bg_ms", "t_prep_ms")}
                rs = [x["round_s"] for x in warm]
                # what a round costs the loop: its own time and the wait
                # for round prep before it
                period = [x["round_s"] + x["t_data_ms"] / 1e3 for x in warm]
                print(f"imagenet[{label}]: levers {levers} prep thread "
                      f"{'on' if prefetch else 'off'}; {rounds} rounds in "
                      f"{wall:.2f}s wall; warm rounds: round_s "
                      f"{_stats(rs)}, "
                      + ", ".join(f"{k} {_stats(v)}" for k, v in ms.items())
                      + f"; {tau * batch / statistics.median(rs):.1f} img/s "
                      f"a round, {tau * batch / statistics.median(period):.1f}"
                      f" img/s a round and its data wait (median); route "
                      f"{info['route']}; launches "
                      f"{counts} [{card}]", flush=True)
                if kernels:
                    steps = rounds * tau
                    _expect_counts(f"imagenet {label}", counts, {
                        "lrn_fwd": 2 * steps, "lrn_fwd_scale": 0,
                        "lrn_bwd": 2 * steps, "maxpool_bwd": 3 * steps})
                got = first[0]
                bad = [k for k in want if not torch.equal(
                    got[k].reshape(-1), torch.as_tensor(
                        np.asarray(want[k]) if not isinstance(
                            want[k], torch.Tensor) else want[k]).reshape(-1))
                    or tuple(got[k].shape) != tuple(want[k].shape)]
                if bad:
                    fail(f"imagenet[{label}]: the first round's {bad} "
                         f"differ from prepare_round_batches on the host")
                mine = ([x["loss"] for x in recs],
                        state.flat_params.detach().clone())
                if ref is None:
                    ref = mine
                elif mine[0] != ref[0] or not torch.equal(mine[1], ref[1]):
                    fail(f"imagenet[{label}]: losses {mine[0]} or final "
                         f"params differ from the first run's {ref[0]}")
                del state
        print(f"imagenet: every run's losses and final flat params are "
              f"equal (torch.equal), and each run's first round equals "
              f"prepare_round_batches on the host [{card}]", flush=True)
    finally:
        ParallelTrainer.train_round = orig_round
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = \
            det
        shutil.rmtree(root, ignore_errors=True)
    return {"launches": launches, "steps": steps_of,
            "mean": pp_train.mean_image}


def _ulps(a, b) -> int:
    """The largest distance in float32 ulps between two float32 arrays of
    one sign (pixel means are positive)."""
    import numpy as np
    ia = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    ib = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return int(np.abs(ia - ib).max())


def _rss_mib() -> float:
    import resource
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024


def _as_tensor(v):
    import numpy as np
    import torch
    return v if isinstance(v, torch.Tensor) else torch.from_numpy(
        np.asarray(v))


def phase_stream(card: str, data_dir: str, cached_mean=None,
                 device: str = "cuda", crop: int = 227, batch: int = 256,
                 tau: int = 5, n_classes: int = 1000, n_val: int = 256,
                 rounds: int = 6, resume_at: int = 4,
                 bucket_rounds: int = 2) -> dict:
    """Full-width CaffeNet through the ImageNet app's streaming ingest on
    phase 6's corpus (module docstring, phase 7); returns each run's
    launch counts and steps. The arguments let the phase be rehearsed on
    the CPU at a small size (counts then 0)."""
    import argparse
    import dataclasses
    import glob
    import shutil
    import tempfile

    import numpy as np
    import torch

    from sparknet_tpu_torch.apps import imagenet_app
    from sparknet_tpu_torch.apps.train_loop import (prepare_round_batches,
                                                    resolve_spec, train)
    from sparknet_tpu_torch.data import imagenet
    from sparknet_tpu_torch.data.streaming import StreamingRoundSource
    from sparknet_tpu_torch.parallel.trainer import ParallelTrainer
    from sparknet_tpu_torch.utils import checkpoint as ckpt

    kernels = device == "cuda"
    root = tempfile.mkdtemp(prefix="chip_smoke_stream_")
    det = (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
    # the resumed run must be bit-equal to the uninterrupted one
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    launches, steps_of = {}, {}
    orig_round = ParallelTrainer.train_round
    common = [f"n_classes={n_classes}", f"crop={crop}",
              f"local_batch={batch}", f"tau={tau}", "seed=0"]
    per_round = tau * batch
    n_train = len(imagenet.ShardedTarLoader(
        imagenet.list_shards(data_dir, "train."),
        imagenet.load_label_map(os.path.join(data_dir, "train.txt")))
        .label_map)

    def sync():
        if device == "cuda":
            torch.cuda.synchronize()

    def round_lines(label, recs, decode=None):
        for i, x in enumerate(recs):
            period = x["round_s"] + x["t_data_ms"] / 1e3
            dec = (f" decode {decode[i]:.3f}s on the streaming thread"
                   if decode and i < len(decode) else "")
            print(f"stream[{label}]: round {x['round']} loss "
                  f"{x['loss']:.6f} round_s {x['round_s']:.4f} t_data_ms "
                  f"{x['t_data_ms']:.2f} t_prep_ms {x['t_prep_ms']:.2f} "
                  f"{per_round / period:.1f} img/s with the data wait"
                  f"{dec} [{card}]", flush=True)
        bad = [x for x in recs if x["loss"] is None
               or not math.isfinite(x["loss"]) or x.get("nonfinite") != 0]
        if bad:
            fail(f"stream[{label}]: round records {bad}")

    try:
        dev_args = ["--device", "cpu"] if device == "cpu" else []
        # 1. the app's own main(), streaming: one round and one evaluation
        work, ck_main = os.path.join(root, "main"), os.path.join(root, "ckm")
        _zero_counts()
        t0 = time.perf_counter()
        imagenet_app.main(["--data-dir", data_dir, "--stream", "always",
                           *dev_args, *common, f"workdir={work}",
                           "max_rounds=1", "eval_every=1",
                           f"checkpoint_dir={ck_main}", "checkpoint_every=0"])
        sync()
        wall = time.perf_counter() - t0
        counts = _read_counts()
        (jsonl,) = glob.glob(os.path.join(work, "training_metrics_*.jsonl"))
        recs = [json.loads(line) for line in open(jsonl)]
        losses = [dict(x, round=x["step"]) for x in recs if "loss" in x]
        accs = [x for x in recs if "test_accuracy" in x]
        round_lines("main", losses)
        with np.load(os.path.join(ck_main, "mean_image.npz")) as z:
            mean = z["mean"]
        ulps = _ulps(mean, cached_mean) if cached_mean is not None else None
        print(f"stream[main]: {len(losses)} round in {wall:.2f}s wall "
              f"(the streamed mean pass and set-up included), test accuracy "
              f"{[x['test_accuracy'] for x in accs]}, launches {counts}; "
              f"streamed mean image vs phase 6's cached mean: {ulps} "
              f"float32 ulp at most; peak RSS {_rss_mib():.0f} MiB (the "
              f"process so far) [{card}]", flush=True)
        if len(losses) != 1 or len(accs) != 1:
            fail(f"stream[main]: records {recs}")
        if ulps is not None and ulps > 1:
            fail(f"stream[main]: the streamed mean image is {ulps} ulp from "
                 f"the cached one (limit 1)")
        evals = -(-n_val // min(1000, n_val))  # eval_batch 1000
        launches["main"], steps_of["main"] = counts, tau
        if kernels:
            _expect_counts("stream main", counts, {
                "lrn_fwd": 2 * tau + 2 * evals, "lrn_fwd_scale": 0,
                "lrn_bwd": 2 * tau, "maxpool_bwd": 3 * tau})
        shutil.rmtree(os.path.join(ck_main, "step-1"), ignore_errors=True)

        # 2. resume through the stream cursor
        p = argparse.ArgumentParser()
        imagenet_app.add_data_args(p)
        args = p.parse_args(["--data-dir", data_dir, "--stream", "always"])
        cfg = imagenet_app.default_config().with_overrides(
            *common, f"data_dir={data_dir}", "eval_every=0", "log_every=1",
            "telemetry=true", "checkpoint_every=2")
        spec = resolve_spec(cfg, data=(batch, 3, crop, crop),
                            label=(batch, 1))
        first = []

        def stream_run(label, max_rounds, ckdir=None, ingest=2):
            if ckdir:  # the mean sidecar: no second corpus pass
                os.makedirs(ckdir, exist_ok=True)
                shutil.copy(os.path.join(ck_main, "mean_image.npz"), ckdir)
            run_cfg = dataclasses.replace(
                cfg, workdir=os.path.join(root, label),
                max_rounds=max_rounds, checkpoint_dir=ckdir,
                ingest_sources=ingest)
            src, _, pp, _, _ = imagenet_app.prepare_data(run_cfg, args)
            loaders = getattr(src, "loaders", None) or [src.loader]
            dec_at = []

            def capture(self, state, batches, rng, lr_scale=1.0):
                dec_at.append(sum(ld.decode_s for ld in loaders))
                out = orig_round(self, state, batches, rng, lr_scale)
                if not first:
                    first.append({k: _as_tensor(v).cpu()
                                  for k, v in batches.items()})
                return out

            ParallelTrainer.train_round = capture
            log = _capture_logger()
            first.clear()
            sync()
            _zero_counts()
            t0 = time.perf_counter()
            try:
                state = train(run_cfg, spec, src, None, logger=log,
                              batch_transform=pp, device=device)
            finally:
                ParallelTrainer.train_round = orig_round
                src.close()
            sync()
            wall = time.perf_counter() - t0
            counts = _read_counts()
            recs = [x for x in log.records if "loss" in x]
            decode = [b - a for a, b in zip([0.0] + dec_at, dec_at)]
            round_lines(label, recs, decode)
            n_steps = len(recs) * tau
            launches[label], steps_of[label] = counts, n_steps
            print(f"stream[{label}]: {len(recs)} rounds in {wall:.2f}s wall, "
                  f"{len(loaders)} reader(s), decode "
                  f"{sum(ld.decode_s for ld in loaders):.2f}s in all on the "
                  f"streaming thread(s), launches {counts}; peak RSS "
                  f"{_rss_mib():.0f} MiB [{card}]", flush=True)
            if kernels:
                _expect_counts(f"stream {label}", counts, {
                    "lrn_fwd": 2 * n_steps, "lrn_fwd_scale": 0,
                    "lrn_bwd": 2 * n_steps, "maxpool_bwd": 3 * n_steps})
            return state, recs, pp

        ck_full, ck_part = (os.path.join(root, "ck_full"),
                            os.path.join(root, "ck_part"))
        full, full_recs, _ = stream_run("full", rounds, ck_full)
        got = first[0]  # the first round as train_round received it
        _, part_recs, _ = stream_run("part", resume_at, ck_part)
        resumed, res_recs, _ = stream_run("resumed", rounds, ck_part)
        for name, d in (("full", ck_full), ("part", ck_part)):
            for step in ckpt._list_steps(d):
                extra = ckpt.restore_flat(d, step=step)[2]
                print(f"stream[{name}]: step {step} stream cursor "
                      f"{extra.get('stream')} [{card}]", flush=True)
        # the cursor after round resume_at's data, per reader (shards
        # j::2): whole passes over its shards and the entry of the last
        # image it took
        readers = 2
        seen = resume_at * per_round // readers
        ep, rem = divmod(seen - 1, n_train // readers)
        per_shard = n_train // len(imagenet.list_shards(data_dir, "train."))
        want_rows = [[[rem // per_shard, rem % per_shard + 1, ep]]
                     * readers]
        got_rows = ckpt.restore_flat(ck_part, step=resume_at)[2]["stream"]
        full_rows = ckpt.restore_flat(ck_full, step=resume_at)[2]["stream"]
        if not got_rows == full_rows == want_rows:
            fail(f"stream: step {resume_at} cursor {got_rows} (uninterrupted "
                 f"{full_rows}), want the cursor after round {resume_at}'s "
                 f"data {want_rows}")
        same = (torch.equal(resumed.flat_params, full.flat_params)
                and torch.equal(resumed.flat_momentum, full.flat_momentum)
                and [x["loss"] for x in res_recs]
                == [x["loss"] for x in full_recs][resume_at:])
        if not same:
            fail("stream: the resumed run's params, momentum or losses "
                 "differ from the uninterrupted run's")
        print(f"stream: the run resumed at step {resume_at} equals the "
              f"uninterrupted one (torch.equal, params and momentum; equal "
              f"losses); step {resume_at}'s cursor {got_rows} is the one "
              f"after round {resume_at}'s data [{card}]", flush=True)

        # 3. two readers (the runs above): the first round as train_round
        # received it, against the host's prepare_round_batches
        cfg2 = dataclasses.replace(cfg, ingest_sources=2,
                                   checkpoint_dir=ck_full)
        src2, _, pp2, _, _ = imagenet_app.prepare_data(cfg2, args)
        with src2:
            want = prepare_round_batches(src2, 0, tau, cfg.seed, pp2,
                                         torch.bfloat16)
        bad = [k for k in want if not torch.equal(
            got[k].reshape(-1), _as_tensor(want[k]).reshape(-1))
            or tuple(got[k].shape) != tuple(want[k].shape)]
        if bad or len(src2.loaders) != 2:
            fail(f"stream[full]: the first round's {bad} differ from "
                 f"prepare_round_batches on the host ({len(src2.loaders)} "
                 f"readers)")
        print(f"stream[full]: 2 readers; the first round on the card "
              f"equals prepare_round_batches on the host [{card}]",
              flush=True)

        # 4. the same shards from a gs:// bucket (the fake GCS of
        # tests/fake_stores.py on localhost) and a checkpoint there
        sys.path.insert(0, os.path.join(os.path.dirname(
            os.path.abspath(__file__)), "tests"))
        from fake_stores import serve_dir_for_ingest, stop_serving
        t0 = time.perf_counter()
        srv, url = serve_dir_for_ingest(data_dir)
        try:
            labels = imagenet.load_label_map(f"{url}/train.txt")

            def source(where):
                return StreamingRoundSource(imagenet.ShardedTarLoader(
                    imagenet.list_shards(where, "train."), labels), 1,
                    batch, tau)

            with source(url) as g, source(data_dir) as l:
                for r in range(bucket_rounds):
                    gr, lr = (g.next_round(round_index=r),
                              l.next_round(round_index=r))
                    if not (all(np.array_equal(gr[k], lr[k]) for k in lr)
                            and g.cursor_at(r) == l.cursor_at(r)):
                        fail(f"stream[gs]: round {r} over gs:// differs "
                             f"from the local stream's")
            read_s = time.perf_counter() - t0
            flat, step, extra = ckpt.restore_flat(ck_full)
            t0 = time.perf_counter()
            ckpt.save("gs://bkt/ck", flat, step=step, extra=extra)
            save_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            gflat, gstep, gextra = ckpt.restore_flat("gs://bkt/ck")
            load_s = time.perf_counter() - t0
            diff = [k for k in flat if not torch.equal(
                _as_tensor(flat[k]), _as_tensor(gflat[k]))]
            if gstep != step or diff or sorted(gflat) != sorted(flat) or \
                    gextra.get("stream") != extra.get("stream"):
                fail(f"stream[gs]: the bucket step differs: {diff[:5]}")
            print(f"stream[gs]: {bucket_rounds} rounds over gs:// equal the "
                  f"local stream's bit for bit ({read_s:.2f}s with the "
                  f"server's start); step {step} saved to gs:// in "
                  f"{save_s:.2f}s, restored in {load_s:.2f}s, every tensor "
                  f"equal to the local step's; peak RSS {_rss_mib():.0f} MiB "
                  f"[{card}]", flush=True)
        finally:
            stop_serving(srv)
    finally:
        ParallelTrainer.train_round = orig_round
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = \
            det
        shutil.rmtree(root, ignore_errors=True)
    return {"launches": launches, "steps": steps_of}

#: the heartbeat schema both packages write (`utils/heartbeat.py`): every
#: beat's own keys, the elastic loop's, and the pod heartbeat's
HEARTBEAT_KEYS = {"t", "pid", "role", "step", "status", "rollbacks"}
ELASTIC_BEAT_KEYS = {"membership_epoch", "n_members"}
POD_BEAT_KEYS = {"worker", "n_workers", "round_s", "data_wait_s"}


def phase_elastic(card: str, phase4_round_s=None, device: str = "cuda",
                  crop: int = 227, batch: int = 256, tau: int = 5,
                  n_classes: int = 1000, kill_after: int = 3) -> dict:
    """A watched elastic run and the 4 -> 1 resume of full-width CaffeNet
    (module docstring, phase 8); returns each run's launch counts and
    executed steps. The arguments let the phase be rehearsed on the CPU
    at a small size (counts then 0)."""
    import dataclasses
    import shutil
    import tempfile
    import threading
    import urllib.request

    import numpy as np
    import torch

    from sparknet_tpu_torch import zoo
    from sparknet_tpu_torch.apps.train_loop import train
    from sparknet_tpu_torch.data.dataset import ArrayDataset
    from sparknet_tpu_torch.model.net import CompiledNet, params_from_jax
    from sparknet_tpu_torch.obs.pod import worker_heartbeat_path
    from sparknet_tpu_torch.obs.registry import MetricsRegistry
    from sparknet_tpu_torch.parallel.elastic import ElasticRelaunch
    from sparknet_tpu_torch.parallel.trainer import (ParallelTrainer,
                                                     reduce_momentum_rows)
    from sparknet_tpu_torch.solver import SolverConfig
    from sparknet_tpu_torch.utils import checkpoint as ckpt
    from sparknet_tpu_torch.utils.config import ElasticConfig, RunConfig
    from sparknet_tpu_torch.utils.heartbeat import HeartbeatWriter

    r = np.random.default_rng(8)
    n = tau * batch
    data = r.integers(-128, 128, (n, crop, crop, 3), dtype=np.int8)
    labels = r.integers(0, n_classes, (n, 1)).astype(np.int32)
    train_ds = ArrayDataset({"data": data, "label": labels})
    spec = zoo.caffenet(batch=batch, crop=crop, n_classes=n_classes)
    kernels = device == "cuda"
    root = tempfile.mkdtemp(prefix="chip_smoke_elastic_")
    pod_dir = os.path.join(root, "pod")
    ck_a, ck_b = os.path.join(root, "ck_watched"), os.path.join(root, "ck4")
    det = (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    originals = (ckpt.save, ckpt.restore_flat, HeartbeatWriter.beat,
                 ParallelTrainer.train_round,
                 ParallelTrainer.state_from_checkpoint,
                 MetricsRegistry.render_prometheus)
    saves, beats, budgets, restored, renders = [], [], [], [], []
    lock = threading.Lock()

    def save(directory, tree, *, step, extra=None):
        t0 = time.perf_counter()
        path = originals[0](directory, tree, step=step, extra=extra)
        with lock:
            saves.append({"step": step, "s": time.perf_counter() - t0,
                          "bytes": _dir_bytes(path), "dir": directory,
                          "thread": threading.current_thread().name})
        return path

    def beat(self, step, *a, **kw):
        t0 = time.perf_counter()
        wrote = originals[2](self, step, *a, **kw)
        with lock:
            beats.append({"step": step, "s": time.perf_counter() - t0,
                          "path": self.path})
        return wrote

    def train_round(self, state, batches, rng, lr_scale=1.0,
                    tau_by_worker=None):
        budgets.append(None if tau_by_worker is None
                       else list(tau_by_worker))
        return originals[3](self, state, batches, rng, lr_scale=lr_scale,
                            tau_by_worker=tau_by_worker)

    def render_prometheus(self):
        t0 = time.perf_counter()
        text = originals[5](self)
        renders.append((time.perf_counter() - t0) * 1e3)
        return text

    def state_from_checkpoint(self, flat, *a, **kw):
        st = originals[4](self, flat, *a, **kw)
        restored.append({kind: {l: {p: t.detach().clone()
                                    for p, t in lp.items()}
                                for l, lp in getattr(st, kind).items()}
                         for kind in ("params", "momentum")})
        return st

    ckpt.save = save
    HeartbeatWriter.beat = beat
    ParallelTrainer.train_round = train_round
    ParallelTrainer.state_from_checkpoint = state_from_checkpoint
    MetricsRegistry.render_prometheus = render_prometheus

    #: the loop's own heartbeats (the nominal worker 1's are the smoke's)
    own_beats = {os.path.join(root, "hb.json"),
                 worker_heartbeat_path(pod_dir, 0)}

    def per_round_counts(label, log, counts_by_round):
        """Each round's launches against its executed steps."""
        rounds = [x for x in log.records if "loss" in x]
        out = []
        for x in rounds:
            rnd = x["round"]
            vec = budgets[rnd - rounds[0]["round"]]
            executed = tau if vec is None else vec[0]
            got = counts_by_round[rnd]
            mine = [b for b in beats if b["step"] == rnd
                    and b["path"] in own_beats]
            print(f"elastic[{label}]: round {rnd} loss {x['loss']:.6f} "
                  f"tau vector {vec} (executed {executed} steps) round_s "
                  f"{x['round_s'] * 1e3:.2f} ms t_round_ms "
                  f"{x.get('t_round_ms')} boundary: t_member_ms "
                  f"{x.get('t_member_ms')} + the loop's beats "
                  f"{sum(b['s'] for b in mine) * 1e3:.3f} ms "
                  f"({len(mine)} beats) launches {got} [{card}]",
                  flush=True)
            if not (math.isfinite(x["loss"]) and x.get("nonfinite") == 0):
                fail(f"elastic[{label}] round {rnd}: loss {x['loss']}, "
                     f"nonfinite {x.get('nonfinite')}")
            if kernels and got != {"lrn_fwd": 2 * executed,
                                   "lrn_fwd_scale": 0,
                                   "lrn_bwd": 2 * executed,
                                   "maxpool_bwd": 3 * executed}:
                fail(f"elastic[{label}] round {rnd}: launches {got} for "
                     f"{executed} executed steps")
            out.append({"round": rnd, "executed": executed,
                        "round_s": x["round_s"],
                        "member_ms": x.get("t_member_ms"),
                        "beat_ms": sum(b["s"] for b in mine) * 1e3})
        return rounds, out

    def counting_hook(counts_by_round, extra=None):
        last = [_read_counts()]

        def hook(rnd, state):
            now = _read_counts()
            counts_by_round[rnd] = {k: now[k] - last[0][k] for k in now}
            last[0] = now
            if extra is not None:
                extra(rnd, state)
        return hook

    try:
        base = RunConfig(model="caffenet", n_classes=n_classes, crop=crop,
                         solver=SolverConfig(**IMAGENET_SOLVER), tau=tau,
                         local_batch=batch, eval_every=0,
                         precision="bfloat16", seed=0, workdir=root,
                         heartbeat_every_s=0.0, pod_dir=pod_dir)
        elastic = ElasticConfig(enabled=True, expected_workers=2,
                                min_workers=1, tau_adapt=True,
                                poll_interval_s=0.0, reprobe_backoff_s=0.0,
                                dead_probes=2)
        # run "watched": a nominal worker 1 beats a small round_s (so
        # this rank is the slow one and gets a shorter τ) until
        # kill_after, then its beat is backdated
        hb1 = HeartbeatWriter(worker_heartbeat_path(pod_dir, 1),
                              interval_s=0.0)
        hb1.beat(0, status="ok", round_s=0.001, force=True)
        cfg = dataclasses.replace(
            base, max_rounds=kill_after + 8, status_port=0, pod_port=0,
            heartbeat_path=os.path.join(root, "hb.json"),
            checkpoint_dir=ck_a, checkpoint_every=2, elastic=elastic)
        scraped = {}

        def watch(rnd, state):
            if rnd < kill_after:
                hb1.beat(rnd, status="ok", round_s=0.001, force=True)
            elif rnd == kill_after:
                p = worker_heartbeat_path(pod_dir, 1)
                rec = json.load(open(p))
                rec["t"] = time.time() - 1e4
                json.dump(rec, open(p, "w"))
            if rnd == 2:
                host, port = cfg.status_address
                t0 = time.perf_counter()
                scraped["metrics"] = urllib.request.urlopen(
                    f"http://{host}:{port}/metrics", timeout=30
                ).read().decode()
                scraped["metrics_ms"] = (time.perf_counter() - t0) * 1e3
                scraped["render_ms"] = renders[-1]
                host, port = cfg.pod_address
                scraped["pod"] = json.loads(urllib.request.urlopen(
                    f"http://{host}:{port}/pod/status", timeout=30).read())

        log = _capture_logger()
        counts_a = {}
        _zero_counts()
        t0 = time.perf_counter()
        try:
            train(cfg, spec, train_ds, None, logger=log, device=device,
                  round_hook=counting_hook(counts_a, watch))
            fail("elastic[watched]: the run ended without a relaunch")
        except ElasticRelaunch as e:
            code, reason = e.code, e.reason
        wall = time.perf_counter() - t0
        rounds_a, table_a = per_round_counts("watched", log, counts_a)
        events = [x for x in log.records if x.get("event") == "resize"]
        boundary = kill_after + 3  # suspected, probed twice, evicted
        if code != 75 or len(events) != 1 or events[0]["dead"] != ["1"] \
                or events[0]["round"] != boundary:
            fail(f"elastic[watched]: exit code {code}, resize events "
                 f"{events}; want 75 and one eviction of worker 1 at round "
                 f"{boundary}")
        if [x["round"] for x in rounds_a] != list(range(boundary)):
            fail(f"elastic[watched]: rounds {[x['round'] for x in rounds_a]}")
        short = [x for x in table_a if x["executed"] < tau]
        if not short:
            fail(f"elastic[watched]: no round ran under a τ vector below "
                 f"{tau}: {budgets}")
        step_dir = os.path.join(ck_a, f"step-{boundary}")
        boundary_saves = [s for s in saves if s["dir"] == ck_a
                          and s["step"] == boundary
                          and s["thread"] == "MainThread"]
        if not (ckpt.verify(step_dir) and boundary_saves):
            fail(f"elastic[watched]: no verified boundary step {step_dir} "
                 f"written by the loop at the boundary ({saves})")
        families = {line.split()[2] for line in
                    scraped.get("metrics", "").splitlines()
                    if line.startswith("# TYPE ")}
        want_fams = {"sparknet_train_round", "sparknet_train_loss",
                     "sparknet_train_rounds_total",
                     "sparknet_train_round_seconds",
                     "sparknet_train_data_wait_seconds",
                     "sparknet_pod_membership_epoch", "sparknet_pod_members",
                     "sparknet_device_hbm_bytes_in_use",
                     "sparknet_heartbeat_beats_total",
                     "sparknet_build_info"}
        pod = scraped.get("pod", {})
        if not want_fams <= families or \
                [w["worker"] for w in pod.get("workers", [])] != ["0", "1"] \
                or pod.get("membership_epoch") != 0:
            fail(f"elastic[watched]: /metrics lacks "
                 f"{sorted(want_fams - families)} or /pod/status {pod}")
        hbm = [line for line in scraped["metrics"].splitlines()
               if line.startswith("sparknet_device_hbm_")]
        beats_on_disk = {
            "heartbeat_path": json.load(open(cfg.heartbeat_path)),
            "pod worker 0": json.load(open(worker_heartbeat_path(pod_dir,
                                                                 0)))}
        for name, rec in beats_on_disk.items():
            want = HEARTBEAT_KEYS | ELASTIC_BEAT_KEYS | (
                POD_BEAT_KEYS if name.startswith("pod") else set())
            if not want <= set(rec) or rec["status"] != "resize" or \
                    rec["membership_epoch"] != 1 or rec["step"] != boundary:
                fail(f"elastic[watched]: {name} heartbeat {rec}")
        print(f"elastic[watched]: exit code {code} at round {boundary} "
              f"({reason}); {len(rounds_a)} rounds in {wall:.2f}s wall, "
              f"{len(short)} under a shorter τ "
              f"({sorted({x['executed'] for x in short})} steps); "
              f"verified boundary step {boundary}; /metrics over HTTP "
              f"from the round hook {scraped['metrics_ms']:.2f} ms, of "
              f"which the registry's render "
              f"{scraped['render_ms']:.3f} ms ({len(families)} families; "
              f"{hbm}); /pod/status workers "
              f"{[(w['worker'], w['round_s']) for w in pod['workers']]} "
              f"epoch {pod['membership_epoch']}; heartbeats "
              f"{ {k: sorted(v) for k, v in beats_on_disk.items()} } "
              f"[{card}]", flush=True)
        warm = [x["round_s"] for x in table_a[1:]]
        print(f"elastic[watched]: round_s {_stats(warm)} s over "
              f"{len(warm)} rounds (τ vector rounds included) against "
              f"phase 4's {_stats(phase4_round_s or [])} s; the boundary "
              f"(poll + decision) t_member_ms "
              f"{_stats([x['member_ms'] for x in table_a[1:]])}, beats "
              f"{_stats([x['beat_ms'] for x in table_a[1:]])} ms a round "
              f"[{card}]", flush=True)

        # run "resume 4 -> 1": the boundary step rewritten as a 4-rank
        # replica step, momentum rows the run's times seeded factors
        flat, step, extra = originals[1](ck_a)
        net = CompiledNet.compile(spec)
        fr = np.random.default_rng(9)
        factors = fr.uniform(0.5, 1.5, 4).astype(np.float32)
        tree = {"params": {}, "momentum": {}, "it": np.full(
            (4,), int(np.asarray(flat["it"])[0]), np.int32)}
        expect = {"params": {}, "momentum": {}}
        for key, a in flat.items():
            if key == "it":
                continue
            kind, l, p = key.split("/")
            a = np.asarray(a)
            rows = (np.broadcast_to(a[:1], (4,) + a.shape[1:])
                    if kind == "params" else
                    np.stack([a[0] * f for f in factors]))
            tree[kind].setdefault(l, {})[p] = rows
            expect[kind].setdefault(l, {})[p] = (
                rows[0] if kind == "params"
                else reduce_momentum_rows(rows, "norm_rescale"))
        t0 = time.perf_counter()
        path4 = originals[0](ck_b, tree, step=step,
                             extra=dict(extra, n_devices=4))
        t_save4 = time.perf_counter() - t0
        bytes4 = _dir_bytes(path4)
        del tree, flat
        t0 = time.perf_counter()
        originals[1](ck_b)
        t_restore4 = time.perf_counter() - t0
        budgets.clear()
        restored.clear()
        log = _capture_logger()
        counts_b = {}
        _zero_counts()
        t0 = time.perf_counter()
        train(dataclasses.replace(base, max_rounds=step + 2,
                                  checkpoint_dir=ck_b, checkpoint_every=0,
                                  resume=True, elastic=elastic),
              spec, train_ds, None, logger=log, device=device,
              round_hook=counting_hook(counts_b))
        wall_b = time.perf_counter() - t0
        rounds_b, table_b = per_round_counts("resume 4->1", log, counts_b)
        resumed = [m for m in log.lines if "ELASTIC resume" in m]
        if not resumed or [x["round"] for x in rounds_b] != \
                [step, step + 1] or len(restored) != 1:
            fail(f"elastic[resume 4->1]: log {resumed}, rounds "
                 f"{[x['round'] for x in rounds_b]}, restores "
                 f"{len(restored)}")
        dev = torch.device(device)
        for kind in ("params", "momentum"):
            want = params_from_jax(net, expect[kind], dev)
            bad = [f"{l}/{p}" for l, lp in want.items() for p, w in lp.items()
                   if not torch.equal(restored[0][kind][l][p], w)]
            if bad:
                fail(f"elastic[resume 4->1]: restored {kind} differ from "
                     f"{'row 0' if kind == 'params' else 'reduce_momentum_rows(rows, norm_rescale)'}: {bad}")
        print(f"elastic[resume 4->1]: {resumed[0]}; restored params "
              f"torch.equal to the step's row 0, momentum torch.equal to "
              f"reduce_momentum_rows(4 rows, norm_rescale) (factors "
              f"{factors.tolist()}); the 4-row step {bytes4} bytes, saved "
              f"in {t_save4:.3f}s, restored in {t_restore4:.3f}s; "
              f"{len(rounds_b)} rounds in {wall_b:.2f}s wall [{card}]",
              flush=True)
        for s in saves:
            print(f"elastic: save step {s['step']} of "
                  f"{os.path.basename(s['dir'])} on {s['thread']}: "
                  f"{s['s']:.3f}s, {s['bytes']} bytes"
                  + (" (the boundary save)" if s in boundary_saves else "")
                  + f" [{card}]", flush=True)
    finally:
        ckpt.save = originals[0]
        HeartbeatWriter.beat = originals[2]
        ParallelTrainer.train_round = originals[3]
        ParallelTrainer.state_from_checkpoint = originals[4]
        MetricsRegistry.render_prometheus = originals[5]
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = \
            det
        shutil.rmtree(root, ignore_errors=True)
    launches_a = {k: sum(c[k] for c in counts_a.values())
                  for k in _read_counts()}
    launches_b = {k: sum(c[k] for c in counts_b.values())
                  for k in _read_counts()}
    return {"launches": {"watched": launches_a, "resume 4->1": launches_b},
            "steps": {"watched": sum(x["executed"] for x in table_a),
                      "resume 4->1": sum(x["executed"] for x in table_b)},
            "rounds": {"watched": table_a, "resume 4->1": table_b},
            "boundary_save_s": boundary_saves[0]["s"],
            "boundary_save_bytes": boundary_saves[0]["bytes"],
            "step4_bytes": bytes4, "step4_restore_s": t_restore4,
            "metrics_ms": scraped["metrics_ms"],
            "render_ms": scraped["render_ms"]}


#: phase 10's supervised child: phase 8's watched configuration with
#: per-shard checkpoints, one launch of `train()` under the relaunch
#: supervisor. argv: the repo root, then a JSON spec. It prints one line
#: "phase10-child: {json}" with its launch counts and executed steps, and
#: leaves with the loop's exit code (75 at the membership change).
CHILD_SHARDED = r"""
import time
t_proc0 = time.time()
import json, os, sys
root, spec = sys.argv[1], json.loads(sys.argv[2])
sys.path.insert(0, root)
import numpy as np
import torch
from sparknet_tpu_torch import zoo
from sparknet_tpu_torch.apps.train_loop import train
from sparknet_tpu_torch.data.dataset import ArrayDataset
from sparknet_tpu_torch.obs.pod import worker_heartbeat_path
from sparknet_tpu_torch.ops.cuda_lrn import lrn_bwd, lrn_fwd
from sparknet_tpu_torch.ops.cuda_pool import maxpool_bwd
from sparknet_tpu_torch.parallel.elastic import ElasticRelaunch
from sparknet_tpu_torch.parallel.trainer import ParallelTrainer
from sparknet_tpu_torch.solver import SolverConfig
from sparknet_tpu_torch.utils import checkpoint as ckpt
from sparknet_tpu_torch.utils.config import ElasticConfig, RunConfig
from sparknet_tpu_torch.utils.heartbeat import HeartbeatWriter
from sparknet_tpu_torch.utils.logger import Logger

torch.backends.cudnn.deterministic = True
torch.backends.cudnn.benchmark = False
crop, batch, tau, ncls = (spec[k] for k in ("crop", "batch", "tau",
                                            "n_classes"))
r = np.random.default_rng(8)
data = r.integers(-128, 128, (tau * batch, crop, crop, 3), dtype=np.int8)
labels = r.integers(0, ncls, (tau * batch, 1)).astype(np.int32)
relaunched = os.environ.get("SPARKNET_ELASTIC_RELAUNCH") == "1"
pod = spec["pod_dir"]
hb1 = HeartbeatWriter(worker_heartbeat_path(pod, 1), interval_s=0.0)
if not relaunched:
    hb1.beat(0, status="ok", round_s=0.001, force=True)
budgets = []
real_round = ParallelTrainer.train_round


def train_round(self, state, batches, rng, lr_scale=1.0, tau_by_worker=None):
    budgets.append(tau if tau_by_worker is None else int(tau_by_worker[0]))
    return real_round(self, state, batches, rng, lr_scale=lr_scale,
                      tau_by_worker=tau_by_worker)


ParallelTrainer.train_round = train_round


def hook(rnd, state):
    if relaunched:
        return
    if rnd < spec["kill_after"]:
        hb1.beat(rnd, status="ok", round_s=0.001, force=True)
    elif rnd == spec["kill_after"]:
        p = worker_heartbeat_path(pod, 1)
        rec = json.load(open(p))
        rec["t"] = time.time() - 1e4
        json.dump(rec, open(p, "w"))


cfg = RunConfig(model="caffenet", n_classes=ncls, crop=crop,
                solver=SolverConfig(**spec["solver"]), tau=tau,
                local_batch=batch, eval_every=0, precision="bfloat16",
                seed=0, workdir=spec["workdir"], heartbeat_every_s=0.0,
                pod_dir=pod, max_rounds=spec["max_rounds"], status_port=0,
                pod_port=0, heartbeat_path=os.path.join(spec["workdir"],
                                                        "hb.json"),
                checkpoint_dir=spec["ck"], checkpoint_every=2,
                checkpoint_sharded="on", elastic=ElasticConfig(
                    enabled=True, expected_workers=2, min_workers=1,
                    tau_adapt=True, poll_interval_s=0.0,
                    reprobe_backoff_s=0.0, dead_probes=2))
log_path = os.path.join(spec["workdir"],
                        "relaunch.txt" if relaunched else "first.txt")
log = Logger(log_path, echo=False)
lrn_fwd.launches = lrn_fwd.scale_launches = lrn_fwd.bf16_launches = 0
lrn_bwd.launches = maxpool_bwd.launches = 0
out = {"relaunched": relaunched, "code": 0, "t_proc0": t_proc0,
       "t_train0": time.time()}
try:
    train(cfg, zoo.caffenet(batch=batch, crop=crop, n_classes=ncls),
          ArrayDataset({"data": data, "label": labels}), None, logger=log,
          device=spec["device"], round_hook=hook)
except ElasticRelaunch as e:
    out["code"] = e.code
    raise
finally:
    log.close()
    out.update(
        t_end=time.time(),
        counts={"lrn_fwd": lrn_fwd.launches,
                "lrn_fwd_scale": lrn_fwd.scale_launches,
                "lrn_bwd": lrn_bwd.launches,
                "maxpool_bwd": maxpool_bwd.launches},
        executed=sum(budgets), rounds=len(budgets),
        elastic_resume=any("ELASTIC resume" in line
                           for line in open(log_path)),
        steps={s: ckpt.verify(os.path.join(spec["ck"], f"step-{s}"))
               and "shards" in json.load(open(os.path.join(
                   spec["ck"], f"step-{s}", "meta.json")))
               for s in ckpt._list_steps(spec["ck"])})
    print("phase10-child: " + json.dumps(out), flush=True)
"""


def phase_sharded(card: str, device: str = "cuda", crop: int = 227,
                  batch: int = 256, tau: int = 5, n_classes: int = 1000,
                  kill_after: int = 3) -> dict:
    """Per-shard checkpoints, the host trace, the profiler, the relaunch
    supervisor and a per-shard step served (module docstring, phase 10);
    returns each run's launch counts and executed steps. The arguments
    let the phase be rehearsed on the CPU at a small size (counts then
    0)."""
    import dataclasses
    import shutil
    import tempfile
    import threading

    import numpy as np
    import torch

    from sparknet_tpu_torch import precision, zoo
    from sparknet_tpu_torch.apps.train_loop import train
    from sparknet_tpu_torch.data.dataset import ArrayDataset
    from sparknet_tpu_torch.net_api import TorchNet
    from sparknet_tpu_torch.parallel.trainer import ParallelTrainer
    from sparknet_tpu_torch.serve.model_manager import ModelManager
    from sparknet_tpu_torch.solver import SolverConfig
    from sparknet_tpu_torch.utils import checkpoint as ckpt
    from sparknet_tpu_torch.utils.config import RunConfig

    r = np.random.default_rng(10)
    n = tau * batch
    data = r.integers(-128, 128, (n, crop, crop, 3), dtype=np.int8)
    labels = r.integers(0, n_classes, (n, 1)).astype(np.int32)
    train_ds = ArrayDataset({"data": data, "label": labels})
    spec = zoo.caffenet(batch=batch, crop=crop, n_classes=n_classes)
    kernels = device == "cuda"
    root = tempfile.mkdtemp(prefix="chip_smoke_sharded_")
    timed = []
    lock = threading.Lock()
    originals = (ckpt.save, ckpt.save_sharded,
                 ParallelTrainer.checkpoint_tree,
                 ParallelTrainer.checkpoint_shards)

    def note(layout, what, t0, step=None, nbytes=None):
        with lock:
            timed.append({"layout": layout, "what": what, "step": step,
                          "s": time.perf_counter() - t0, "bytes": nbytes,
                          "thread": threading.current_thread().name})

    def save(directory, tree, *, step, extra=None):
        t0 = time.perf_counter()
        path = originals[0](directory, tree, step=step, extra=extra)
        note("off", "save", t0, step, _dir_bytes(path))
        return path

    def save_sharded(directory, snapshot, *, step, extra=None, **kw):
        t0 = time.perf_counter()
        path = originals[1](directory, snapshot, step=step, extra=extra,
                            **kw)
        note("on", "save", t0, step, _dir_bytes(path))
        return path

    def checkpoint_tree(self, state):
        t0 = time.perf_counter()
        out = originals[2](self, state)
        note("off", "stage 1", t0)
        return out

    def checkpoint_shards(self, state):
        t0 = time.perf_counter()
        out = originals[3](self, state)
        note("on", "stage 1", t0)
        return out

    ckpt.save, ckpt.save_sharded = save, save_sharded
    ParallelTrainer.checkpoint_tree = checkpoint_tree
    ParallelTrainer.checkpoint_shards = checkpoint_shards
    det = (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    launches, steps_of = {}, {}

    def run(label, cfg, n_rounds):
        log = _capture_logger()
        if kernels:
            torch.cuda.synchronize()
        _zero_counts()
        t0 = time.perf_counter()
        state = train(cfg, spec, train_ds, None, logger=log, device=device)
        if kernels:
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = _read_counts()
        rounds = [x for x in log.records if "loss" in x]
        for x in rounds:
            if not (math.isfinite(x["loss"]) and x.get("nonfinite") == 0):
                fail(f"sharded[{label}] round {x['round']}: loss "
                     f"{x['loss']}, nonfinite {x.get('nonfinite')}")
        print(f"sharded[{label}]: {len(rounds)} rounds in {wall:.2f}s wall "
              f"(set-up and checkpoints included), round_s "
              f"{_stats([x['round_s'] for x in rounds[1:]])} s, launches "
              f"{counts} [{card}]", flush=True)
        if len(rounds) != n_rounds:
            fail(f"sharded[{label}]: {len(rounds)} rounds, want {n_rounds}")
        executed = n_rounds * tau
        launches[label], steps_of[label] = counts, executed
        if kernels:
            _expect_counts(f"sharded[{label}]", counts, {
                "lrn_fwd": 2 * executed, "lrn_fwd_scale": 0,
                "lrn_bwd": 2 * executed, "maxpool_bwd": 3 * executed})
        return state, log

    try:
        base = RunConfig(model="caffenet", n_classes=n_classes, crop=crop,
                         solver=SolverConfig(**IMAGENET_SOLVER), tau=tau,
                         local_batch=batch, eval_every=0,
                         precision="bfloat16", seed=0, workdir=root,
                         checkpoint_every=2, max_rounds=4)
        dirs = {k: os.path.join(root, k) for k in ("off", "on", "half")}
        trace_path = os.path.join(root, "trace.json")
        prof_dir = os.path.join(root, "profile")
        # the two layouts, 4 rounds each; trace_out and profile_dir on "on"
        off, _ = run("off", dataclasses.replace(
            base, checkpoint_dir=dirs["off"], checkpoint_sharded="off"), 4)
        on, log_on = run("on", dataclasses.replace(
            base, checkpoint_dir=dirs["on"], checkpoint_sharded="on",
            trace_out=trace_path, profile_dir=prof_dir), 4)
        for layout in ("off", "on"):
            for name in sorted(os.listdir(dirs[layout])):
                path = os.path.join(dirs[layout], name)
                meta = json.load(open(os.path.join(path, "meta.json")))
                sharded = meta.get("format") == "sharded"
                if not ckpt.verify(path) or sharded != (layout == "on") or (
                        sharded and (len(meta["shards"]) != 1 or len(
                            meta["shards"][0].get("digest", "")) != 64)):
                    fail(f"sharded[{layout}]: {path} (format "
                         f"{meta.get('format')}, shards "
                         f"{meta.get('shards')}) does not verify as the "
                         f"{layout!r} layout")
        restored = {}
        for layout in ("off", "on"):
            t0 = time.perf_counter()
            flat, step, _ = ckpt.restore_flat(dirs[layout], step=4)
            note(layout, "restore", t0, step, sum(
                int(a.numel() * a.element_size())
                if isinstance(a, torch.Tensor) else int(a.nbytes)
                for a in flat.values()))
            restored[layout] = flat

        def bits(a):
            if isinstance(a, torch.Tensor):
                return str(a.dtype), tuple(a.shape), (
                    a.view(torch.int16) if a.dtype == torch.bfloat16
                    else a).numpy().tobytes()
            return str(a.dtype), a.shape, a.tobytes()

        bad = [k for k in restored["off"] if k not in restored["on"] or
               bits(restored["off"][k]) != bits(restored["on"][k])]
        if bad or sorted(restored["off"]) != sorted(restored["on"]):
            fail(f"sharded: restore_flat of the two layouts' step 4 differ "
                 f"on {bad[:5]}")
        del restored
        print(f"sharded: both layouts' steps verify; restore_flat of the "
              f"two step-4s equal key for key, bit for bit [{card}]",
              flush=True)
        # resume from the per-shard step 2 to round 4
        run("half", dataclasses.replace(
            base, max_rounds=2, checkpoint_dir=dirs["half"],
            checkpoint_sharded="on"), 2)
        resumed, log_r = run("resumed", dataclasses.replace(
            base, checkpoint_dir=dirs["half"], checkpoint_sharded="on",
            resume=True), 2)
        if not any("resumed from checkpoint round 2" in m
                   for m in log_r.lines):
            fail(f"sharded[resumed]: no resume line in {log_r.lines}")
        for kind in ("params", "momentum"):
            a, b = getattr(on, kind), getattr(resumed, kind)
            diff = [f"{l}/{p}" for l in a for p in a[l]
                    if not torch.equal(a[l][p], b[l][p])]
            if diff:
                fail(f"sharded: the resume from per-shard step 2 differs "
                     f"from the uninterrupted run in {kind}: {diff}")
        if resumed.it != on.it or not torch.equal(off.flat_params,
                                                  on.flat_params):
            fail(f"sharded: it {resumed.it} vs {on.it}, or the layouts' "
                 f"final params differ")
        print(f"sharded: the resume from per-shard step 2 is torch.equal "
              f"to the uninterrupted run (every param and momentum tensor, "
              f"it {on.it}) [{card}]", flush=True)
        for t in timed:
            print(f"sharded[{t['layout']}]: {t['what']}"
                  + (f" step {t['step']}" if t["step"] is not None else "")
                  + f": {t['s']:.3f}s"
                  + (f", {t['bytes']} bytes" if t["bytes"] is not None
                     else "") + f" (thread {t['thread']}) [{card}]",
                  flush=True)

        # the host trace and the profiled round of the "on" run
        evs = json.load(open(trace_path))["traceEvents"]
        spans = {e["name"] for e in evs if e["ph"] == "X"}
        flushes = [e["args"]["round"] for e in evs if e["ph"] == "i"
                   and e["name"] == "flush"]
        if not {"round_prep", "h2d_prefetch", "checkpoint_write"} <= spans \
                or flushes != [0, 1, 2, 3]:
            fail(f"sharded: trace spans {sorted(spans)}, flush rounds "
                 f"{flushes}")
        print(f"sharded: host trace {len(evs)} events, spans "
              f"{sorted(spans)}, flush instants for rounds {flushes} "
              f"[{card}]", flush=True)
        files = os.listdir(prof_dir)
        if files != ["round-1.pt.trace.json"] or not any(
                f"profiler trace written to {prof_dir}" in m
                for m in log_on.lines):
            fail(f"sharded: profile directory holds {files}")
        pev = json.load(open(os.path.join(prof_dir, files[0])))
        by_name, count = {}, {}
        for e in pev["traceEvents"]:
            if e.get("cat") == "kernel":
                by_name[e["name"]] = by_name.get(e["name"], 0) + e["dur"]
                count[e["name"]] = count.get(e["name"], 0) + 1
        rows = sorted(by_name.items(), key=lambda kv: -kv[1])
        total = sum(by_name.values()) / 1e3
        ours = {k: [i for i, (nm, _) in enumerate(rows) if k in nm]
                for k in ("lrn_fwd_kernel", "lrn_bwd_kernel",
                          "maxpool_bwd_kernel")}
        convs = [i for i, (nm, _) in enumerate(rows) if any(
            w in nm.lower() for w in ("conv", "xmma", "implicit_gemm",
                                      "cudnn"))]
        top = max([10] + [min(v) + 1 for v in ours.values() if v])
        print(f"sharded: profiled round 1 (round-1.pt.trace.json): "
              f"{total:.3f} ms of kernels on the card, {len(rows)} kernel "
              f"names; the top {top} by device time [{card}]", flush=True)
        for nm, us in rows[:top]:
            print(f"sharded:   {us / 1e3:9.3f} ms  x{count[nm]:<4d} "
                  f"{nm[:90]}", flush=True)
        per = {k: sum(count[rows[i][0]] for i in v) for k, v in ours.items()}
        print(f"sharded: the profiled round's records of the port's "
              f"kernels {per}, ranks "
              f"{ {k: v[:1] for k, v in ours.items()} } (the launch "
              f"counters, exact, say {2 * tau}/{2 * tau}/{3 * tau}); cuDNN "
              f"convolutions at ranks {convs[:5]} [{card}]", flush=True)
        if kernels and (not all(per.values()) or not convs
                        or convs[0] >= 10):
            # records, not launches: a profiler that ran earlier in the
            # process can miss a window's first kernels (PERF.md, PR 11)
            fail(f"sharded: the profiled round lacks a port kernel {per} "
                 f"or a cuDNN convolution in its top 10 ({convs[:3]})")

        # the supervisor over phase 8's watched configuration, per-shard
        sup_dir = os.path.join(root, "supervised")
        os.makedirs(sup_dir)
        child = os.path.join(sup_dir, "child.py")
        with open(child, "w") as f:
            f.write(CHILD_SHARDED)
        max_rounds = kill_after + 5  # evicted at kill_after + 3
        child_spec = {"crop": crop, "batch": batch, "tau": tau,
                      "n_classes": n_classes, "kill_after": kill_after,
                      "max_rounds": max_rounds, "device": device,
                      "solver": IMAGENET_SOLVER, "workdir": sup_dir,
                      "pod_dir": os.path.join(sup_dir, "pod"),
                      "ck": os.path.join(sup_dir, "ck")}
        here = os.path.dirname(os.path.abspath(__file__))
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            [here, os.environ.get("PYTHONPATH", "")]))
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "sparknet_tpu_torch.parallel.supervise",
             "--nproc", "1", "--poll-secs", "0", "--", sys.executable,
             child, here, json.dumps(child_spec)],
            cwd=here, env=env, capture_output=True, text=True, timeout=600)
        sup_wall = time.perf_counter() - t0
        out = proc.stdout.splitlines()
        sup_lines = [ln for ln in out if ln.startswith("supervise:")]
        kids = [json.loads(ln.split(": ", 1)[1]) for ln in out
                if ln.startswith("phase10-child: ")]
        for ln in sup_lines:
            print(f"sharded[supervised]: {ln} [{card}]", flush=True)
        if proc.returncode != 0 or len(kids) != 2 or sup_lines[-1] != (
                "supervise: launches 2, relaunches 1, strikes 0, code 0"):
            fail(f"sharded[supervised]: exit {proc.returncode}, "
                 f"{sup_lines}, children {kids}; stderr "
                 f"{proc.stderr[-3000:]}")
        boundary = kill_after + 3
        first, second = kids
        if first["code"] != 75 or first["relaunched"] or \
                first["steps"].get(str(boundary)) is not True or \
                second["code"] != 0 or not second["relaunched"] or \
                not second["elastic_resume"] or second["rounds"] != \
                max_rounds - boundary:
            fail(f"sharded[supervised]: launches {kids}: want exit 75 with "
                 f"a verified per-shard step {boundary}, then an ELASTIC "
                 f"resume to round {max_rounds} and exit 0")
        for i, k in enumerate(kids):
            ex = k["executed"]
            print(f"sharded[supervised]: launch {i + 1}: exit {k['code']}, "
                  f"{k['rounds']} rounds, {ex} executed steps, launches "
                  f"{k['counts']}, process start to train() "
                  f"{k['t_train0'] - k['t_proc0']:.2f}s, train() "
                  f"{k['t_end'] - k['t_train0']:.2f}s, per-shard steps "
                  f"{k['steps']}" + (", ELASTIC resume" if
                                     k["elastic_resume"] else "")
                  + f" [{card}]", flush=True)
            if kernels and k["counts"] != {
                    "lrn_fwd": 2 * ex, "lrn_fwd_scale": 0,
                    "lrn_bwd": 2 * ex, "maxpool_bwd": 3 * ex}:
                fail(f"sharded[supervised] launch {i + 1}: launches "
                     f"{k['counts']} for {ex} executed steps")
            launches[f"supervised {i + 1}"] = k["counts"]
            steps_of[f"supervised {i + 1}"] = ex
        relaunch_s = second["t_train0"] - first["t_end"]
        print(f"sharded[supervised]: the supervisor's wall {sup_wall:.2f}s "
              f"for two launches; relaunch {relaunch_s:.2f}s from the first "
              f"launch's exit 75 to the second's train() (process start, "
              f"imports, the card, the data) [{card}]", flush=True)

        # serving: the per-shard step 4 against the monolithic step 4
        precision.set_policy("float32")
        spec1 = zoo.caffenet(batch=1, crop=crop, n_classes=n_classes)
        x = {"data": np.ascontiguousarray(data[:1]), "label": labels[:1]}
        probs = {}
        for layout in ("on", "off"):
            net = TorchNet(spec1, seed=5, device=device)
            m = ModelManager(net, checkpoint_dir=dirs[layout])
            t0 = time.perf_counter()
            got = m.load_initial()
            t_install = time.perf_counter() - t0
            if got != 4:
                fail(f"sharded[serve]: the {layout} manager installed "
                     f"{got}: {m.last_error}")
            probs[layout] = torch.from_numpy(net.forward(x)["prob"])
            print(f"sharded[serve]: the {layout!r} layout's step 4 "
                  f"installed in {t_install:.3f}s [{card}]", flush=True)
        if not (torch.equal(probs["on"], probs["off"])
                and bool(torch.isfinite(probs["on"]).all())):
            fail("sharded[serve]: the per-shard step's bucket-1 prob "
                 "differs from the monolithic step's")
        print(f"sharded[serve]: bucket-1 prob from the per-shard step 4 "
              f"torch.equal to the monolithic step 4's [{card}]",
              flush=True)
    finally:
        ckpt.save, ckpt.save_sharded = originals[:2]
        ParallelTrainer.checkpoint_tree, \
            ParallelTrainer.checkpoint_shards = originals[2:]
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = \
            det
        precision.set_policy("float32")
        shutil.rmtree(root, ignore_errors=True)
    return {"launches": launches, "steps": steps_of, "timed": timed,
            "relaunch_s": relaunch_s}


def _quantiles_ms(xs) -> str:
    ys = sorted(xs)
    if not ys:
        return "p50 - ms, p99 - ms"
    return (f"p50 {ys[len(ys) // 2] * 1e3:.2f} ms, p99 "
            f"{ys[min(len(ys) - 1, int(0.99 * len(ys)))] * 1e3:.2f} ms")


def _forward_ms(net, batch, device: str, iters: int = 10):
    """(wall ms, device ms) of one bucket forward of `net`: wall is
    `TorchNet.forward` end to end (host->device copy, kernels, the blocking
    fetch of prob); device is CUDA events around the net's apply on inputs
    already on the card (None on the CPU). Medians over `iters` after one
    warm-up."""
    import torch
    net.forward(batch, ["prob"])
    walls = []
    for _ in range(iters):
        t0 = time.perf_counter()
        net.forward(batch, ["prob"])
        walls.append((time.perf_counter() - t0) * 1e3)
    if device != "cuda":
        return statistics.median(walls), None
    prepped = net._prep(batch)
    devs = []
    with torch.inference_mode():
        for _ in range(iters):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            net.net.apply(net.params, prepped, quant=net.quant)
            end.record()
            end.synchronize()
            devs.append(start.elapsed_time(end))
    return statistics.median(walls), statistics.median(devs)


#: a client process for phase 9: `clients` keep-alive threads, each
#: sending `n` npz requests through http_infer; prints one JSON line with
#: the wall seconds and every request's latency
_CLIENT_SRC = r"""
import json, sys, threading, time
import numpy as np
sys.path.insert(0, sys.argv[5])
from sparknet_tpu_torch.serve.http_frontend import http_infer
url, clients, n, crop = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), \
    int(sys.argv[4])
rng = np.random.default_rng(9)
payloads = [{"data": (50.0 * rng.standard_normal((crop, crop, 3))
                      ).astype(np.float32)} for _ in range(128)]
lat, errors = [], []

def client(c):
    for i in range(n):
        t0 = time.perf_counter()
        try:
            http_infer(url, "caffenet", payloads[(c * 17 + i) % 128],
                       deadline_s=120.0, timeout=180.0,
                       tenant=f"proc{c}")
        except Exception as e:
            errors.append(repr(e))
            return
        lat.append(time.perf_counter() - t0)

for warm in (True, False):
    threads = [threading.Thread(target=client, args=(c,))
               for c in range(clients)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0
    if warm:
        lat.clear()
print(json.dumps({"wall": wall, "lat": lat, "errors": errors[:3]}))
"""


def _client_process(url: str, clients: int, n: int, crop: int) -> dict:
    """Run `_CLIENT_SRC` in a child process (its own interpreter lock);
    returns its JSON result."""
    root = os.path.dirname(os.path.abspath(__file__))
    r = subprocess.run([sys.executable, "-c", _CLIENT_SRC, url,
                        str(clients), str(n), str(crop), root],
                       capture_output=True, text=True, timeout=600)
    if r.returncode != 0:
        fail(f"serve http: the client process failed: {r.stderr[-2000:]}")
    res = json.loads(r.stdout.strip().splitlines()[-1])
    if res["errors"]:
        fail(f"serve http: the client process saw errors {res['errors']}")
    return res


def phase_serve_http(card: str, phase3_img_s=None, device: str = "cuda",
                     crop: int = 227, clients: int = 8,
                     per_client: int = 64) -> dict:
    """Full-width CaffeNet served over HTTP by the port's replica, with a
    hot reload under traffic and the int8 lane (module docstring, phase
    9); returns the launch counts of both lanes. The arguments let the
    phase be rehearsed on the CPU at a small crop (counts then 0)."""
    import shutil
    import tempfile
    import threading
    import urllib.request

    import numpy as np
    import torch

    from sparknet_tpu_torch import precision, zoo
    from sparknet_tpu_torch.model.net import params_to_jax
    from sparknet_tpu_torch.model.quant import QuantConfig, is_quantized
    from sparknet_tpu_torch.net_api import TorchNet
    from sparknet_tpu_torch.obs import reqtrace
    from sparknet_tpu_torch.ops.cuda_lrn import lrn_fwd
    from sparknet_tpu_torch.serve.admission import TenantAdmission
    from sparknet_tpu_torch.serve.http_frontend import (HttpFrontend,
                                                        http_infer)
    from sparknet_tpu_torch.serve.server import (InferenceServer,
                                                 ServeConfig, zeros_batch)
    from sparknet_tpu_torch.utils import checkpoint as ckpt
    from sparknet_tpu_torch.utils.heartbeat import read_heartbeat

    precision.set_policy("float32")
    # the steady traffic and the bucket-128 forwards are timed under
    # cuDNN's default settings, as phase 3 and the serve CLI run; from the
    # swap on, cuDNN's deterministic algorithms, so that a served answer
    # can be held to a direct forward bit for bit
    det = (torch.backends.cudnn.deterministic,
           torch.backends.cudnn.benchmark)
    spec = zoo.caffenet(batch=128, crop=crop, n_classes=1000)
    root = tempfile.mkdtemp(prefix="chip_smoke_serve_http_")
    ck = os.path.join(root, "ck")
    hb_path = os.path.join(root, "hb.json")
    rng = np.random.default_rng(9)
    payloads = [{"data": (50.0 * rng.standard_normal((crop, crop, 3))
                          ).astype(np.float32)} for _ in range(128)]
    fixed = {"data": (50.0 * np.random.default_rng(99).standard_normal(
        (crop, crop, 3))).astype(np.float32)}
    out: dict = {}

    def wait_for(cond, what: str, timeout: float = 120.0) -> float:
        t0 = time.perf_counter()
        while not cond():
            if time.perf_counter() - t0 > timeout:
                fail(f"serve http: {what} did not happen within "
                     f"{timeout:.0f} s")
            time.sleep(0.002)
        return time.perf_counter() - t0

    def traffic(url: str, n_each: int, stop=None, tag: str = ""):
        """`clients` keep-alive client threads through http_infer; each
        sends n_each requests (or until `stop` once it has). Returns per
        client [(latency s, step, status)] and the wall seconds."""
        results = [[] for _ in range(clients)]
        errors = []

        def client(c: int) -> None:
            i = 0
            while i < n_each or (stop is not None and not stop.is_set()):
                meta: dict = {}
                t0 = time.perf_counter()
                try:
                    r = http_infer(url, "caffenet",
                                   payloads[(c * 17 + i) % len(payloads)],
                                   deadline_s=120.0, timeout=180.0,
                                   tenant=f"client{c}", meta=meta)
                except Exception as e:  # every one must answer 200
                    errors.append(f"client {c} request {i}: {e!r}")
                    return
                dt = time.perf_counter() - t0
                prob = r["prob"]
                if prob.shape != (1000,) or not np.isfinite(prob).all():
                    errors.append(f"client {c} request {i}: prob "
                                  f"{prob.shape}")
                    return
                results[c].append((dt, meta.get("step"),
                                   meta.get("status")))
                i += 1

        threads = [threading.Thread(target=client, args=(c,),
                                    name=f"http-client-{c}")
                   for c in range(clients)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
            if t.is_alive():
                fail(f"serve http{tag}: a client thread hung")
        wall = time.perf_counter() - t0
        if errors:
            fail(f"serve http{tag}: {errors[:3]}")
        return results, wall

    # the weights a trainer would commit: seeds 1 and 2, in the JAX
    # package's layouts (its monolithic format), built before any traffic
    trees = {}
    for seed in (1, 2):
        src = TorchNet(spec, seed=seed, device="cpu")
        trees[seed] = {"params": params_to_jax(src.net, src.params)}
        del src

    def save_seed(directory: str, seed: int, step: int) -> str:
        return ckpt.save(directory, trees[seed], step=step)

    try:
        # -- the f32 lane -----------------------------------------------------
        net = TorchNet(spec, seed=0, device=device)
        cfg = ServeConfig(model_name="caffenet", max_batch=128,
                          buckets=SERVE_BUCKETS, outputs=("prob",),
                          max_wait_ms=5.0, checkpoint_dir=ck,
                          poll_interval_s=0.2, status_port=0,
                          heartbeat_path=hb_path, heartbeat_every_s=0.5,
                          metrics_every_batches=0)
        os.makedirs(ck)
        _zero_counts()
        server = InferenceServer(net, cfg).start()
        fe = HttpFrontend(server, port=0,
                          tenants=TenantAdmission(rate_rps=1e6, burst=1e6))
        url = f"http://{fe.address[0]}:{fe.address[1]}"
        try:
            # warm-up: every bucket's first forward, keep-alive set up
            traffic(url, 16, tag=" warm-up")
            server.reset_counters()
            # steady traffic, no swap
            steady, steady_s = traffic(url, per_client, tag=" steady")
            lat = [x[0] for rows in steady for x in rows]
            n_steady = len(lat)
            img_s = n_steady / steady_s
            st = server.status()
            print(f"serve http: steady, {clients} keep-alive clients x "
                  f"{per_client}: {n_steady} requests in {steady_s:.3f} s ="
                  f" {img_s:.1f} img/s; client-side {_quantiles_ms(lat)};"
                  f" server-side p50 {st['p50_ms']} ms, p99 {st['p99_ms']}"
                  f" ms; batch fill {st['batch_fill_ratio']}, batch sizes "
                  f"{st['batch_size_hist']}; phase 3 in process: "
                  + (f"{phase3_img_s:.1f}" if phase3_img_s else "-")
                  + f" img/s; both with cuDNN's default settings [{card}]",
                  flush=True)
            out["http_img_s"], out["n_steady"] = img_s, n_steady
            # the same steady traffic from a client process of its own:
            # the server's threads no longer share the interpreter lock
            # with the clients' encoding and decoding
            server.reset_counters()
            sub = _client_process(url, clients, per_client, crop)
            st = server.status()
            print(f"serve http: steady, the same {clients} x {per_client} "
                  f"from a client process: {len(sub['lat']) / sub['wall']:.1f}"
                  f" img/s; client-side {_quantiles_ms(sub['lat'])}; "
                  f"server-side p50 {st['p50_ms']} ms, p99 {st['p99_ms']} "
                  f"ms; batch sizes {st['batch_size_hist']} [{card}]",
                  flush=True)
            out["http_img_s_client_process"] = len(sub["lat"]) / sub["wall"]

            # where a request's time goes: request tracing on, every
            # request kept (head sample 1.0), in memory
            tr = reqtrace.start_request_tracing(head_sample=1.0)
            try:
                traffic(url, 16, tag=" traced")
            finally:
                reqtrace.stop_request_tracing()
            rows = [r for r in tr.drain_rows() if r["k"] == "r"]
            stages: dict = {}
            for r in rows:
                for k, v in r["stages"].items():
                    stages.setdefault(k, []).append(v)
            totals = [r["dur"] / 1e3 for r in rows]
            print(f"serve http: traced ({len(rows)} requests, server side,"
                  f" mean ms): total {statistics.mean(totals):.2f}; "
                  + ", ".join(f"{k} {statistics.mean(v):.3f}"
                              for k, v in sorted(stages.items()))
                  + f" [{card}]", flush=True)
            t0 = time.perf_counter()
            from sparknet_tpu_torch.serve.http_frontend import _encode_npz
            for p in payloads[:32]:
                _encode_npz(p)
            print(f"serve http: client npz encode {len(_encode_npz(fixed))}"
                  f" B in {(time.perf_counter() - t0) / 32 * 1e3:.3f} ms a "
                  f"request [{card}]", flush=True)

            # the swap under traffic: step 1 (seed 1) written mid-traffic
            torch.backends.cudnn.deterministic = True
            torch.backends.cudnn.benchmark = False
            stop = threading.Event()
            box: dict = {}

            def run_traffic():
                box["res"], box["wall"] = traffic(url, per_client, stop,
                                                  tag=" swap")

            before = server.requests_ok
            drv = threading.Thread(target=run_traffic, name="http-traffic")
            drv.start()
            wait_for(lambda: server.requests_ok >= before
                     + per_client * clients // 4, "mid-traffic point")
            t0 = time.perf_counter()
            save_seed(ck, 1, 1)
            save_s = time.perf_counter() - t0
            wait_for(lambda: server.manager.step == 1, "the step-1 install")
            m = server.manager
            commit_ts = float(json.load(open(os.path.join(
                ck, "step-1", "meta.json")))["commit_ts"])
            commit_to_install = m.install_ts - commit_ts
            fresh_at_install = m.freshness_s(now=m.install_ts)
            canary_ms = (m.last_canary_s or 0.0) * 1e3
            # step 2: one byte of its arrays flipped, staged outside the
            # watched dir, then published whole
            stage = os.path.join(root, "stage")
            path = save_seed(stage, 2, 2)
            npz = os.path.join(path, "state.npz")
            raw = bytearray(open(npz, "rb").read())
            raw[len(raw) // 2] ^= 0x01
            open(npz, "wb").write(bytes(raw))
            os.rename(path, os.path.join(ck, "step-2"))
            wait_for(lambda: m.swap_failures >= 1, "the step-2 rejection")
            stop.set()
            drv.join(timeout=600)
            if drv.is_alive() or "res" not in box:
                fail("serve http: the swap traffic did not finish")
            swap_rows = box["res"]
            n_swap = sum(len(r) for r in swap_rows)
            print(f"serve http: step 1 saved in {save_s:.3f} s; commit to "
                  f"install {commit_to_install:.3f} s, freshness_s at "
                  f"install {fresh_at_install}, the canary forward "
                  f"{canary_ms:.2f} ms; {n_swap} requests during the swap "
                  f"in {box['wall']:.3f} s [{card}]", flush=True)
            out.update(commit_to_install_s=commit_to_install,
                       canary_ms=canary_ms,
                       freshness_at_install_s=fresh_at_install)
            if m.step != 1 or "corrupt" not in (m.last_error or ""):
                fail(f"serve http: step 2 not rejected as corrupt (step "
                     f"{m.step}, last_error {m.last_error})")
            total = n_steady + n_swap + 32 * clients
            steps_seen = set()
            for c, rows_c in enumerate(swap_rows):
                steps = [s for _, s, _ in rows_c]
                if any(code != 200 for _, _, code in rows_c) or \
                        any(s is None for s in steps):
                    fail(f"serve http: client {c}: a response without 200 "
                         f"and a step")
                if any(b < a for a, b in zip(steps, steps[1:])):
                    fail(f"serve http: client {c}'s steps decreased: "
                         f"{steps}")
                steps_seen.update(steps)
            if total < 2 * clients * per_client or steps_seen != {-1, 1}:
                fail(f"serve http: {total} requests (want >= "
                     f"{2 * clients * per_client}), steps "
                     f"{sorted(steps_seen)} (want -1 then 1)")
            print(f"serve http: {total} requests over HTTP in all, every "
                  f"one 200 with a step; each client's steps never "
                  f"decrease (-1 = initial weights, then 1) [{card}]",
                  flush=True)
            # a fixed request after the swap vs the seed-1 net
            meta: dict = {}
            served = http_infer(url, "caffenet", fixed, deadline_s=60.0,
                                meta=meta)["prob"]
            if meta.get("step") != 1:
                fail(f"serve http: fixed request served by step "
                     f"{meta.get('step')}, want 1")
            launches = lrn_fwd.launches
            bf16 = lrn_fwd.bf16_launches
            traffic_forwards = len(server.batch_log)
            manager_forwards = m.forwards
            # the status surfaces
            host, port = server.status_address
            health = urllib.request.urlopen(
                f"http://{host}:{port}/healthz", timeout=30)
            fe_health = urllib.request.urlopen(f"{url}/healthz", timeout=30)
            text = urllib.request.urlopen(
                f"http://{host}:{port}/metrics", timeout=30).read().decode()
            hb = read_heartbeat(hb_path)
            swaps_rejected = server.registry.counter(
                "sparknet_serve_swaps_total",
                labels=("model", "outcome")).value(model="caffenet",
                                                   outcome="rejected")
            connections = fe.connections
            requests = fe.requests
        finally:
            fe.stop()
            server.stop()
        if health.status != 200 or fe_health.status != 200:
            fail(f"serve http: /healthz {health.status} (status server), "
                 f"{fe_health.status} (frontend)")
        for fam in ('sparknet_serve_http_requests_total{code="200",'
                    'transport="http"}',
                    'sparknet_serve_http_connections_total{transport="http"}',
                    'sparknet_serve_swaps_total{model="caffenet",'
                    'outcome="ok"} 1',
                    'sparknet_serve_swaps_total{model="caffenet",'
                    'outcome="rejected"} 1',
                    "sparknet_serve_model_freshness_seconds{",
                    "sparknet_serve_model_step{", "sparknet_build_info{",
                    'sparknet_serve_requests_total{model="caffenet",'
                    'outcome="ok"}'):
            if fam not in text:
                fail(f"serve http: /metrics lacks {fam}")
        if hb is None or not HEARTBEAT_KEYS <= set(hb) or \
                hb["role"] != "serve" or hb["rollbacks"] != 1 or \
                hb["step"] != 1 or swaps_rejected != 1:
            fail(f"serve http: heartbeat {hb}, swaps rejected "
                 f"{swaps_rejected} (want role serve, step 1, rollbacks 1)")
        print(f"serve http: /healthz 200 (status server and frontend); "
              f"/metrics has the serve, http (transport=\"http\"), swap and "
              f"freshness families; heartbeat step {hb['step']} rollbacks "
              f"{hb['rollbacks']}; {requests} requests on {connections} "
              f"connections [{card}]", flush=True)
        ref_net = TorchNet(spec, seed=1, device=device)
        # bucket 1 built as the server builds it (a padded host buffer:
        # a `x[None]` view has batch stride 0, which cuDNN runs by
        # another algorithm, close but not bit-equal)
        one = zeros_batch(ref_net, 1)
        one["data"][0] = fixed["data"]
        direct = ref_net.forward(one, ["prob"])["prob"][0]
        same_w = all(torch.equal(t, ref_net.params[l][p])
                     for l, lp in net.params.items() for p, t in lp.items())
        if not same_w or not torch.equal(torch.from_numpy(served),
                                         torch.from_numpy(direct)):
            again = ref_net.forward(one, ["prob"])["prob"][0]
            own = net.forward(one, ["prob"])["prob"][0]
            fail(f"serve http: the fixed request's prob differs from the "
                 f"seed-1 net's forward at bucket 1 (max abs err "
                 f"{np.abs(served - direct).max():.3e}; installed weights "
                 f"equal seed 1's: {same_w}; the seed-1 net again: "
                 f"{np.abs(again - direct).max():.3e}; the serving net "
                 f"on this thread: {np.abs(own - served).max():.3e})")
        print("serve http: after the swap, a fixed request's prob "
              "torch.equal to the seed-1 net's forward at bucket 1",
              flush=True)
        if device == "cuda" and (
                launches != 2 * (traffic_forwards + manager_forwards)
                or bf16 != 0):
            fail(f"serve http: lrn_fwd launched {launches} times ({bf16} "
                 f"bf16) over {traffic_forwards} traffic and "
                 f"{manager_forwards} canary forwards (want 2 per forward,"
                 f" f32)")
        print(f"serve http: f32 lane: lrn_fwd launches {launches} = 2 x "
              f"({traffic_forwards} traffic forwards + {manager_forwards} "
              f"canary forward) [{card}]", flush=True)
        out["launches"] = {"f32": launches}
        out["forwards"] = {"f32": traffic_forwards}
        f32_net = net

        # -- the int8 lane: the same step, quantized ------------------------
        shutil.rmtree(os.path.join(ck, "step-2"))
        qnet = TorchNet(spec, seed=0, device=device)
        qcfg = ServeConfig(model_name="caffenet", max_batch=128,
                           buckets=SERVE_BUCKETS, outputs=("prob",),
                           max_wait_ms=5.0, checkpoint_dir=ck,
                           poll_interval_s=0.2, quant="int8",
                           metrics_every_batches=0)
        _zero_counts()
        t0 = time.perf_counter()
        qserver = InferenceServer(qnet, qcfg).start()
        q_start_s = time.perf_counter() - t0
        qfe = HttpFrontend(qserver, port=0)
        qurl = f"http://{qfe.address[0]}:{qfe.address[1]}"
        try:
            qm = qserver.manager
            if qm.step != 1 or qm.last_parity_drift is None or \
                    not is_quantized(qnet.params):
                fail(f"serve http: the int8 lane did not install step 1 "
                     f"quantized (step {qm.step}, drift "
                     f"{qm.last_parity_drift})")
            qres, q_wall = traffic(qurl, 16, tag=" int8")
            q_lat = [x[0] for rows in qres for x in rows]
            qlaunches = lrn_fwd.launches
            qbf16 = lrn_fwd.bf16_launches
            q_forwards = len(qserver.batch_log)
            q_manager = qm.forwards
            q_ref = qm.reference_forwards
            # the same requests through both lanes, one at a time (bucket
            # 1 in both). Three holds on each answer of the int8 lane:
            # its prob within QuantConfig's gate of the f32 lane's (the
            # install canary's limit); its fc8 logits within
            # INT8_FC8_REL of the f32 lane's, relative to their largest
            # magnitude, where the seed-0 net's logits (the weights
            # before the swap) must fall outside that limit, so the hold
            # can fail; and prob and fc8 torch.equal to a direct forward
            # of the int8 net on a bfloat16 bucket-1 batch built as its
            # server builds it
            qc = QuantConfig()
            stale = TorchNet(spec, seed=0, device=device)
            worst = worst_fc8 = 0.0
            stale_fc8 = float("inf")
            for i, p in enumerate(payloads[:16]):
                one = zeros_batch(f32_net, 1)
                one["data"][0] = p["data"]
                fo = f32_net.forward(one, ["prob", "fc8"])
                a = {k: fo[k][0] for k in ("prob", "fc8")}
                s0 = stale.forward(one, ["fc8"])["fc8"][0]
                b = http_infer(qurl, "caffenet", p, deadline_s=60.0,
                               outputs=("prob", "fc8"))
                qone = zeros_batch(qnet, 1, bf16=True)
                qone["data"][0] = torch.from_numpy(p["data"])
                d = qnet.forward(qone, ["prob", "fc8"])
                mag = float(np.abs(a["fc8"]).max())
                worst = max(worst, float(np.abs(a["prob"] - b["prob"]).max()))
                worst_fc8 = max(worst_fc8, float(
                    np.abs(a["fc8"] - b["fc8"]).max()) / mag)
                stale_fc8 = min(stale_fc8, float(
                    np.abs(s0 - b["fc8"]).max()) / mag)
                if not np.allclose(b["prob"], a["prob"], rtol=qc.rtol,
                                   atol=qc.atol):
                    fail(f"serve http: int8 prob outside rtol {qc.rtol} / "
                         f"atol {qc.atol} of the f32 lane's ({worst:.3e})")
                if worst_fc8 > INT8_FC8_REL or stale_fc8 <= INT8_FC8_REL:
                    fail(f"serve http: request {i}: int8 fc8 vs the f32 "
                         f"lane's {worst_fc8:.4f} of its magnitude, the "
                         f"seed-0 net's {stale_fc8:.4f} (want <= and > "
                         f"{INT8_FC8_REL})")
                for k in ("prob", "fc8"):
                    if not torch.equal(torch.from_numpy(b[k]),
                                       torch.from_numpy(d[k][0])):
                        fail(f"serve http: request {i}: the int8 lane's "
                             f"{k} over HTTP differs from the int8 net's "
                             f"direct bucket-1 forward (max abs err "
                             f"{np.abs(b[k] - d[k][0]).max():.3e})")
            del stale
        finally:
            qfe.stop()
            qserver.stop()
        if device == "cuda" and (
                qlaunches != 2 * (q_forwards + q_manager)
                or qbf16 != 2 * (q_forwards + q_manager - q_ref)):
            fail(f"serve http: int8 lane lrn_fwd {qlaunches} launches, "
                 f"{qbf16} bf16, over {q_forwards} traffic, {q_manager} "
                 f"canary/parity forwards ({q_ref} f32 references)")
        print(f"serve http: int8 lane: step 1 installed quantized in "
              f"{q_start_s:.3f} s (parity drift {qm.last_parity_drift:.4f},"
              f" tol rtol {qc.rtol} atol {qc.atol}); {len(q_lat)} requests "
              f"in {q_wall:.3f} s, client-side {_quantiles_ms(q_lat)} "
              f"(deterministic cuDNN); "
              f"vs the f32 lane: prob max abs err {worst:.3e}, fc8 max "
              f"abs err {worst_fc8:.4f} of its magnitude (limit "
              f"{INT8_FC8_REL}; the seed-0 net's fc8 {stale_fc8:.4f}); "
              f"prob and fc8 torch.equal to the int8 net's direct "
              f"forward; lrn_fwd "
              f"{qlaunches} launches, {qbf16} bfloat16 = 2 x ({q_forwards} "
              f"traffic + {q_manager - q_ref} quantized canary/parity); "
              f"{2 * q_ref} f32 for the parity reference [{card}]",
              flush=True)
        out.update(int8_prob_err=worst, int8_fc8_rel=worst_fc8,
                   stale_fc8_rel=stale_fc8)
        out["launches"]["int8"] = qlaunches
        out["launches"]["int8_bf16"] = qbf16
        out["forwards"]["int8"] = q_forwards
        big = {"data": np.stack([p["data"] for p in payloads]),
               "label": np.zeros((128, 1), np.int32)}
        # the int8 lane's host batch as its server builds it: bfloat16
        qbig = zeros_batch(qnet, 128, bf16=True)
        qbig["data"][:] = torch.from_numpy(big["data"])
        # timed under cuDNN's default settings again
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = \
            det
        f_wall, f_dev = _forward_ms(f32_net, big, device)
        q_wall_ms, q_dev = _forward_ms(qnet, qbig, device)
        fmt = (lambda v: "-" if v is None else f"{v:.3f}")
        print(f"serve http: bucket-128 forward (cuDNN defaults), wall / "
              f"device ms: f32 "
              f"{f_wall:.3f} / {fmt(f_dev)}, int8 {q_wall_ms:.3f} / "
              f"{fmt(q_dev)} [{card}]", flush=True)
        out.update(f32_forward_ms=(f_wall, f_dev),
                   int8_forward_ms=(q_wall_ms, q_dev))
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = \
            det
        shutil.rmtree(root, ignore_errors=True)
    return out


#: the remote replica of phase 11: the serve CLI (`python -m
#: sparknet_tpu_torch.serve.app`, run here through runpy) in a process of
#: its own, counting its TorchNet forwards; at exit it prints its own
#: lrn_fwd launch counts as one JSON line on stdout
_REPLICA_SRC = r"""
import atexit, json, runpy, sys
sys.path.insert(0, sys.argv[1])
sys.argv = ["sparknet_tpu_torch.serve.app"] + sys.argv[2:]
from sparknet_tpu_torch.net_api import TorchNet
from sparknet_tpu_torch.ops.cuda_lrn import lrn_fwd
forwards = [0]
_forward = TorchNet.forward

def forward(self, *a, **kw):
    forwards[0] += 1
    return _forward(self, *a, **kw)

TorchNet.forward = forward
atexit.register(lambda: print(json.dumps({
    "lrn_fwd": lrn_fwd.launches, "bf16": lrn_fwd.bf16_launches,
    "forwards": forwards[0]}), flush=True))
runpy.run_module("sparknet_tpu_torch.serve.app", run_name="__main__")
"""


def _start_replica(ck: str, crop: int, device: str):
    """The remote CaffeNet replica: the serve CLI on the binary port 0,
    its weights the checkpoint step in `ck`. Returns (process, its stderr
    line queue)."""
    import queue
    import threading
    root = os.path.dirname(os.path.abspath(__file__))
    argv = [sys.executable, "-c", _REPLICA_SRC, root, "--model", "caffenet",
            "--model-name", "caffenet", "--crop", str(crop), "--n-classes",
            "1000", "--max-batch", "128", "--buckets", "1,8,64,128",
            "--outputs", "prob", "--max-wait-ms", "5", "--checkpoint-dir",
            ck, "--binary-port", "0", "--workdir", os.path.join(ck, "..",
                                                                "replica")]
    if device == "cpu":
        argv += ["--device", "cpu"]
    proc = subprocess.Popen(argv, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    lines: "queue.Queue" = queue.Queue()

    def pump():
        for line in iter(proc.stderr.readline, ""):
            lines.put(line)
        lines.put(None)

    threading.Thread(target=pump, name="replica-stderr", daemon=True).start()
    return proc, lines


def _replica_address(proc, lines, timeout: float = 300.0) -> str:
    import queue
    import re
    seen = []
    deadline = time.monotonic() + timeout
    while True:
        try:
            line = lines.get(timeout=max(0.1, deadline - time.monotonic()))
        except queue.Empty:
            line = ""
        if line is None or time.monotonic() > deadline:
            fail(f"router: the remote replica did not come up "
                 f"(exit {proc.poll()}): {''.join(seen)[-3000:]}")
        seen.append(line)
        m = re.search(r"binary data plane at (spkn://[\d.]+:\d+)", line)
        if m:
            return m.group(1)


def _stop_replica(proc, lines) -> dict:
    """SIGINT the replica (it drains and exits 0), then read the launch
    counts it printed at exit."""
    import signal
    proc.send_signal(signal.SIGINT)
    try:
        proc.wait(timeout=120)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait(timeout=30)
        fail("router: the remote replica did not exit on SIGINT")
    out = proc.stdout.read()
    if proc.returncode != 0:
        tail = []
        while not lines.empty():
            tail.append(lines.get() or "")
        fail(f"router: the remote replica exited {proc.returncode}: "
             f"{''.join(tail)[-3000:]}")
    return json.loads(out.strip().splitlines()[-1])


def phase_router(card: str, phase3_img_s=None, phase9_img_s=None,
                 device: str = "cuda", crop: int = 227, clients: int = 8,
                 per_client: int = 64) -> dict:
    """Phase 11: the router and the binary data plane (module docstring);
    returns the launch counts of both processes. The arguments let the
    phase be rehearsed on the CPU at a small crop (counts then 0)."""
    import shutil
    import tempfile
    import threading
    import urllib.request

    import numpy as np
    import torch

    from sparknet_tpu_torch import precision, zoo
    from sparknet_tpu_torch.model.net import params_to_jax
    from sparknet_tpu_torch.net_api import TorchNet
    from sparknet_tpu_torch.obs import reqtrace
    from sparknet_tpu_torch.ops.cuda_lrn import lrn_fwd
    from sparknet_tpu_torch.serve.binary_frontend import (BinaryClient,
                                                          BinaryFrontend)
    from sparknet_tpu_torch.serve.http_frontend import (HttpFrontend,
                                                        http_infer)
    from sparknet_tpu_torch.serve.router import ModelRouter, RouterConfig
    from sparknet_tpu_torch.serve.server import ServeConfig, zeros_batch
    from sparknet_tpu_torch.utils import checkpoint as ckpt

    precision.set_policy("float32")
    det = (torch.backends.cudnn.deterministic,
           torch.backends.cudnn.benchmark)
    spec = zoo.caffenet(batch=128, crop=crop, n_classes=1000)
    root = tempfile.mkdtemp(prefix="chip_smoke_router_")
    ck = os.path.join(root, "ck")
    rng = np.random.default_rng(11)
    payloads = [{"data": (50.0 * rng.standard_normal((crop, crop, 3))
                          ).astype(np.float32)} for _ in range(128)]
    fixed = {"data": (50.0 * np.random.default_rng(111).standard_normal(
        (crop, crop, 3))).astype(np.float32)}
    lenet_x = {"data": np.random.default_rng(5).standard_normal(
        (28, 28, 1)).astype(np.float32)}
    out: dict = {"img_s": {}, "lat": {}}
    proc = router = None
    fes = []
    t_phase = time.perf_counter()
    try:
        # step 1 of the seed-0 weights in the JAX package's monolithic
        # format: both replicas install it through the port's store
        src = TorchNet(spec, seed=0, device="cpu")
        ckpt.save(ck, {"params": params_to_jax(src.net, src.params)}, step=1)
        del src
        proc, lines = _start_replica(ck, crop, device)
        lane_cfg = dict(max_batch=128, buckets=SERVE_BUCKETS,
                        outputs=("prob",), max_wait_ms=5.0,
                        checkpoint_dir=ck, metrics_every_batches=0)
        router = ModelRouter(RouterConfig(workers=2, hedge=True,
                                          coalesce=True, status_port=0))
        net = TorchNet(spec, seed=7, device=device)  # step 1 replaces it
        _zero_counts()
        lane = router.add_model("caffenet", net, cfg=ServeConfig(**lane_cfg))
        router.add_model("lenet", TorchNet(zoo.lenet(batch=8), seed=0,
                                           device=device),
                         cfg=ServeConfig(max_batch=8, outputs=("prob",),
                                         metrics_every_batches=0))
        url_remote = _replica_address(proc, lines)
        rep = router.add_remote_replica("caffenet", url_remote)
        router.start()
        if lane.manager.step != 1:
            fail(f"router: the CaffeNet lane did not install step 1 "
                 f"(step {lane.manager.step})")
        hfe = HttpFrontend(router, port=0)
        bfe = BinaryFrontend(router, port=0)
        fes = [hfe, bfe]
        url = f"http://{hfe.address[0]}:{hfe.address[1]}"
        print(f"router: lanes caffenet (step 1 from the port's store, "
              f"f32, buckets {list(SERVE_BUCKETS)}) and lenet over 2 pool "
              f"threads, remote replica {url_remote} (the serve CLI in a "
              f"child process, step 1); {url} and spkn://{bfe.address[0]}:"
              f"{bfe.address[1]}; child up {time.perf_counter() - t_phase:.1f}"
              f" s after the phase began [{card}]", flush=True)

        def traffic(kind: str, n_each: int, on_progress=None):
            """`clients` closed-loop client threads, each with its own
            connection; returns (per-client [(latency s, step)], wall s,
            client payload bytes on the socket)."""
            results = [[] for _ in range(clients)]
            errors, sock_bytes = [], [0]
            lock = threading.Lock()

            def client(c: int) -> None:
                cli = None
                try:
                    if kind != "http":
                        cli = BinaryClient(*bfe.address, timeout=180.0,
                                           use_shm=(kind == "shm"))
                        if kind == "shm" and cli._shm_granted is not True:
                            errors.append(f"client {c}: shm not granted")
                            return
                    for i in range(n_each):
                        p = payloads[(c * 17 + i) % len(payloads)]
                        t0 = time.perf_counter()
                        if cli is None:
                            meta: dict = {}
                            r = http_infer(url, "caffenet", p,
                                           deadline_s=120.0, timeout=180.0,
                                           meta=meta)
                            step = meta.get("step")
                        else:
                            r = cli.infer(p, model="caffenet",
                                          deadline_s=120.0)
                            step = cli.last_step
                        dt = time.perf_counter() - t0
                        prob = r["prob"]
                        if prob.shape != (1000,) or \
                                not np.isfinite(prob).all():
                            errors.append(f"client {c}: prob {prob.shape}")
                            return
                        results[c].append((dt, step))
                        if on_progress is not None:
                            on_progress()
                except Exception as e:  # every request must answer
                    errors.append(f"client {c}: {e!r}")
                finally:
                    if cli is not None:
                        with lock:
                            sock_bytes[0] += (cli.payload_tx_bytes
                                              + cli.payload_rx_bytes)
                        cli.close()

            threads = [threading.Thread(target=client, args=(c,),
                                        name=f"router-client-{c}")
                       for c in range(clients)]
            t0 = time.perf_counter()
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=600)
                if t.is_alive():
                    fail(f"router ({kind}): a client thread hung")
            wall = time.perf_counter() - t0
            if errors:
                fail(f"router ({kind}): {errors[:3]}")
            return results, wall, sock_bytes[0]

        # a trickle of lenet requests beside the CaffeNet traffic
        stop_lenet = threading.Event()
        lenet_box = {"n": 0, "errors": []}

        def lenet_trickle():
            # over HTTP: the binary frontend's payload counters then see
            # the CaffeNet passes alone
            try:
                while not stop_lenet.is_set():
                    p = http_infer(url, "lenet", lenet_x,
                                   deadline_s=60.0)["prob"]
                    if p.shape != (10,) or not np.isfinite(p).all():
                        lenet_box["errors"].append(p.shape)
                    lenet_box["n"] += 1
                    stop_lenet.wait(0.01)
            except Exception as e:
                lenet_box["errors"].append(repr(e))

        trickle = threading.Thread(target=lenet_trickle,
                                   name="router-lenet")
        trickle.start()
        try:
            traffic("inline", 16)  # warm-up: every bucket, both processes
            n_caffenet = 16 * clients
            total_sock = {}
            for kind in ("shm", "inline", "http"):
                lane.reset_counters()
                rx0, tx0 = bfe.payload_rx_bytes, bfe.payload_tx_bytes
                srx0, stx0 = bfe.shm_rx_bytes, bfe.shm_tx_bytes
                res, wall, sock = traffic(kind, per_client)
                lat = [x[0] for rows in res for x in rows]
                steps = {x[1] for rows in res for x in rows}
                n_caffenet += len(lat)
                total_sock[kind] = sock
                img_s = len(lat) / wall
                out["img_s"][kind], out["lat"][kind] = img_s, lat
                if steps != {1}:
                    fail(f"router ({kind}): steps {sorted(map(str, steps))}"
                         f" (want every reply from step 1)")
                extra = ""
                if kind == "shm":
                    drx = bfe.payload_rx_bytes - rx0
                    dtx = bfe.payload_tx_bytes - tx0
                    srx = bfe.shm_rx_bytes - srx0
                    stx = bfe.shm_tx_bytes - stx0
                    want = len(lat) * crop * crop * 3 * 4
                    if drx or dtx or sock or srx != want or \
                            stx != len(lat) * 4000:
                        fail(f"router (shm): socket payload bytes "
                             f"frontend rx {drx} tx {dtx}, clients {sock}; "
                             f"through segments rx {srx} tx {stx} (want 0,"
                             f" 0, 0; {want}, {len(lat) * 4000})")
                    extra = (f"; payload bytes on the socket 0, through "
                             f"segments {srx} in + {stx} out")
                print(f"router: {kind}, {clients} clients x {per_client}: "
                      f"{len(lat)} CaffeNet requests in {wall:.3f} s = "
                      f"{img_s:.1f} img/s; client-side {_quantiles_ms(lat)}"
                      f"{extra} [{card}]", flush=True)
            print("router: img/s by transport: " + ", ".join(
                f"{k} {v:.1f}" for k, v in out["img_s"].items())
                + "; phase 9 (HTTP, one server) "
                + (f"{phase9_img_s:.1f}" if phase9_img_s else "-")
                + ", phase 3 (in process) "
                + (f"{phase3_img_s:.1f}" if phase3_img_s else "-")
                + f" [{card}]", flush=True)

            # the drain: mid-traffic, the remote replica stops taking new
            # requests; every in-flight one still answers
            routed = router.registry.counter(
                "sparknet_serve_routed_total", labels=("model", "replica"))
            done = [0]
            drained = threading.Event()

            def progress():
                done[0] += 1
                if done[0] == clients * 8 and not drained.is_set():
                    router.drain("caffenet", rep.name)
                    drained.set()

            before = routed.value(model="caffenet", replica=rep.name) or 0
            res, wall, _ = traffic("inline", 32, on_progress=progress)
            at_drain = routed.value(model="caffenet", replica=rep.name) or 0
            n_caffenet += sum(len(r) for r in res)
            local0 = routed.value(model="caffenet",
                                  replica="local:caffenet") or 0
            res2, _, _ = traffic("inline", 8)
            n_caffenet += sum(len(r) for r in res2)
            after = routed.value(model="caffenet", replica=rep.name) or 0
            local1 = routed.value(model="caffenet",
                                  replica="local:caffenet") or 0
            if not drained.is_set() or after != at_drain or \
                    local1 - local0 < clients * 8:
                fail(f"router: after the drain the remote replica took "
                     f"{after - at_drain} requests (want 0), the local "
                     f"lane {local1 - local0}")
            print(f"router: drained the remote replica mid-traffic: "
                  f"{clients * 32} requests all answered ({at_drain - before}"
                  f" routed to it in that pass), then {clients * 8} more, "
                  f"every one to the local lane [{card}]", flush=True)
        finally:
            stop_lenet.set()
            trickle.join(timeout=120)
        if trickle.is_alive() or lenet_box["errors"] or lenet_box["n"] < 1:
            fail(f"router: the lenet trickle: {lenet_box}")

        # where a request's time goes, one traced request per transport,
        # served by the local lane (the remote is drained)
        tr = reqtrace.start_request_tracing(head_sample=1.0)
        try:
            for kind in ("shm", "inline", "http"):
                if kind == "http":
                    http_infer(url, "caffenet", fixed, deadline_s=60.0)
                else:
                    cli = BinaryClient(*bfe.address, use_shm=(kind == "shm"))
                    try:
                        cli.infer(fixed, model="caffenet", deadline_s=60.0)
                    finally:
                        cli.close()
                rows = []
                deadline = time.monotonic() + 30
                while not any(r["k"] == "r" for r in rows):
                    if time.monotonic() > deadline:
                        fail(f"router: no trace row for the {kind} request")
                    rows += tr.drain_rows()
                    time.sleep(0.005)
                r = next(x for x in rows if x["k"] == "r")
                print(f"router: traced {kind} request (server side, ms): "
                      f"total {r['dur'] / 1e3:.3f}; " + ", ".join(
                          f"{k} {v:.3f}" for k, v in sorted(
                              r["stages"].items())) + f" [{card}]",
                      flush=True)
                out.setdefault("stages", {})[kind] = r["stages"]
        finally:
            reqtrace.stop_request_tracing()

        # a fixed request, alone (bucket 1), through every transport and
        # the in-process lane, under cuDNN's deterministic algorithms
        torch.backends.cudnn.deterministic = True
        torch.backends.cudnn.benchmark = False
        got = {}
        for kind in ("shm", "inline"):
            cli = BinaryClient(*bfe.address, use_shm=(kind == "shm"))
            try:
                got[kind] = cli.infer(fixed, model="caffenet",
                                      deadline_s=60.0)["prob"]
            finally:
                cli.close()
        got["http"] = http_infer(url, "caffenet", fixed,
                                 deadline_s=60.0)["prob"]
        got["lane"] = np.asarray(router.infer("caffenet", fixed)["prob"])
        from sparknet_tpu_torch.serve.binary_frontend import binary_infer
        remote = binary_infer(url_remote, "caffenet", fixed, deadline_s=60.0,
                              use_shm=False)["prob"]
        launches, bf16 = lrn_fwd.launches, lrn_fwd.bf16_launches
        traffic_forwards = len(lane.batch_log)
        manager_forwards = lane.manager.forwards
        one = zeros_batch(net, 1)
        one["data"][0] = fixed["data"]
        direct = net.forward(one, ["prob"])["prob"][0]
        for kind, v in got.items():
            if not torch.equal(torch.from_numpy(np.array(v)),
                               torch.from_numpy(direct)):
                fail(f"router: the fixed request's prob over {kind} differs "
                     f"from the lane's direct bucket-1 forward (max abs err "
                     f"{np.abs(v - direct).max():.3e})")
        remote_err = float(np.abs(remote - direct).max())
        if remote_err > 1e-6:
            fail(f"router: the remote replica's prob for the fixed request "
                 f"is {remote_err:.3e} from the local lane's (want <= 1e-6:"
                 f" the same step, the same card)")
        print(f"router: a fixed request's prob torch.equal over shm, inline"
              f" and HTTP to the lane's direct bucket-1 forward; the remote "
              f"replica's within {remote_err:.3e} [{card}]", flush=True)

        # the hedges, the coalescer, /metrics
        st = router.status()
        hg = st["hedging"].get("caffenet", {"routed": 0, "hedged": 0})
        hedged_c = router.registry.counter("sparknet_serve_hedged_total",
                                           labels=("model", "won"))
        won = {w: hedged_c.value(model="caffenet", won=w) or 0
               for w in ("primary", "hedge")}
        cancelled = router.registry.counter(
            "sparknet_serve_hedge_cancelled_total",
            labels=("model",)).value(model="caffenet") or 0
        coalesced = router.registry.counter(
            "sparknet_serve_coalesced_total",
            labels=("model",)).value(model="caffenet") or 0
        legs = sum(routed.value(model="caffenet", replica=r.name) or 0
                   for r in router.replicas["caffenet"])
        budget = router.cfg.hedge_budget
        if hg["hedged"] > budget * hg["routed"] or \
                sum(won.values()) != hg["hedged"] or \
                legs != hg["routed"] + hg["hedged"]:
            fail(f"router: hedging {hg}, won {won}, legs routed {legs} "
                 f"(want hedged <= {budget} x routed, each answered once)")
        print(f"router: {hg['routed']} CaffeNet requests routed, "
              f"{hg['hedged']} hedged (budget {budget}): won by the primary"
              f" {won['primary']:.0f}, by the hedge {won['hedge']:.0f}, "
              f"losers cancelled before forming {cancelled:.0f}; coalesced "
              f"picks {coalesced:.0f}; {n_caffenet} CaffeNet requests "
              f"answered by clients [{card}]", flush=True)
        if n_caffenet < 3 * clients * per_client:
            fail(f"router: {n_caffenet} CaffeNet requests answered (want "
                 f">= {3 * clients * per_client})")
        host, port = router.status_address
        text = urllib.request.urlopen(f"http://{host}:{port}/metrics",
                                      timeout=30).read().decode()
        for fam in ('sparknet_serve_routed_total{model="caffenet",'
                    'replica="local:caffenet"}',
                    f'sparknet_serve_routed_total{{model="caffenet",'
                    f'replica="{rep.name}"}}',
                    'sparknet_serve_routed_total{model="lenet",'
                    'replica="local:lenet"}',
                    'sparknet_serve_http_requests_total{code="200",'
                    'transport="binary"}',
                    'sparknet_serve_http_requests_total{code="200",'
                    'transport="http"}',
                    'sparknet_serve_replica_drains_total{model="caffenet",'):
            if fam not in text:
                fail(f"router: /metrics lacks {fam}")
        print("router: /metrics has routed_total by model and replica, "
              "transport=\"binary\" and transport=\"http\"", flush=True)
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = \
            det
        for fe in fes:
            fe.stop()
        if router is not None:
            router.stop()
        child = None
        if proc is not None:
            if proc.poll() is None:
                child = _stop_replica(proc, lines)
            else:
                proc.wait(timeout=30)
        shutil.rmtree(root, ignore_errors=True)
    if device == "cuda" and (
            launches != 2 * (traffic_forwards + manager_forwards)
            or bf16 != 0):
        fail(f"router: lrn_fwd launched {launches} times ({bf16} bf16) "
             f"over {traffic_forwards} lane and {manager_forwards} canary "
             f"forwards (want 2 per forward, f32)")
    if child is None:
        fail("router: the remote replica exited before it was stopped")
    if device == "cuda" and (child["lrn_fwd"] != 2 * child["forwards"]
                             or child["bf16"] != 0
                             or child["forwards"] < 2):
        fail(f"router: the remote replica's lrn_fwd {child} (want 2 per "
             f"forward, f32)")
    print(f"router: lrn_fwd launches {launches} = 2 x ({traffic_forwards} "
          f"lane + {manager_forwards} canary forwards) here; the remote "
          f"replica's {child['lrn_fwd']} = 2 x {child['forwards']} forwards"
          f" ({child['bf16']} bf16); phase {time.perf_counter() - t_phase:.1f}"
          f" s [{card}]", flush=True)
    out["launches"] = {"local": launches, "remote": child["lrn_fwd"]}
    out["forwards"] = {"local": traffic_forwards + manager_forwards,
                       "remote": child["forwards"]}
    return out


#: the interpreter the grown replicas of phases 12 and 13 run: the
#: provider spawns `<python> -m sparknet_tpu_torch.serve.app ...`, and this
#: wrapper runs that module with its TorchNet forwards, lrn_fwd launches
#: and nvcc builds counted, beside its compile events. The counts are
#: rewritten to `<heartbeat>.counts.json` after every forward (a child
#: killed with SIGKILL leaves its last complete count) and printed at
#: exit; SIGTERM (the provider's retire) drains like Ctrl-C
_FLEET_CHILD_SRC = r"""
import atexit, json, os, runpy, signal, sys
assert sys.argv[1] == "-m", sys.argv
module, args = sys.argv[2], sys.argv[3:]
out = args[args.index("--heartbeat") + 1] + ".counts.json"
sys.argv = [module] + args
from sparknet_tpu_torch.net_api import TorchNet
from sparknet_tpu_torch.obs.device import compile_stats
from sparknet_tpu_torch.ops import _build
from sparknet_tpu_torch.ops.cuda_lrn import lrn_fwd
forwards, builds = [0], []
_forward, _start = TorchNet.forward, _build._start

def start(name):
    r = _start(name)
    if r[0] is not None:
        builds.append(name)
    return r

def counts():
    return {"lrn_fwd": lrn_fwd.launches, "bf16": lrn_fwd.bf16_launches,
            "forwards": forwards[0], "builds": builds,
            "compile_stats": compile_stats(), "pid": os.getpid()}

def forward(self, *a, **kw):
    r = _forward(self, *a, **kw)
    forwards[0] += 1
    with open(out + ".tmp", "w") as f:
        json.dump(counts(), f)
    os.replace(out + ".tmp", out)
    return r

def interrupt(*_):
    raise KeyboardInterrupt

_build._start = start
TorchNet.forward = forward
signal.signal(signal.SIGTERM, interrupt)
atexit.register(lambda: print(json.dumps(counts()), flush=True))
runpy.run_module(module, run_name="__main__", alter_sys=True)
"""

#: the keys of the JAX package's /fleet/status (FleetController.status
#: with an admission door and a rollout duty), /slo/status
#: (BurnRateAlerter.state) and /timeseries bodies
JAX_FLEET_STATUS_KEYS = {"enabled", "running", "interval_s", "window_s",
                         "ticks", "pressure", "batch_starvation_s",
                         "provider", "pool", "models", "retiring",
                         "scale_events", "audit", "rollout", "admission"}
JAX_SLO_STATUS_KEYS = {"specs", "alerts", "firing", "budget_remaining",
                       "alerts_fired_total", "audit"}
JAX_TIMESERIES_KEYS = {"name", "kind", "window_s", "res_s", "agg",
                       "points", "quantile"}
JAX_TIMESERIES_INDEX_KEYS = {"families", "rings", "samples_total"}
#: the router's latency family: submit to answer, whichever replica
#: answered (phase 12's latency objective)
ROUTED_LATENCY = "sparknet_serve_routed_latency_seconds"


def phase_fleet(card: str, device: str = "cuda", crop: int = 227,
                clients: int = 8, depth: int = 64) -> dict:
    """Phase 12: the fleet on the card (module docstring); returns the
    launch counts of this process and of every grown replica. The
    arguments let the phase be rehearsed on the CPU at a small crop
    (counts then 0)."""
    import shutil
    import signal
    import tempfile
    import threading
    import urllib.request

    import numpy as np
    import torch

    from sparknet_tpu_torch import precision, zoo
    from sparknet_tpu_torch.fleet import (FleetConfig, FleetController,
                                          FleetPolicy,
                                          SubprocessReplicaProvider,
                                          read_gate)
    from sparknet_tpu_torch.model.net import params_to_jax
    from sparknet_tpu_torch.net_api import TorchNet
    from sparknet_tpu_torch.obs import slo as slo_mod
    from sparknet_tpu_torch.obs.history import read_history_shards
    from sparknet_tpu_torch.obs.registry import DEFAULT_BUCKETS
    from sparknet_tpu_torch.obs.slo import SloSpec
    from sparknet_tpu_torch.ops.cuda_lrn import lrn_fwd
    from sparknet_tpu_torch.serve.admission import (PriorityAdmission,
                                                    PriorityShedError)
    from sparknet_tpu_torch.serve.binary_frontend import (BinaryClient,
                                                          BinaryFrontend)
    from sparknet_tpu_torch.serve.router import ModelRouter, RouterConfig
    from sparknet_tpu_torch.serve.server import (InferenceServer,
                                                 ServeConfig, zeros_batch)
    from sparknet_tpu_torch.utils import checkpoint as ckpt
    from sparknet_tpu_torch.utils.heartbeat import read_heartbeat

    precision.set_policy("float32")
    det = (torch.backends.cudnn.deterministic,
           torch.backends.cudnn.benchmark)
    spec = zoo.caffenet(batch=128, crop=crop, n_classes=1000)
    root = tempfile.mkdtemp(prefix="chip_smoke_fleet_")
    ck = os.path.join(root, "ck")
    gate = os.path.join(root, "ROLLOUT.json")
    hist_dir = os.path.join(root, "history")
    rng = np.random.default_rng(12)
    payloads = [{"data": (50.0 * rng.standard_normal((crop, crop, 3))
                          ).astype(np.float32)} for _ in range(64)]
    fixed = {"data": (50.0 * np.random.default_rng(112).standard_normal(
        (crop, crop, 3))).astype(np.float32)}
    lane_kw = dict(model_name="caffenet", max_batch=128,
                   buckets=SERVE_BUCKETS, outputs=("prob",),
                   max_wait_ms=2.0, metrics_every_batches=0)
    out: dict = {}
    t_phase = time.perf_counter()
    router = fc = provider = None
    fes = []
    grows: list = []
    mon_stop = threading.Event()

    def wait_for(cond, what: str, timeout: float = 120.0) -> float:
        t0 = time.perf_counter()
        while not cond():
            if time.perf_counter() - t0 > timeout:
                fail(f"fleet: {what} did not happen within {timeout:.0f} s"
                     f" (audit {list(fc.audit)[-6:] if fc else None})")
            time.sleep(0.02)
        return time.perf_counter() - t0

    def run_clients(n: int, per: int, addr, stop, rows, errors,
                    priority: str = "high") -> list:
        """`n` closed-loop clients on their own connections, each with
        `per` requests in flight (submitted together, then collected);
        rows get (send wall ts, reply wall ts, latency s, step)."""
        def client(c: int) -> None:
            cli = None
            try:
                cli = BinaryClient(*addr, timeout=300.0, use_shm=False)
                i = 0
                while not stop.is_set():
                    rids = []
                    for k in range(per):
                        p = payloads[(c * 7 + i + k) % len(payloads)]
                        rids.append((cli.submit(p, model="caffenet",
                                                deadline_s=120.0,
                                                priority=priority),
                                     time.time()))
                    i += per
                    for rid, ts in rids:
                        prob = cli.collect(rid)["prob"]
                        lat = cli.last_timing["t_first_byte_s"]
                        if prob.shape != (1000,) or \
                                not np.isfinite(prob).all():
                            errors.append(f"client {c}: prob {prob.shape}")
                            return
                        rows.append((ts, ts + lat, lat, cli.last_step))
            except Exception as e:  # every request must answer
                errors.append(f"client {c}: {e!r}")
            finally:
                if cli is not None:
                    cli.close()
        threads = [threading.Thread(target=client, args=(c,),
                                    name=f"fleet-client-{c}", daemon=True)
                   for c in range(n)]
        for t in threads:
            t.start()
        return threads

    def join(threads, what: str) -> None:
        for t in threads:
            t.join(timeout=600)
            if t.is_alive():
                fail(f"fleet: a {what} client thread hung")

    try:
        # -- calibration: the objective S from this card's own latencies
        net = TorchNet(spec, seed=0, device=device)
        cal = InferenceServer(net, ServeConfig(**lane_kw)).start()
        cfe = BinaryFrontend(cal, port=0)
        try:
            for n in (1, 8, 64, 128):     # every bucket's first forward
                futs = [cal.submit(payloads[i % len(payloads)])
                        for i in range(n)]
                for f in futs:
                    f.result(timeout=600)
            # one burst window; three trickle windows, of which the one
            # with the median client p99 stands for the trickle, so that
            # a passing stall of the host (a one-card machine shares its
            # host's cores) does not set the objective
            windows: dict = {"burst": [], "trickle": []}
            for kind, (n, per, secs) in (("burst", (clients, depth, 4.0)),
                                         *[("trickle", (1, 1, 3.0))] * 3):
                cal.reset_counters()
                stop, rows, errors = threading.Event(), [], []
                ths = run_clients(n, per, cfe.address, stop, rows, errors)
                time.sleep(secs)
                stop.set()
                join(ths, "calibration")
                if errors:
                    fail(f"fleet calibration ({kind}): {errors[:3]}")
                cli_lat = sorted(r[2] for r in rows)
                q = (lambda xs, p: xs[min(len(xs) - 1, int(p * len(xs)))])
                windows[kind].append({
                    "lane_p50": cal.latency.quantile(0.5),
                    "lane_p99": cal.latency.quantile(0.99),
                    "client_p50": q(cli_lat, 0.5),
                    "client_p99": q(cli_lat, 0.99), "n": len(rows),
                    "loadavg_1m": os.getloadavg()[0]})
            stats = {kind: sorted(ws, key=lambda w: w["client_p99"])[
                len(ws) // 2] for kind, ws in windows.items()}
            stats["trickle"]["windows_client_p99"] = [
                w["client_p99"] for w in windows["trickle"]]
        finally:
            cfe.stop()
            cal.stop()
        # S: the largest latency-histogram bound at most half the burst's
        # server-side p50 (so a burst burns the budget) and at least 3x
        # the trickle's client p99 (so a trickle reads cold, burn <
        # burn_down 0.7, with room for a hop through the router to a
        # replica). A bound: the report's error fraction is then exact.
        lo = 3.0 * stats["trickle"]["client_p99"]
        tr_p99 = stats["trickle"]["windows_client_p99"]
        hi = stats["burst"]["lane_p50"] / 2.0
        cands = [b for b in DEFAULT_BUCKETS if lo <= b <= hi]
        print(f"fleet: calibration: burst of {clients} x {depth} in flight "
              f"({stats['burst']['n']} replies): lane p50 "
              f"{stats['burst']['lane_p50'] * 1e3:.2f} ms, client p50 / p99 "
              f"{stats['burst']['client_p50'] * 1e3:.2f} / "
              f"{stats['burst']['client_p99'] * 1e3:.2f} ms; trickle of 1 "
              f"(median of 3 windows, {stats['trickle']['n']} replies): "
              f"lane p99 {stats['trickle']['lane_p99'] * 1e3:.2f} ms, "
              f"client p99 {stats['trickle']['client_p99'] * 1e3:.2f} ms "
              f"(windows {[round(x * 1e3, 2) for x in tr_p99]} ms; host load "
              f"{[w['loadavg_1m'] for w in windows['trickle']]}); "
              f"candidate objectives {[b * 1e3 for b in cands]} ms "
              f"[{card}]",
              flush=True)
        if not cands:
            fail(f"fleet: no latency bound between 3 x the trickle's client "
                 f"p99 ({lo * 1e3:.2f} ms, the median of the windows' "
                 f"{[round(x * 1e3, 2) for x in tr_p99]} ms) and half the "
                 f"burst's lane p50 ({hi * 1e3:.2f} ms)")
        slo_s = cands[-1]
        slo_ms = slo_s * 1e3
        out["slo_ms"] = slo_ms
        out["calibration"] = stats
        print(f"fleet: S = {slo_ms:g} ms (p99 objective), availability "
              f"0.999 [{card}]", flush=True)

        # -- the fleet ------------------------------------------------------
        src = TorchNet(spec, seed=0, device="cpu")
        ckpt.save(ck, {"params": params_to_jax(src.net, src.params)},
                  step=1)
        del src
        child_py = os.path.join(root, "child_python")
        with open(os.path.join(root, "child.py"), "w") as f:
            f.write(_FLEET_CHILD_SRC)
        with open(child_py, "w") as f:
            f.write(f"#!/bin/sh\nexec '{sys.executable}' "
                    f"'{os.path.join(root, 'child.py')}' \"$@\"\n")
        os.chmod(child_py, 0o755)

        class Provider(SubprocessReplicaProvider):
            """Stamps each grow's decision and bring-up times."""

            def grow(self, model):
                grows.append({"t_decide": time.time()})
                h = super().grow(model)
                grows[-1].update(t_up=time.time(), tag=h.meta["tag"],
                                 url=h.url, hb=h.heartbeat_path,
                                 pid=h.meta["proc"].pid)
                return h

        extra = ["--crop", str(crop), "--n-classes", "1000", "--buckets",
                 ",".join(map(str, SERVE_BUCKETS)), "--max-wait-ms", "2",
                 "--workdir", os.path.join(root, "children")]
        if device == "cpu":
            extra += ["--device", "cpu"]
        provider = Provider({"caffenet": "caffenet"},
                            workdir=os.path.join(root, "fleet"),
                            max_batch=128, outputs=("prob",),
                            heartbeat_every_s=0.5, spawn_timeout_s=300.0,
                            extra_args=extra, python=child_py,
                            checkpoint_dir=ck, poll_interval_s=0.5,
                            poll_jitter=0.1, rollout_gate=gate)
        router = ModelRouter(RouterConfig(
            workers=2, status_port=0, history=True, history_dir=hist_dir,
            history_interval_s=1.0, stale_after_s=3.0,
            health_refresh_s=0.1))
        _zero_counts()
        # the objective is read from the router's routed latency (submit
        # to the answer, from whichever replica answered): the lane's own
        # histogram does not see the requests a grown replica serves
        slo_spec = SloSpec("caffenet", latency_ms=slo_ms,
                           availability=0.999,
                           latency_metric=ROUTED_LATENCY)
        lane = router.add_model("caffenet", net, cfg=ServeConfig(
            **lane_kw, checkpoint_dir=ck, poll_interval_s=0.5,
            rollout_gate=gate, slo_p99_ms=slo_ms, slo_availability=0.999,
            slo_spec=slo_spec))
        admission = PriorityAdmission()
        router.attach_admission(admission)
        # the wave gate reads the routed p99, which holds the canary's own
        # install stall (the lane restores and vets a 244 MB step between
        # batches while the burst queues behind it): its halt burn sits
        # above that stall, or every rollout under load halts on itself
        policy = FleetPolicy(up_ticks=2, down_ticks=4, min_window_n=16,
                             rollout_wave_size=2, rollout_halt_burn=500.0,
                             rollout_timeout_s=60.0)
        fc = FleetController(router, provider=provider, cfg=FleetConfig(
            interval_s=0.5, window_s=4.0, min_replicas=1, max_replicas=2,
            up_cooldown_s=1.0, down_cooldown_s=1.0, drain_grace_s=2.0,
            policy=policy), admission=admission)
        router.start()
        if lane.manager.step != 1:
            fail(f"fleet: the lane did not install step 1 (step "
                 f"{lane.manager.step})")
        sample_ms: list = []
        h_sample = router.history.sample_now

        def timed_sample(now=None):
            t0 = time.perf_counter()
            try:
                return h_sample(now)
            finally:
                sample_ms.append((time.perf_counter() - t0) * 1e3)
        router.history.sample_now = timed_sample
        fc.attach_alerter(router.alerter)
        bfe = BinaryFrontend(router, port=0, tenants=admission)
        fes.append(bfe)
        fc.start()
        host, sport = router.status_address
        print(f"fleet: router with the CaffeNet lane (step 1, f32, buckets "
              f"{list(SERVE_BUCKETS)}, S {slo_ms:g} ms, availability "
              f"0.999), history every 1 s, the controller every 0.5 s "
              f"(replicas 1..2, window 4 s, rollout halt burn 500); "
              f"spkn://{bfe.address[0]}:{bfe.address[1]}, status "
              f"http://{host}:{sport} [{card}]", flush=True)

        def events(direction=None, reason=None):
            return [a for a in list(fc.audit)
                    if (direction is None or a["direction"] == direction)
                    and (reason is None or a["reason"] == reason)]

        routed = router.registry.counter("sparknet_serve_routed_total",
                                         labels=("model", "replica"))
        first_routed: dict = {}

        def monitor():
            """The wall time of each grown replica's first routed reply,
            and the highest pressure the controller set."""
            out["max_pressure"] = out["max_burn"] = 0.0
            while not mon_stop.wait(0.05):
                out["max_pressure"] = max(out["max_pressure"], fc.pressure)
                st = fc._state.get("caffenet")
                if st is not None:
                    out["max_burn"] = max(out["max_burn"], st.burn)
                for r in list(router.replicas.get("caffenet", [])):
                    if r.lane is None and r.name not in first_routed and \
                            (routed.value(model="caffenet", replica=r.name)
                             or 0) > 0:
                        first_routed[r.name] = time.time()
        mon = threading.Thread(target=monitor, name="fleet-monitor",
                               daemon=True)
        mon.start()

        # -- 1. burst: a page, pressure, a grow --------------------------
        burst_rows, burst_err = [], []
        stop_burst = threading.Event()
        t_burst = time.time()
        burst = run_clients(clients, depth, bfe.address, stop_burst,
                            burst_rows, burst_err)
        try:
            fire_s = wait_for(lambda: "caffenet" in
                              router.alerter.firing_pages(), "the page")
            out["page_fire_s"] = time.time() - t_burst
            wait_for(lambda: out.get("max_pressure", 0) >=
                     fc.cfg.page_pressure, "the page pressure")
            shed = None
            try:
                cli = BinaryClient(*bfe.address, timeout=60.0)
                try:
                    cli.infer(fixed, model="caffenet", deadline_s=60.0,
                              priority="normal")
                finally:
                    cli.close()
            except PriorityShedError as e:
                shed = e
            wait_for(lambda: events("up", "slo_burn"), "the grow", 300.0)
            up = events("up", "slo_burn")[0]
            child = grows[0]
            wait_for(lambda: up["replica"] in first_routed,
                     "the new replica's first routed reply", 60.0)
            grow_to_reply = first_routed[up["replica"]] - child["t_decide"]
            print(f"fleet: burst of {clients} clients x {depth} in flight: "
                  f"page fired {out['page_fire_s']:.2f} s after it began "
                  f"({fire_s:.2f} s of waiting); pressure "
                  f"{out['max_pressure']:.2f} (page_pressure "
                  f"{fc.cfg.page_pressure}); a normal-priority request "
                  f"{'shed: ' + type(shed).__name__ if shed else 'ADMITTED'}"
                  f"; grew {up['replica']} ({up['reason']}, replicas "
                  f"{up['replicas']}); {grow_to_reply:.2f} s from the grow "
                  f"decision to its first routed reply (spawn "
                  f"{child['t_up'] - child['t_decide']:.2f} s) [{card}]",
                  flush=True)
            if shed is None:
                fail("fleet: a normal-priority request was admitted under "
                     "the page's pressure")
            out["grow_to_first_reply_s"] = grow_to_reply
            t_grown = first_routed[up["replica"]]
            time.sleep(3.0)               # the grown fleet, under the burst

            # -- 2. rollout of step 2, canary first ------------------------
            src = TorchNet(spec, seed=1, device="cpu")
            t_commit2 = time.time()
            ckpt.save(ck, {"params": params_to_jax(src.net, src.params)},
                      step=2)
            del src
            wait_for(lambda: any(e.get("step") == 2 for e in
                                 events("rollout", "done")),
                     "the step-2 rollout", 120.0)
            ro = {e["reason"]: e for e in events("rollout")
                  if e.get("step") == 2}
            t_fleetwide = ro["done"]["t"]
            g = read_gate(gate)
            hb = read_heartbeat(child["hb"]) or {}
            child_step = ((hb.get("models") or {}).get("caffenet")
                          or {}).get("model_step")
            if lane.manager.step != 2 or child_step != 2 or \
                    g.get("all") != 2 or ro["canary"]["replica"] != "local" \
                    or child["tag"] not in ro["wave"]["replicas"]:
                fail(f"fleet: rollout of step 2: lane {lane.manager.step}, "
                     f"child {child_step}, gate {g}, events {ro}")
            if set(g) != {"v", "state", "wave", "approved", "denied",
                          "all"} or g["v"] != 1:
                fail(f"fleet: the gate {g} lacks the JAX write_gate schema")
            out["rollout_s"] = t_fleetwide - ro["canary"]["t"]
            print(f"fleet: step 2 saved under the burst: canary "
                  f"(the lane) at +{ro['canary']['t'] - t_commit2:.2f} s, "
                  f"wave 1 {ro['wave']['replicas']} at "
                  f"+{ro['wave']['t'] - t_commit2:.2f} s, fleet-wide at "
                  f"+{t_fleetwide - t_commit2:.2f} s: canary -> fleet-wide "
                  f"{out['rollout_s']:.2f} s (the highest SLO burn so far "
                  f"{out['max_burn']:.2f}); gate {g} [{card}]",
                  flush=True)

            # -- 3. a corrupt step 3: the canary rejects it ----------------
            stage = os.path.join(root, "stage")
            src = TorchNet(spec, seed=3, device="cpu")
            path = ckpt.save(stage, {"params": params_to_jax(
                src.net, src.params)}, step=3)
            del src
            npz = os.path.join(path, "state.npz")
            with open(npz, "rb") as f:
                raw = bytearray(f.read())
            raw[len(raw) // 2] ^= 0x01
            with open(npz, "wb") as f:
                f.write(bytes(raw))
            os.rename(path, os.path.join(ck, "step-3"))
            wait_for(lambda: any(e.get("step") == 3 for e in
                                 events("rollout", "halt")),
                     "the step-3 halt", 120.0)
            halt = [e for e in events("rollout", "halt")
                    if e.get("step") == 3][0]
            g = read_gate(gate)
            if g.get("denied") != [3] or g.get("all") != 2 or \
                    lane.manager.step != 2 or \
                    lane.manager.swap_failures < 1:
                fail(f"fleet: the corrupt step 3: gate {g}, lane step "
                     f"{lane.manager.step}, rejections "
                     f"{lane.manager.swap_failures}, halt {halt}")
            print(f"fleet: corrupt step 3 (one flipped byte): the canary "
                  f"rejected it, the rollout halted ({halt['why']}); gate "
                  f"denied {g['denied']}, all {g['all']} [{card}]",
                  flush=True)

            # -- 4. kill -9 the child: replaced and named ------------------
            os.kill(child["pid"], signal.SIGKILL)
            t_kill = time.time()
            wait_for(lambda: events("up", "replace"), "the replacement",
                     300.0)
            dead = events("down", "dead")
            if not dead or dead[0]["replica"] != up["replica"] or \
                    not dead[0].get("proc_dead"):
                fail(f"fleet: the dead replica was not named: {dead}")
            repl = grows[-1]
            wait_for(lambda: events("up", "replace")[0]["replica"] in
                     first_routed, "the replacement's first reply", 60.0)
            print(f"fleet: killed {child['tag']} (SIGKILL); the controller "
                  f"named {dead[0]['replica']} dead "
                  f"{dead[0]['t'] - t_kill:.2f} s later and grew "
                  f"{repl['tag']} (replace, spawn "
                  f"{repl['t_up'] - repl['t_decide']:.2f} s) [{card}]",
                  flush=True)
        finally:
            stop_burst.set()
            join(burst, "burst")
        t_burst_end = time.time()
        if burst_err:
            fail(f"fleet: the burst: {burst_err[:3]}")

        # a fixed request to the replacement alone, over its own wire
        rhost, rport = repl["url"][len("spkn://"):].rsplit(":", 1)
        cli = BinaryClient(rhost, int(rport), timeout=120.0, use_shm=False)
        try:
            child_prob = cli.infer(fixed, model="caffenet",
                                   deadline_s=60.0)["prob"]
            child_fixed_step = cli.last_step
        finally:
            cli.close()

        # -- 5. trickle: the page resolves, the fleet shrinks -------------
        tr_rows, tr_err = [], []
        stop_tr = threading.Event()
        trickle = run_clients(1, 1, bfe.address, stop_tr, tr_rows, tr_err)
        try:
            wait_for(lambda: "caffenet" not in
                     router.alerter.firing_pages(), "the page's resolve",
                     120.0)
            out["page_resolve_s"] = time.time() - t_burst_end
            wait_for(lambda: events("down", "quiet"), "the shrink", 120.0)
            wait_for(lambda: len(router.replicas["caffenet"]) == 1 and
                     not fc._retiring, "the retire", 60.0)
            n_during = len(tr_rows)
            time.sleep(1.0)
        finally:
            stop_tr.set()
            join(trickle, "trickle")
        if tr_err:
            fail(f"fleet: the trickle dropped requests: {tr_err[:3]}")
        down = events("down", "quiet")[0]
        print(f"fleet: trickle of 1 client: the page resolved "
              f"{out['page_resolve_s']:.2f} s after the burst ended; "
              f"shrank {down['replica']} through a drain (retired after "
              f"{fc.cfg.drain_grace_s} s), {len(tr_rows)} trickle requests "
              f"answered ({n_during} before the retire), none dropped "
              f"[{card}]", flush=True)

        # the JAX package's keys on the three routes
        def get(path):
            with urllib.request.urlopen(f"http://{host}:{sport}{path}",
                                        timeout=30) as r:
                return json.loads(r.read())
        fst, sst = get("/fleet/status"), get("/slo/status")
        tsi = get("/timeseries")
        ts = get("/timeseries?name=sparknet_serve_request_latency_seconds"
                 "&window=60&model=caffenet")
        for name, body, keys in (
                ("/fleet/status", fst, JAX_FLEET_STATUS_KEYS),
                ("/slo/status", sst, JAX_SLO_STATUS_KEYS),
                ("/timeseries", tsi, JAX_TIMESERIES_INDEX_KEYS),
                ("/timeseries?name=...", ts, JAX_TIMESERIES_KEYS)):
            if set(body) != keys:
                fail(f"fleet: {name} keys {sorted(body)} (want the JAX "
                     f"package's {sorted(keys)})")
        if fst["models"]["caffenet"]["replicas"] != 1 or \
                fst["rollout"]["caffenet"]["denied"] != [3]:
            fail(f"fleet: /fleet/status {fst['models']} {fst['rollout']}")
        fired = [a for a in sst["audit"] if a["severity"] == "page"]
        if {a["edge"] for a in fired} != {"firing", "resolved"}:
            fail(f"fleet: the page's edges on /slo/status: {fired}")
        print(f"fleet: /fleet/status, /slo/status and /timeseries answer "
              f"with the JAX package's keys; {fst['scale_events']} audited "
              f"events, {sst['alerts_fired_total']} alert edges fired; "
              f"history samples {len(sample_ms)}, "
              f"{statistics.median(sample_ms):.3f} ms median, "
              f"{max(sample_ms):.3f} ms max [{card}]", flush=True)
        out["history_sample_ms"] = statistics.median(sample_ms)

        # every reply from step 1 or 2, never 3; each request answered
        # once; every request sent after step 2 went fleet-wide from step 2
        rows = burst_rows + tr_rows
        steps = {r[3] for r in rows}
        late = {r[3] for r in rows if r[0] >= t_fleetwide}
        if not steps <= {1, 2} or late != {2} or child_fixed_step != 2:
            fail(f"fleet: reply steps {steps}, after step 2 went "
                 f"fleet-wide {late}, the child's fixed request "
                 f"{child_fixed_step}")
        hist_routed = sum(routed.value(model="caffenet", replica=r)
                          or 0 for r in set(
                              ["local:caffenet"] + list(first_routed)))
        print(f"fleet: {len(rows)} CaffeNet replies to the clients "
              f"(steps {sorted(steps)}; from step 2 only after "
              f"+{t_fleetwide - t_burst:.2f} s), {hist_routed:.0f} routed "
              f"legs [{card}]", flush=True)
        if hist_routed < len(rows):
            fail(f"fleet: {hist_routed} routed legs for {len(rows)} replies")

        def window_stats(r0, r1):
            sel = [r for r in burst_rows if r0 <= r[1] < r1]
            lat = [r[2] for r in sel]
            return len(sel) / max(r1 - r0, 1e-9), lat
        img_b, lat_b = window_stats(t_burst, t_grown)
        img_a, lat_a = window_stats(t_grown, t_commit2)
        print(f"fleet: the burst before the grow {img_b:.1f} img/s, client "
              f"{_quantiles_ms(lat_b)}; after {img_a:.1f} img/s, "
              f"{_quantiles_ms(lat_a)} [{card}]", flush=True)
        out.update(img_s_before=img_b, img_s_after=img_a)
    finally:
        mon_stop.set()
        if fc is not None:
            fc.stop()         # drains and retires what it still owns
        for fe in fes:
            fe.stop()
        if router is not None:
            router.stop()
        if provider is not None:
            provider.stop()
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    try:
        # the in-process counts first; then the lane's direct forward
        launches, bf16 = lrn_fwd.launches, lrn_fwd.bf16_launches
        local_forwards = len(lane.batch_log) + lane.manager.forwards
        one = zeros_batch(net, 1)
        one["data"][0] = fixed["data"]
        direct = net.forward(one, ["prob"])["prob"][0]
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = \
            det
    err = float(np.abs(np.asarray(child_prob) - direct).max())
    if err > 1e-6:
        fail(f"fleet: the replacement's prob for the fixed request is "
             f"{err:.3e} from the lane's direct bucket-1 forward (want "
             f"<= 1e-6: the same step, the same card)")

    # the SLO report from the shards, against the clients' own count
    rep = subprocess.run(
        [sys.executable, "-m", "sparknet_tpu_torch.obs.slo", hist_dir,
         "--json", "--window", "1", "--model", "caffenet", "--latency-ms",
         f"{slo_ms:g}", "--availability", "0.999", "--latency-metric",
         ROUTED_LATENCY],
        capture_output=True, text=True, timeout=120,
        cwd=os.path.dirname(os.path.abspath(__file__)))
    if rep.returncode != 0:
        fail(f"fleet: the SLO report exited {rep.returncode}: "
             f"{rep.stderr[-2000:]}")
    report = json.loads(rep.stdout)
    lat_slo = report["models"]["caffenet"]["slo"]["latency"]
    # the report's own windows (its `_windows` over the shards' slots),
    # each classified from the shards and from the clients' replies in the
    # same slots; a window that missed on one side must have a missed
    # window on the other within one slot
    fams, slots = read_history_shards(hist_dir)
    budget = slo_spec.budget("latency")
    le = fams[ROUTED_LATENCY]["le"]
    wins = []
    for w0, w1, group in slo_mod._windows(slots,
                                          report["report_window_s"]):
        err, n = slo_mod._slot_err_frac(group, slo_spec, "latency", le)
        if n == 0:
            continue
        lat = [r[2] for r in burst_rows + tr_rows
               if group[0].t0 <= r[1] < group[-1].t1]
        over = sum(x > slo_s for x in lat)
        wins.append((err > budget, None if not lat else
                     over / len(lat) > budget,
                     (round(w0 - t_burst, 2), n, round(err, 4), len(lat),
                      over)))
    att_r = sum(not a for a, _, _ in wins) / len(wins)
    seen = [c for _, c, _ in wins if c is not None]
    att_c = sum(not c for c in seen) / len(seen)

    def near(i, side):
        return any(0 <= j < len(wins) and wins[j][side]
                   for j in (i - 1, i, i + 1))
    apart = [i for i, (a, c, _) in enumerate(wins)
             if (a and not near(i, 1)) or (c and not near(i, 0))]
    print(f"fleet: SLO report ({report['span']['slots']} slots, "
          f"{lat_slo['windows']} windows of {report['report_window_s']:g} s "
          f"with traffic): latency attainment {lat_slo['attainment']:.4f}, "
          f"{sum(a for a, _, _ in wins)} windows missed p99 <= {slo_ms:g} ms, "
          f"budget consumed {lat_slo['budget_consumed']:.4f}; the clients' "
          f"own count of replies over S: {sum(c for c in seen)} of "
          f"{len(seen)} windows missed, attainment {att_c:.4f}; windows "
          f"apart by more than one slot: {apart} [{card}]", flush=True)
    if lat_slo["windows"] != len(wins) or \
            abs(lat_slo["attainment"] - round(att_r, 6)) > 1e-6:
        fail(f"fleet: the report's attainment {lat_slo['attainment']} over "
             f"{lat_slo['windows']} windows, its windows re-read "
             f"{att_r} over {len(wins)}")
    if apart:
        fail(f"fleet: the report and the clients' count disagree beyond "
             f"one history slot in windows {apart}: " + "; ".join(
                 f"{i}: {wins[i]}" for i in range(
                     max(0, min(apart) - 2), min(len(wins),
                                                 max(apart) + 3))))
    out["attainment"] = {"report": lat_slo["attainment"], "clients": att_c}

    # kernels: 2 lrn_fwd launches per CaffeNet forward, every process
    kids = []
    for g in grows:
        path = g["hb"] + ".counts.json"
        try:
            with open(path) as f:
                kids.append(dict(json.load(f), tag=g["tag"]))
        except OSError:
            kids.append({"tag": g["tag"], "lrn_fwd": 0, "bf16": 0,
                         "forwards": 0})
    shutil.rmtree(root, ignore_errors=True)
    if device == "cuda":
        if launches != 2 * local_forwards or bf16 != 0:
            fail(f"fleet: lrn_fwd launched {launches} times ({bf16} bf16) "
                 f"over {local_forwards} forwards here (want 2 per "
                 f"forward, f32)")
        for k in kids:
            if k["lrn_fwd"] != 2 * k["forwards"] or k["bf16"] != 0 or \
                    k["forwards"] < 1:
                fail(f"fleet: replica {k['tag']}'s lrn_fwd {k} (want 2 per "
                     f"forward, f32)")
    print(f"fleet: lrn_fwd launches {launches} = 2 x {local_forwards} "
          f"forwards here; " + "; ".join(
              f"{k['tag']} {k['lrn_fwd']} = 2 x {k['forwards']}"
              for k in kids)
          + f"; the replacement's fixed request within {err:.3e} of the "
          f"lane's direct forward; phase {time.perf_counter() - t_phase:.1f}"
          f" s [{card}]", flush=True)
    out["launches"] = {"local": launches,
                       **{k["tag"]: k["lrn_fwd"] for k in kids}}
    out["forwards"] = {"local": local_forwards,
                       **{k["tag"]: k["forwards"] for k in kids}}
    return out


#: phase 13's fc7 tolerance against the direct forward, relative to the
#: largest |fc7|: the float32 policy turns TF32 off, so a row differs only
#: by cuDNN's and cuBLAS's sum order in the bucket batch formation picked
BATCH_FC7_RTOL = 1e-4


def phase_batch(card: str, device: str = "cuda", crop: int = 227,
                n_rows: int = 512, unit_rows: int = 64,
                pace_s: float = 0.1) -> dict:
    """Phase 13: bulk inference and the warm-up cache (module docstring);
    returns the launch counts and forwards of both replicas. The
    arguments let the phase be rehearsed on the CPU at a small crop
    (counts then 0, and no kernel is built)."""
    import shutil
    import signal
    import tempfile
    import threading

    import numpy as np

    from sparknet_tpu_torch import precision, zoo
    from sparknet_tpu_torch.batch import (BatchConfig, BatchDriver,
                                          load_manifest, store)
    from sparknet_tpu_torch.batch import manifest as mf
    from sparknet_tpu_torch.fleet import SubprocessReplicaProvider
    from sparknet_tpu_torch.model.net import params_to_jax
    from sparknet_tpu_torch.net_api import TorchNet
    from sparknet_tpu_torch.serve.server import zeros_batch
    from sparknet_tpu_torch.utils import checkpoint as ckpt

    precision.set_policy("float32")
    spec = zoo.caffenet(batch=128, crop=crop, n_classes=1000)
    root = tempfile.mkdtemp(prefix="chip_smoke_batch_")
    ck = os.path.join(root, "ck")
    cache = os.path.join(root, "kernel-cache")   # empty: the cold start
    out_dir = os.path.join(root, "out")
    inp = os.path.join(root, "input.npz")
    jsonl = [os.path.join(root, "driver-run1.jsonl"),
             os.path.join(root, "driver-run2.jsonl")]
    out: dict = {}
    t_phase = time.perf_counter()
    provider = driver_proc = None
    handles: dict = {}

    def child_counts(h) -> dict:
        with open(h.heartbeat_path + ".counts.json") as f:
            return json.load(f)

    try:
        src = TorchNet(spec, seed=0, device="cpu")
        ckpt.save(ck, {"params": params_to_jax(src.net, src.params)},
                  step=1)
        del src
        child_py = os.path.join(root, "child_python")
        with open(os.path.join(root, "child.py"), "w") as f:
            f.write(_FLEET_CHILD_SRC)
        with open(child_py, "w") as f:
            f.write(f"#!/bin/sh\nexec '{sys.executable}' "
                    f"'{os.path.join(root, 'child.py')}' \"$@\"\n")
        os.chmod(child_py, 0o755)
        extra = ["--crop", str(crop), "--n-classes", "1000", "--buckets",
                 ",".join(map(str, SERVE_BUCKETS)), "--max-wait-ms", "2",
                 "--workdir", os.path.join(root, "children")]
        if device == "cpu":
            extra += ["--device", "cpu"]
        provider = SubprocessReplicaProvider(
            {"caffenet": "caffenet"}, workdir=os.path.join(root, "fleet"),
            max_batch=128, outputs=("prob",), compile_cache_dir=cache,
            heartbeat_every_s=0.5, spawn_timeout_s=300.0, extra_args=extra,
            python=child_py, checkpoint_dir=ck, poll_interval_s=5.0)
        # -- 1. two replicas: A on the cold cache, then B on the warm one
        spawn_s = {}
        for name in ("a", "b"):
            t0 = time.perf_counter()
            handles[name] = provider.grow("caffenet")
            spawn_s[name] = time.perf_counter() - t0
            cmd = handles[name].meta["proc"].args
            if cmd[cmd.index("--compile-cache") + 1] != cache:
                fail(f"batch: child {name} was not handed the warm-up "
                     f"cache: {cmd}")
        out["spawn_s"] = spawn_s
        addrs = {k: h.url.split("://", 1)[1] for k, h in handles.items()}
        cold = {k: child_counts(h) for k, h in handles.items()}
        for k in ("a", "b"):
            print(f"batch: child {k.upper()} (pid {cold[k]['pid']}) up at "
                  f"spkn://{addrs[k]} {spawn_s[k]:.2f} s after its spawn "
                  f"(PR 13's grown children: 10.6-10.8 s); nvcc builds "
                  f"{cold[k]['builds']}; compile events "
                  f"{cold[k]['compile_stats']} [{card}]", flush=True)
        want_builds = ["lrn_fwd"] if device != "cpu" else []
        if cold["a"]["builds"] != want_builds:
            fail(f"batch: child A on the cold cache ran nvcc for "
                 f"{cold['a']['builds']}, not {want_builds}")
        if cold["b"]["builds"]:
            fail(f"batch: child B on the warm cache ran nvcc for "
                 f"{cold['b']['builds']}")
        if device != "cpu" and not any(
                n.startswith("lrn_fwd-") and n.endswith(".so")
                for n in os.listdir(cache)):
            fail(f"batch: no lrn_fwd library in the warm-up cache: "
                 f"{os.listdir(cache)}")
        print(f"batch: child A's nvcc run happened in the server's start, "
              f"in the install canary's compile region; it joins A's "
              f"first serve_bucket event (its first request's bucket), "
              f"checked below [{card}]", flush=True)

        # -- 2. the input and the job, killed mid-way ----------------------
        rng = np.random.default_rng(13)
        x = (50.0 * rng.standard_normal((n_rows, crop, crop, 3),
                                        dtype=np.float32))
        np.savez(inp, data=x)
        n_units = len(mf.plan_units(n_rows, unit_rows))
        env = dict(os.environ)
        env["PYTHONPATH"] = (os.path.dirname(os.path.abspath(__file__))
                             + os.pathsep + env.get("PYTHONPATH", ""))
        common = ["--input", inp, "--out", out_dir, "--replicas",
                  f"{addrs['a']},{addrs['b']}", "--outputs", "fc7",
                  "--unit-rows", str(unit_rows), "--window", "16",
                  "--concurrency", "2", "--tenant", "batch", "--priority",
                  "low", "--deadline-ms", "60000", "--timeout-s", "120",
                  "--pace-s", str(pace_s)]
        t1 = time.perf_counter()
        driver_proc = subprocess.Popen(
            [sys.executable, "-m", "sparknet_tpu_torch.batch.driver",
             *common, "--jsonl", jsonl[0]], env=env,
            stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)
        t_start = None      # the driver writes its empty manifest, then starts
        while True:
            if driver_proc.poll() is not None:
                fail(f"batch: the driver exited {driver_proc.returncode} "
                     f"before the kill: {driver_proc.stderr.read()[-3000:]}")
            m = load_manifest(out_dir) if os.path.exists(
                os.path.join(out_dir, mf.MANIFEST_NAME)) else None
            if m is not None and t_start is None:
                t_start = time.perf_counter()
            if m is not None and len(m["units"]) >= 2:
                t_seen = time.perf_counter()
                break
            if time.perf_counter() - t1 > 300:
                fail("batch: the driver committed no 2 units in 300 s")
            time.sleep(0.02)
        driver_proc.send_signal(signal.SIGKILL)
        driver_proc.wait(timeout=60)
        t_kill = time.perf_counter()
        driver_proc.stderr.close()
        driver_proc = None
        partial = load_manifest(out_dir)
        before = len(partial["units"])
        if partial["done"] or not 0 < before < n_units:
            fail(f"batch: the kill landed at {before} of {n_units} units")
        rows_before = sum(u["rows"] for u in partial["units"].values())
        run1_rows_s = rows_before / (t_seen - t_start)
        print(f"batch: driver SIGKILLed {t_kill - t_start:.2f} s into its "
              f"job ({t_start - t1:.2f} s from its spawn to its manifest) "
              f"with {before} of {n_units} units committed ({rows_before} "
              f"rows; {run1_rows_s:.1f} rows/s, paced {pace_s} s a unit) "
              f"[{card}]", flush=True)

        # -- 3. the resume in this process, child A killed under it -------
        on_a = threading.Event()
        a_port = int(addrs["a"].rsplit(":", 1)[1])

        class Driver(BatchDriver):
            """Signals when a unit is dispatched to child A."""

            def _unit_rows_out(self, cli, data, lo, hi, trace=None):
                if cli.addr[1] == a_port:
                    on_a.set()
                return super()._unit_rows_out(cli, data, lo, hi, trace)

        cfg = BatchConfig(
            input=inp, output=out_dir,
            replicas=[addrs["a"], addrs["b"]], outputs=("fc7",),
            unit_rows=unit_rows, window=16, concurrency=2, tenant="batch",
            priority="low", deadline_s=60.0, request_timeout_s=120.0,
            pace_s=pace_s, backoff_cap_s=0.2, jsonl_path=jsonl[1])
        drv = Driver(cfg)
        res: dict = {}
        errs: list = []

        def resume():
            try:
                res.update(drv.run())
            except BaseException as e:  # reported below
                errs.append(e)
        th = threading.Thread(target=resume, name="batch-resume",
                              daemon=True)
        th.start()
        if not on_a.wait(timeout=300):
            fail("batch: the resumed job sent no unit to child A")
        time.sleep(0.05)                 # its first rows are in flight
        a_proc = handles["a"].meta["proc"]
        a_proc.send_signal(signal.SIGKILL)
        a_proc.wait(timeout=60)
        th.join(timeout=600)
        if th.is_alive():
            fail("batch: the resumed job did not finish in 600 s")
        if errs:
            fail(f"batch: the resumed job raised {errs[0]!r}")
        print(f"batch: resumed in process: {json.dumps(res)} [{card}]",
              flush=True)
        out["rows_per_s"] = {"run1": run1_rows_s,
                             "resume": res["rows_per_s"]}

        # -- 4. the checks -------------------------------------------------
        if not res["done"] or res["units_skipped_resume"] != before:
            fail(f"batch: done {res['done']}, units_skipped_resume "
                 f"{res['units_skipped_resume']} (committed before the "
                 f"kill: {before})")
        m = load_manifest(out_dir)
        plan = mf.plan_units(n_rows, unit_rows)
        if sorted((u["start"], u["stop"]) for u in m["units"].values()) \
                != sorted(plan):
            fail(f"batch: the manifest's units are not the plan: "
                 f"{m['units']}")
        names = set(store.list_names(out_dir))
        parts = {mf.part_name(u) for u in range(n_units)}
        if names != parts | {mf.MANIFEST_NAME}:
            fail(f"batch: parts and manifest rows differ: {sorted(names)}")
        fc7 = np.zeros((n_rows, 4096), np.float32)
        seen = np.zeros(n_rows, np.int64)
        for uid_s, u in m["units"].items():
            with np.load(os.path.join(out_dir, mf.part_name(int(uid_s)))) \
                    as z:
                if set(z.files) != {"fc7"} or \
                        z["fc7"].shape != (u["rows"], 4096):
                    fail(f"batch: part {uid_s} holds "
                         f"{[(k, z[k].shape) for k in z.files]}")
                fc7[u["start"]:u["stop"]] = z["fc7"]
                seen[u["start"]:u["stop"]] += 1
        if not (seen == 1).all():
            fail(f"batch: rows not in exactly one part: "
                 f"{np.flatnonzero(seen != 1)[:10]}")
        rows2 = [json.loads(l) for l in open(jsonl[1])]
        retries = [r for r in rows2 if r.get("event") == "batch_retry"]
        errors = [r for r in retries if r["kind"] == "error"]
        if not errors:
            fail(f"batch: no retry of kind error after child A's SIGKILL: "
                 f"{retries}")
        retried = {int(r["unit"]) for r in errors}
        for uid in retried:
            u = m["units"][str(uid)]
            if u["replica"] != addrs["b"] or u["attempts"] < 2:
                fail(f"batch: unit {uid}, retried after child A's kill, "
                     f"was committed by {u['replica']} in "
                     f"{u['attempts']} attempts")
        by_rep: dict = {}
        for u in m["units"].values():
            by_rep[u["replica"]] = by_rep.get(u["replica"], 0) + 1
        print(f"batch: {n_rows} rows in {n_units} parts, each exactly "
              f"once; units by replica {by_rep}; retries of kind error "
              f"{len(errors)} (units {sorted(retried)}, each committed by "
              f"child B), shed {len(retries) - len(errors)} [{card}]",
              flush=True)
        # the direct forward: bucket-128 buffers as the server fills them
        ref_net = TorchNet(spec, seed=0, device=device)
        ref = np.zeros_like(fc7)
        for lo in range(0, n_rows, 128):
            buf = zeros_batch(ref_net, 128)
            hi = min(lo + 128, n_rows)
            buf["data"][:hi - lo] = x[lo:hi]
            ref[lo:hi] = ref_net.forward(buf, ["fc7"])["fc7"][:hi - lo]
        err = float(np.abs(fc7 - ref).max())
        scale = float(np.abs(ref).max())
        out["fc7_max_abs_err"], out["fc7_scale"] = err, scale
        print(f"batch: fc7 against a direct bucket-128 forward of each row "
              f"here: max abs diff {err:.3e} of max |fc7| {scale:.3e} "
              f"({err / max(scale, 1e-30):.3e} relative; tolerance "
              f"{BATCH_FC7_RTOL:g} relative) [{card}]", flush=True)
        if not np.isfinite(fc7).all() or not err <= BATCH_FC7_RTOL * scale:
            fail(f"batch: fc7 differs from the direct forward by {err:.3e} "
                 f"(tolerance {BATCH_FC7_RTOL * scale:.3e})")

        # -- the replicas' counts and compile events -----------------------
        provider.retire(handles["b"])
        counts = {k: child_counts(h) for k, h in handles.items()}
        for k, c in counts.items():
            print(f"batch: child {k.upper()}: {c['forwards']} forwards, "
                  f"lrn_fwd {c['lrn_fwd']} launches ({c['bf16']} bf16), "
                  f"nvcc builds {c['builds']}, compile events "
                  f"{c['compile_stats']} [{card}]", flush=True)
            want = 2 * c["forwards"] if device != "cpu" else 0
            if c["lrn_fwd"] != want or c["bf16"]:
                fail(f"batch: child {k.upper()} launched lrn_fwd "
                     f"{c['lrn_fwd']} times ({c['bf16']} bf16) in "
                     f"{c['forwards']} forwards")
        misses_b = {w: s["cache_misses"]
                    for w, s in counts["b"]["compile_stats"].items()}
        if counts["b"]["builds"] or any(misses_b.values()):
            fail(f"batch: the warm child B built {counts['b']['builds']} "
                 f"and recorded cache_hit=false events {misses_b}")
        # the cold child A's build shows in a compile event (ROADMAP C1)
        misses_a = {w: s["cache_misses"]
                    for w, s in counts["a"]["compile_stats"].items()}
        print(f"batch: cache_hit=false events: child A {misses_a}, child B "
              f"{misses_b} [{card}]", flush=True)
        if device != "cpu" and not misses_a.get("serve_bucket"):
            fail(f"batch: the cold child A ran nvcc but recorded no "
                 f"cache_hit=false serve_bucket event: {misses_a}")
        out["cache_misses"] = {"a": misses_a, "b": misses_b}
        if counts["b"]["forwards"] == 0:
            fail("batch: child B answered nothing")
        out["launches"] = {k: c["lrn_fwd"] for k, c in counts.items()}
        out["forwards"] = {k: c["forwards"] for k, c in counts.items()}
        out["builds"] = {k: c["builds"] for k, c in counts.items()}

        # -- 5. the console ------------------------------------------------
        r = subprocess.run(
            [sys.executable, "-m", "sparknet_tpu_torch.obs.summary",
             "--json", *jsonl], env=env, capture_output=True, text=True,
            timeout=120)
        if r.returncode != 0:
            fail(f"batch: sparknet-metrics exited {r.returncode}: "
                 f"{r.stderr[-2000:]}")
        view = json.loads(r.stdout)["batch"]
        run1_rows = sum(1 for l in open(jsonl[0])
                        if json.loads(l).get("event") == "batch_unit")
        # a SIGKILL between a manifest row and its JSONL row loses the
        # latter: the killed run's JSONL may hold one unit fewer
        if not before - 1 <= run1_rows <= before or \
                view["units"] != run1_rows + n_units - before or \
                view["retries_by_kind"].get("error", 0) != len(errors):
            fail(f"batch: the batch view reads {view} (units committed "
                 f"before the kill {before}, in its JSONL {run1_rows})")
        print(f"batch: sparknet-metrics batch view: units {view['units']}, "
              f"rows {view['rows']}, retries {view['retries_by_kind']}, "
              f"units by replica {view['units_by_replica']} [{card}]",
              flush=True)
        t0 = time.perf_counter()
        sc = [sys.executable, "-m", "sparknet_tpu_torch.obs.summary",
              "--selfcheck", "--json"]
        if device == "cpu":
            sc += ["--device", "cpu"]
        r = subprocess.run(sc, env=env, capture_output=True, text=True,
                           timeout=600, cwd=root)
        if r.returncode != 0:
            fail(f"batch: sparknet-metrics --selfcheck exited "
                 f"{r.returncode}: {r.stderr[-3000:]}")
        s = json.loads(r.stdout.strip().splitlines()[-1])
        missing = [v for v in ("serve", "freshness", "fleet", "batch", "slo",
                               "step_time_breakdown") if not s.get(v)]
        if missing or not s["rounds"]:
            fail(f"batch: the selfcheck summary lacks {missing} (rounds "
                 f"{s['rounds']})")
        print(f"batch: sparknet-metrics --selfcheck on {device}: exit 0 in "
              f"{time.perf_counter() - t0:.1f} s, {s['rounds']} loss rows, "
              f"views serve, freshness, fleet, batch, slo [{card}]",
              flush=True)
    finally:
        if driver_proc is not None:
            driver_proc.kill()
            driver_proc.wait(timeout=30)
        if provider is not None:
            provider.stop()
        shutil.rmtree(root, ignore_errors=True)
    out["seconds"] = time.perf_counter() - t_phase
    print(f"batch: phase 13 passed in {out['seconds']:.1f} s: rows/s "
          f"{out['rows_per_s']['run1']:.1f} (first run) and "
          f"{out['rows_per_s']['resume']:.1f} (resumed); fc7 max abs diff "
          f"{out['fc7_max_abs_err']:.3e}; spawn to port A "
          f"{out['spawn_s']['a']:.2f} s (cold cache), B "
          f"{out['spawn_s']['b']:.2f} s (warm) [{card}]", flush=True)
    return out


def phase_trainers(card: str, phase4_round_s=None, device: str = "cuda",
                   crop: int = 227, batch: int = 256, tau: int = 5,
                   rounds: int = 10, n_classes: int = 1000) -> dict:
    """Phase 14 (module docstring): the trainers beyond parity at a world
    of one. Returns each run's launch counts, warm round seconds and peak
    memory, and the MFU figures. The runs collect inline
    (`collect_async=False`): a round's timer then holds the wait for the
    previous round's scalars, so in steady state it is the period of a
    round on the card, not the time to queue it; the medians take 9 warm
    rounds a run. The arguments let the phase be rehearsed
    on the CPU at a small size (counts then 0, MFU not measured)."""
    import dataclasses
    import statistics
    import tempfile

    import numpy as np
    import torch

    from sparknet_tpu_torch import zoo
    from sparknet_tpu_torch.data.dataset import ArrayDataset
    from sparknet_tpu_torch.model.net import CompiledNet
    from sparknet_tpu_torch.parallel.mesh import init_data_group
    from sparknet_tpu_torch.parallel.sharded import ShardedTrainer
    from sparknet_tpu_torch.parallel.trainer import ParallelTrainer
    from sparknet_tpu_torch.solver import SolverConfig
    from sparknet_tpu_torch.utils import checkpoint as ckpt
    from sparknet_tpu_torch.utils import flops
    from sparknet_tpu_torch.utils.config import RunConfig

    r = np.random.default_rng(14)
    n = tau * batch
    data = r.integers(-128, 128, (n, crop, crop, 3), dtype=np.int8)
    labels = r.integers(0, n_classes, (n, 1)).astype(np.int32)
    train_ds = ArrayDataset({"data": data, "label": labels})
    spec = zoo.caffenet(batch=batch, crop=crop, n_classes=n_classes)
    solver = SolverConfig(**IMAGENET_SOLVER)
    kernels = device == "cuda"
    steps = tau * rounds
    plan = [("shard_map", "shard_map", "replicated", None),
            ("named replicated", "named", "replicated", None),
            ("named momentum", "named", "momentum", None),
            ("named full per-shard", "named", "full", "on"),
            ("named full monolithic", "named", "full", "off")]
    det = (torch.backends.cudnn.deterministic,
           torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    out: dict = {"launches": {}, "round_s": {}, "peak_gib": {}}
    t_phase = time.perf_counter()
    try:
        with tempfile.TemporaryDirectory(prefix="chip_smoke_trainers_") \
                as tmp:
            base = RunConfig(model="caffenet", n_classes=n_classes,
                             crop=crop, solver=solver, tau=tau,
                             local_batch=batch, max_rounds=rounds,
                             eval_every=0, precision="bfloat16", seed=0,
                             workdir=tmp, checkpoint_every=rounds,
                             checkpoint_async=False, collect_async=False)
            runs = {}
            for label, impl, sharding, fmt in plan:
                cfg = dataclasses.replace(
                    base, trainer_impl=impl, state_sharding=sharding,
                    checkpoint_dir=(os.path.join(tmp, f"ck-{fmt}")
                                    if fmt else None),
                    checkpoint_sharded=fmt or "auto")
                # the earlier runs' states stay on the card for the
                # comparisons below: this run's peak counts above them
                held = (torch.cuda.memory_allocated() / 2 ** 30
                        if kernels else 0.0)
                run = runs[label] = _train_run(
                    card, cfg, spec, train_ds, None,
                    f"trainers {label}: caffenet {crop}/{n_classes} "
                    f"b{batch} bf16 tau{tau}", device)
                if kernels:
                    _expect_counts(label, run["counts"], {
                        "lrn_fwd": 2 * steps, "lrn_fwd_scale": 0,
                        "lrn_bwd": 2 * steps, "maxpool_bwd": 3 * steps})
                warm = [x["round_s"] for x in run["rounds"][1:]]
                out["launches"][label] = run["counts"]
                out["round_s"][label] = warm
                out["peak_gib"][label] = run["peak_gib"] - held
                st = run["state"]
                print(f"trainers[{label}]: warm rounds {_stats(warm)} s "
                      f"({tau * batch / statistics.median(warm):.1f} "
                      f"img/s), peak device memory "
                      f"{run['peak_gib'] - held:.3f} GiB above the "
                      f"{held:.3f} GiB held before the run, at-rest state "
                      f"{st.flat_params.numel()} + "
                      f"{st.flat_momentum.numel()} elements [{card}]",
                      flush=True)

            # every named run is the shard_map run, bit for bit: at one
            # rank the gather, the reduce-scatter and the division by 1
            # are exact (a ZeRO leaf's one piece is the whole leaf)
            ref = runs["shard_map"]
            ref_loss = [x["loss"] for x in ref["rounds"]]
            for label, run in runs.items():
                loss = [x["loss"] for x in run["rounds"]]
                diff = [f"{kind}/{l}/{p}"
                        for kind in ("params", "momentum")
                        for l, lp in getattr(ref["state"], kind).items()
                        for p, t in lp.items()
                        if not torch.equal(getattr(run["state"], kind)[l][p],
                                           t)]
                if loss != ref_loss or diff:
                    fail(f"trainers: {label} is not the shard_map run: "
                         f"losses {loss} vs {ref_loss}, differing leaves "
                         f"{diff[:6]}")
            print(f"trainers: named replicated / momentum / full: losses "
                  f"{ref_loss}, final params and logical momentum "
                  f"torch.equal to the shard_map run's; launches per step "
                  f"lrn_fwd 2 / lrn_bwd 2 / maxpool_bwd 3 in every run "
                  f"[{card}]", flush=True)

            # the "full" run's per-shard and monolithic steps: one flat map
            steps_ = {}
            for fmt in ("on", "off"):
                d = os.path.join(tmp, f"ck-{fmt}")
                flat, step, extra = ckpt.restore_flat(d)
                meta = ckpt._load_meta(os.path.join(d, f"step-{step}"))
                if ("shards" in meta) != (fmt == "on") or step != rounds:
                    fail(f"trainers: checkpoint_sharded={fmt} wrote step "
                         f"{step} with meta keys {sorted(meta)}")
                stamp = (extra.get("layout"), extra.get("state_sharding"),
                         extra.get("tp"), extra.get("n_devices"))
                if stamp != ("logical", "full", 1, 1):
                    fail(f"trainers: step extra (layout, state_sharding, "
                         f"tp, n_devices) = {stamp}")
                steps_[fmt] = (flat, extra)
            on, off = steps_["on"][0], steps_["off"][0]
            if sorted(on) != sorted(off):
                fail(f"trainers: per-shard keys {sorted(on)} != "
                     f"monolithic {sorted(off)}")
            for k in on:
                a, b = on[k], off[k]
                same = (torch.equal(a, b) if isinstance(a, torch.Tensor)
                        else np.asarray(a).dtype == np.asarray(b).dtype
                        and np.array_equal(a, b))
                if not same:
                    fail(f"trainers: per-shard and monolithic {k} differ")
            print(f"trainers: the full run's per-shard and monolithic "
                  f"steps restore to the same {len(on)} leaves bit for "
                  f"bit, stamped layout=logical state_sharding=full "
                  f"[{card}]", flush=True)

            # each step restores into the replica-layout trainer and into a
            # "momentum" trainer: params as saved; the one logical
            # momentum taken as it is (the JAX adapt_state rule)
            full = runs["named full per-shard"]["state"]
            net = CompiledNet.compile(spec)
            group = init_data_group(device, workdir=tmp)
            try:
                for fmt, (flat, extra) in steps_.items():
                    for tr in (ParallelTrainer(net, solver, group, tau=tau),
                               ShardedTrainer(net, solver, group, tau=tau,
                                              state_sharding="momentum")):
                        st = tr.state_from_checkpoint(flat, extra)
                        bad = [f"{kind}/{l}/{p}"
                               for kind in ("params", "momentum")
                               for l, lp in getattr(full, kind).items()
                               for p, t in lp.items()
                               if not torch.equal(
                                   getattr(st, kind)[l][p].detach(),
                                   t.detach())]
                        if bad or st.it != steps:
                            fail(f"trainers: the {fmt} step restored into "
                                 f"{type(tr).__name__} differs at "
                                 f"{bad[:6]} (it {st.it})")
                        del st
            finally:
                group.close()
            print(f"trainers: both steps restore into ParallelTrainer and "
                  f"ShardedTrainer(momentum) with params and momentum "
                  f"torch.equal to the full run's [{card}]", flush=True)
            del runs, full
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark \
            = det

    # FLOPs per image and MFU of the warm rounds
    cnet = CompiledNet.compile(spec)
    fwd = flops.forward_flops_per_image(cnet)
    per_img = flops.train_flops_per_image(cnet)
    kind = torch.cuda.get_device_name(0) if kernels else "cpu"
    peak = flops.peak_bf16_flops(kind)
    print(f"flops: CaffeNet {crop}/{n_classes}: {fwd / 1e9:.6f} GFLOP an "
          f"image forward (conv + inner product), {per_img / 1e9:.6f} a "
          f"training image (x{flops.TRAIN_FWD_MULT:g}), "
          f"utils/flops.py [{card}]", flush=True)
    out["flops_per_image"] = per_img
    out["mfu"] = {}
    cells = ([("phase 4 shard_map", phase4_round_s)] if phase4_round_s
             else []) + [(f"phase 14 {k}", v)
                         for k, v in out["round_s"].items()]
    for name, xs in cells:
        med = statistics.median(xs)
        img_s = tau * batch / med
        if not peak:
            print(f"mfu[{name}]: {img_s:.1f} img/s; MFU not measured (no "
                  f"peak for {kind!r}) [{card}]", flush=True)
            continue
        mfu = img_s * per_img / peak
        out["mfu"][name] = mfu
        print(f"mfu[{name}]: median warm round {med * 1e3:.2f} ms, "
              f"{img_s:.1f} img/s, MFU {100 * mfu:.2f}% of "
              f"{peak / 1e12:g} TFLOP/s dense bf16 [{card}]", flush=True)
    print(f"trainers: phase 14 took {time.perf_counter() - t_phase:.1f} s "
          f"[{card}]", flush=True)
    out["steps"] = steps
    return out


def profile_step(net, params, batch, solver_cfg, card: str,
                 top: int = 14) -> None:
    """One training step (forward, autograd, SGD update) at the main
    path's batch in bfloat16, traced: device kernels by name and the share
    of the step's wall time in which no kernel ran."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from sparknet_tpu_torch.solver import SgdSolver, value_and_grad

    solver = SgdSolver(net, solver_cfg)
    state = solver.init_state(params)
    loss_fn = net.loss_fn()

    def step():
        _, g = value_and_grad(loss_fn, params, batch)
        solver.update(params, state, g)

    step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0

    rows = sorted((e for e in prof.key_averages()
                   if str(e.device_type).endswith("CUDA") and _dev_us(e) > 0),
                  key=_dev_us, reverse=True)
    kernels = sum(_dev_us(e) for e in rows) / 1e3
    print(f"profile: one training step, caffenet b{batch['data'].shape[0]}"
          f" bf16: wall {wall * 1e3:.2f} ms, device kernels {kernels:.2f} "
          f"ms, kernel idle share {max(0.0, 1 - kernels / (wall * 1e3)):.3f}"
          f" [{card}]", flush=True)
    for e in rows[:top]:
        print(f"profile:   {_dev_us(e) / 1e3:9.3f} ms  x{e.count:<4d} "
              f"{e.key[:90]}", flush=True)
    ours = [e for e in rows if any(k in e.key for k in (
        "lrn_fwd_kernel", "lrn_bwd_kernel", "maxpool_bwd_kernel"))]
    print(f"profile:   the port's kernels: "
          f"{sum(_dev_us(e) for e in ours) / 1e3:.3f} ms of {kernels:.2f} ms"
          f" ({', '.join(f'{e.key[:40]} x{e.count}' for e in ours)})",
          flush=True)


def _strip_inits(graph):
    """The graph with its variables' baked initial values dropped (shape
    and dtype kept): the JSON a user serves with a weights npz."""
    from sparknet_tpu_torch.backend import GraphDef, NodeDef
    return GraphDef(name=graph.name, nodes=[
        NodeDef(n.name, n.op, list(n.inputs),
                {k: v for k, v in n.attrs.items()
                 if not (n.op == "Variable" and k == "init")})
        for n in graph.nodes])


def phase_graph(card: str, device: str = "cuda", batch: int = 256,
                tau: int = 5, rounds: int = 3, n_classes: int = 1000,
                buckets=SERVE_BUCKETS, crop: int = 227,
                raw: int = 256) -> dict:
    """Phase 15 (module docstring): the graph backend and the raw-pixel
    door. Returns the door's lrn_fwd launches and forwards and the graph
    round's warm seconds. The arguments let the phase be rehearsed on the
    CPU at a small size (`batch`, `buckets`, and the door's CaffeNet at a
    small `crop` from `raw` pixels)."""
    import dataclasses
    import statistics
    import tempfile

    import numpy as np
    import torch

    from sparknet_tpu_torch import precision, zoo
    from sparknet_tpu_torch.apps.graph_common import train_graph
    from sparknet_tpu_torch.apps.train_loop import prepare_round_batches
    from sparknet_tpu_torch.backend import GraphNet, build_alexnet_graph
    from sparknet_tpu_torch.data.dataset import ArrayDataset, RoundSampler
    from sparknet_tpu_torch.data.preprocess import ImagePreprocessor
    from sparknet_tpu_torch.model.weights import WeightCollection
    from sparknet_tpu_torch.net_api import TorchNet
    from sparknet_tpu_torch.ops.cuda_lrn import lrn_fwd
    from sparknet_tpu_torch.parallel.graph_trainer import GraphTrainer
    from sparknet_tpu_torch.parallel.mesh import init_data_group
    from sparknet_tpu_torch.schema import Field, Schema
    from sparknet_tpu_torch.serve import app as serve_app
    from sparknet_tpu_torch.serve.server import InferenceServer, ServeConfig
    from sparknet_tpu_torch.utils.config import RunConfig

    t_phase = time.perf_counter()
    precision.set_policy("float32")
    t0 = time.perf_counter()
    graph = build_alexnet_graph(batch=batch, n_classes=n_classes)
    print(f"graph: build_alexnet_graph(batch={batch}, n_classes="
          f"{n_classes}): {len(graph.nodes)} nodes in "
          f"{time.perf_counter() - t0:.2f}s", flush=True)
    r = np.random.default_rng(15)
    n = tau * batch
    # mean-subtracted pixel range, NHWC (the graph's layout), int8 on the
    # host: the trainer copies int8 and casts on the card
    data = r.integers(-128, 128, (n, 227, 227, 3), dtype=np.int8)
    labels = r.integers(0, n_classes, (n,)).astype(np.int32)
    train_ds = ArrayDataset({"data": data, "label": labels})
    det = (torch.backends.cudnn.deterministic,
           torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    out: dict = {}
    try:
        with tempfile.TemporaryDirectory(prefix="chip_smoke_graph_") as tmp:
            base = RunConfig(model="graph:alexnet", tau=tau,
                             local_batch=batch, max_rounds=rounds,
                             eval_every=0, precision="float32", seed=0,
                             workdir=tmp, checkpoint_async=False,
                             collect_async=False)

            def run(label, cfg):
                log = _capture_logger()
                t0 = time.perf_counter()
                st = train_graph(cfg, graph, train_ds, logger=log,
                                 device=device)
                if device == "cuda":
                    torch.cuda.synchronize()
                recs = [x for x in log.records if "loss" in x]
                for x in recs:
                    print(f"graph[{label}]: round {x['round']} loss "
                          f"{x['loss']:.6f} grad_norm {x.get('grad_norm')} "
                          f"nonfinite {x.get('nonfinite')} round_s "
                          f"{x['round_s']:.4f} img/s "
                          f"{x['images_per_sec']:.1f} [{card}]", flush=True)
                    if not (math.isfinite(x["loss"])
                            and math.isfinite(x.get("grad_norm", 0.0))) \
                            or x.get("nonfinite"):
                        fail(f"graph[{label}] round {x['round']}: {x}")
                bad = [k for k, v in st["variables"].items()
                       if v.is_floating_point()
                       and not bool(torch.isfinite(v).all())]
                if bad:
                    fail(f"graph[{label}]: nonfinite variables {bad[:4]}")
                print(f"graph[{label}]: {len(recs)} rounds in "
                      f"{time.perf_counter() - t0:.2f}s wall (set-up "
                      f"included) [{card}]", flush=True)
                return st, recs

            # (a) the uninterrupted run; then 2 rounds saved, resumed to 3
            full, recs = run("uninterrupted", base)
            if len(recs) != rounds:
                fail(f"graph: {len(recs)} rounds logged, want {rounds}")
            ck = os.path.join(tmp, "ck")
            run("first 2 rounds", dataclasses.replace(
                base, max_rounds=rounds - 1, checkpoint_dir=ck,
                checkpoint_every=0))
            resumed, _ = run("resumed", dataclasses.replace(
                base, checkpoint_dir=ck, resume=True))
            diff = [f"{kind}/{k}" for kind in ("variables", "slots")
                    for k, v in full[kind].items()
                    if not torch.equal(resumed[kind][k], v)]
            if diff or not resumed["it"] == full["it"] == rounds * tau:
                fail(f"graph: the resumed run differs from the "
                     f"uninterrupted one at {diff[:6]} (it "
                     f"{resumed['it']} vs {full['it']})")
            print(f"graph: a run checkpointed at round {rounds - 1} and "
                  f"resumed to {rounds} is torch.equal to the "
                  f"uninterrupted run ({len(full['variables'])} variables, "
                  f"{len(full['slots'])} slots, it {full['it']}) [{card}]",
                  flush=True)
            warm = [x["round_s"] for x in recs[1:]]
            med = statistics.median(warm)
            out["round_s"] = warm
            print(f"graph: warm rounds {_stats(warm)} s, median "
                  f"{med * 1e3:.2f} ms a round of {tau} steps, "
                  f"{tau * batch / med:.1f} img/s (AlexNet graph 227/"
                  f"{n_classes}, b{batch}, f32, in-graph Momentum) [{card}]",
                  flush=True)

            # one GraphTrainer round is tau GraphNet.steps: a world of one
            # averages to itself
            src = RoundSampler(train_ds, 1, batch, tau, seed=0)
            b0 = prepare_round_batches(src, 0, tau, 0, None, torch.float32)
            group = init_data_group(device, store_path=os.path.join(
                tmp, "store"), rank=0, world_size=1)
            try:
                net = GraphNet(graph, seed=0, device=group.device)
                trainer = GraphTrainer(net, group, tau=tau)
                state, _ = trainer.train_round(trainer.init_state(), b0)
                stepped = GraphNet(graph, seed=0, device=group.device)
                for t in range(tau):
                    stepped.step({k: v[t] for k, v in b0.items()})
                diff = [k for k, v in state["variables"].items()
                        if not torch.equal(stepped.variables[k], v)]
                diff += [f"slot {k}" for k, v in state["slots"].items()
                         if not torch.equal(stepped._slots[k], v)]
                if diff or not stepped._it == state["it"] == tau:
                    fail(f"graph: one GraphTrainer round differs from "
                         f"{tau} GraphNet.steps at {diff[:6]}")
                # set_weights assigns the named variables, slots untouched
                before = {k: v.clone() for k, v in stepped._slots.items()}
                stepped.set_weights(stepped.get_weights())
                moved = [k for k, v in before.items()
                         if not torch.equal(stepped._slots[k], v)]
                if moved:
                    fail(f"graph: set_weights moved the slots {moved[:4]}")
                del net, trainer, state, stepped, before
            finally:
                group.close()
            print(f"graph: one GraphTrainer round torch.equal to {tau} "
                  f"GraphNet.step calls (variables and slots); set_weights "
                  f"leaves every slot torch.equal [{card}]", flush=True)

            # (b) the same graph served from JSON and a weights npz, as
            # `serve.app --graph g.json --weights w.npz` builds it
            gpath = os.path.join(tmp, "alexnet.json")
            wpath = os.path.join(tmp, "alexnet_w.npz")
            _strip_inits(graph).save(gpath)
            names = [k for k, v in full["variables"].items()
                     if v.is_floating_point()]
            WeightCollection({k: [full["variables"][k].cpu().numpy()]
                              for k in names}, names).save(wpath)
            del full, resumed
            print(f"graph: served graph JSON {os.path.getsize(gpath)} B, "
                  f"weights npz {os.path.getsize(wpath)} B", flush=True)
            gnet = serve_app.build_net("lenet", wpath, buckets[-1], None,
                                       None, 0, device, graph=gpath)
            top = buckets[-1]
            payloads = [{"data": (50.0 * r.standard_normal((227, 227, 3))
                                  ).astype(np.float32)}
                        for _ in range(top + 1 + 8)]
            cfg = ServeConfig(model_name="alexnet_graph", max_batch=top,
                              buckets=buckets, outputs=("prob",),
                              max_wait_ms=5.0, metrics_every_batches=0)
            server = InferenceServer(gnet, cfg)
            futs = [server.submit(p) for p in payloads[:top]]
            server.start()  # the queued rows form one top-bucket batch
            try:
                full_out = [f.result(timeout=300)["prob"] for f in futs]
                lone = server.submit(payloads[top]).result(timeout=300)
                burst = [server.submit(p) for p in payloads[top + 1:]]
                rest = [lone["prob"]] + [f.result(timeout=300)["prob"]
                                         for f in burst]
            finally:
                server.stop()
            served = sorted({b for _, b in server.batch_log})
            if server.batch_log[0] != (top, top):
                fail(f"graph: the queued rows formed {server.batch_log[0]}")
            rows = np.stack([p["data"] for p in payloads[:top]])
            direct = gnet.forward({"data": rows, "label": np.zeros(
                (top,), np.int32)}, ["prob"])["prob"]
            got = np.stack(full_out)
            if not torch.equal(torch.from_numpy(got),
                               torch.from_numpy(direct)):
                fail(f"graph: bucket-{top} replies differ from the "
                     f"GraphNet forward of the padded bucket (max "
                     f"{np.abs(got - direct).max():.3e})")
            for i, p in enumerate(full_out + rest):
                if p.shape != (n_classes,) or not np.isfinite(p).all() or \
                        abs(float(p.sum(dtype=np.float64)) - 1.0) > 1e-4:
                    fail(f"graph: reply {i} shape {p.shape} sum {p.sum()}")
            print(f"graph: served {len(full_out) + len(rest)} requests "
                  f"from {gpath.rsplit('/', 1)[-1]} + weights npz in "
                  f"buckets {served}; every bucket-{top} reply torch.equal "
                  f"to GraphNet.forward of the padded bucket; rows sum to "
                  f"1 within 1e-4 [{card}]", flush=True)
            del gnet

        # (c) the raw-pixel door: CaffeNet behind an ImagePreprocessor
        top = buckets[-1]
        net = TorchNet(zoo.caffenet(batch=top, crop=crop,
                                    n_classes=n_classes), seed=0,
                       device=device)
        mean = r.uniform(90.0, 150.0, (3, raw, raw)).astype(np.float32)
        pre = ImagePreprocessor(Schema(Field("data", "float32",
                                             (crop, crop, 3))),
                                mean_image=mean, crop=crop)
        images = [r.integers(0, 256, (3, raw, raw)).astype(np.uint8)
                  for _ in range(top + 9)]
        cfg = ServeConfig(model_name="caffenet_raw", max_batch=top,
                          buckets=buckets, outputs=("prob",),
                          max_wait_ms=5.0, metrics_every_batches=0)
        server = InferenceServer(net, cfg, preprocessor=pre)
        futs = [server.submit({"data": im}) for im in images[:top]]
        lrn_fwd.launches = 0
        server.start()  # the install canary's forward, then the batch
        try:
            t0 = time.perf_counter()
            got = [f.result(timeout=300)["prob"] for f in futs]
            t_top = time.perf_counter() - t0
            lone = server.submit({"data": images[top]}).result(timeout=300)
            burst = [server.submit({"data": im}) for im in images[top + 1:]]
            burst = [f.result(timeout=300)["prob"] for f in burst]
        finally:
            server.stop()
        launches = lrn_fwd.launches
        log_ = list(server.batch_log)
        # traffic forwards and the manager's own (the install canary)
        forwards = len(log_) + server.manager.forwards
        if log_[0] != (top, top):
            fail(f"door: the queued images formed {log_[0]}")
        if device == "cuda" and launches != 2 * forwards:
            fail(f"door: lrn_fwd launched {launches} times over {forwards} "
                 f"forwards (want 2 per forward)")

        def decoded(ims, bucket):
            dec = pre.convert_batch({"data": np.stack(ims)},
                                    train=False)["data"]
            buf = np.zeros((bucket, crop, crop, 3), np.float32)
            buf[:len(ims)] = dec
            return net.forward({"data": buf, "label": np.zeros(
                (bucket, 1), np.int32)}, ["prob"])["prob"][:len(ims)]

        want = decoded(images[:top], top)
        one = decoded(images[top:top + 1], 1)
        if not (torch.equal(torch.from_numpy(np.stack(got)),
                            torch.from_numpy(want))
                and torch.equal(torch.from_numpy(lone["prob"][None]),
                                torch.from_numpy(one))):
            fail("door: a reply differs from the forward of its "
                 "host-decoded bucket")
        for i, p in enumerate(got + [lone["prob"]] + burst):
            if not np.isfinite(p).all() or \
                    abs(float(p.sum(dtype=np.float64)) - 1.0) > 1e-4:
                fail(f"door: reply {i} sums to {p.sum()}")
        print(f"door: CaffeNet {crop}/{n_classes} behind an "
              f"ImagePreprocessor (crop {crop}, mean image, route "
              f"{pre.route(np.stack(images[:1]))}): {len(images)} uint8 "
              f"3x{raw}x{raw} requests in {len(log_)} forwards (buckets "
              f"{sorted({b for _, b in log_})}) and {forwards - len(log_)} "
              f"canary forward(s); the bucket-{top} batch "
              f"(decode included) in {t_top * 1e3:.1f} ms; bucket-{top} "
              f"and bucket-1 replies torch.equal to the forward of the "
              f"host-decoded bucket; lrn_fwd launches {launches} (2 per "
              f"forward) [{card}]", flush=True)
        out.update(launches=launches, forwards=forwards)
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark \
            = det
    print(f"graph: phase 15 took {time.perf_counter() - t_phase:.1f} s "
          f"[{card}]", flush=True)
    return out


#: phase 16's largest |error| over largest |reference| (output, dq, dk, dv)
ATTN_TOL = {"float32": 1e-4, "bfloat16": 3e-2}


def _rel_err(got, want) -> float:
    """max |got - want| over max |want| (0 when both are 0)."""
    scale = float(want.float().abs().max())
    err = float((got.float() - want.float()).abs().max())
    return err / scale if scale else err


def phase_attention(card: str, device: str = "cuda", seq: int = 32768,
                    heads: int = 8, d: int = 128, ranks: int = 4,
                    world1_seq: int = 8192) -> dict:
    """Phase 16 (module docstring): sequence-parallel attention. (a) one
    rank's work of a `ranks`-card ring at B=1, L=`seq`: query shards 0
    and ranks-1 through the ring's order of `block_accumulate` calls over
    L/ranks-token KV blocks and `finalize_accumulator`, under "float32"
    (TF32 off) and "bfloat16", causal and not, against exact `attention`
    over the whole sequence one head at a time (output rows and the
    gradients of sum(o**2) in q_r, k and v); (b) `make_ring_attention` on
    a world of one group, ring and Ulysses, at L=`world1_seq` against exact
    attention. Returns the figures for the attention line. The arguments
    let the phase be rehearsed on the CPU at a small size."""
    import tempfile

    import torch

    from sparknet_tpu_torch import precision
    from sparknet_tpu_torch.ops.attention import (attention,
                                                  block_accumulate,
                                                  finalize_accumulator,
                                                  init_accumulator)
    from sparknet_tpu_torch.parallel.mesh import init_data_group
    from sparknet_tpu_torch.parallel.ring_attention import \
        make_ring_attention

    t_phase = time.perf_counter()
    _zero_counts()  # attention's path runs none of the port's kernels
    dev = torch.device(device)
    cuda = dev.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    gen = torch.Generator(device=dev).manual_seed(16)
    q, k, v = (torch.randn((1, seq, heads, d), generator=gen, device=dev)
               for _ in range(3))
    lq = seq // ranks
    fwd_flops = 4 * heads * lq * seq * d
    cases = []
    for pol in ("float32", "bfloat16"):
        with precision.policy(pol):
            dt = precision.compute_dtype()
            for causal in (False, True):
                for r in (0, ranks - 1):

                    def ring_rank():
                        qr = q[:, r * lq:(r + 1) * lq].to(dt).clone() \
                            .requires_grad_()
                        kk, vv = (x.to(dt).clone().requires_grad_()
                                  for x in (k, v))
                        o, m, l = init_accumulator(qr.shape, dev)
                        for t in range(ranks):
                            src = (r - t) % ranks  # the ring's order
                            blk = slice(src * lq, (src + 1) * lq)
                            o, m, l = block_accumulate(
                                o, m, l, qr, kk[:, blk], vv[:, blk],
                                k_offset=src * lq, q_offset=r * lq,
                                causal=causal)
                        out = finalize_accumulator(o, m, l, qr.dtype)
                        torch.sum(out.float() ** 2).backward()
                        return out.detach(), qr.grad, kk.grad, vv.grad

                    ring_rank()  # warm-up
                    sync()
                    if cuda:
                        torch.cuda.reset_peak_memory_stats(dev)
                    t0 = time.perf_counter()
                    got = ring_rank()
                    sync()
                    ms = (time.perf_counter() - t0) * 1e3
                    peak = torch.cuda.max_memory_allocated(dev) if cuda \
                        else None
                    if not all(bool(torch.isfinite(g).all()) for g in got):
                        fail(f"attention: non-finite output or gradient "
                             f"({pol}, causal {causal}, shard {r})")
                    err = dict.fromkeys(("out", "dq", "dk", "dv"), 0.0)
                    rows = slice(r * lq, (r + 1) * lq)
                    for h in range(heads):
                        xs = [x[:, :, h:h + 1].to(dt).contiguous()
                              .requires_grad_() for x in (q, k, v)]
                        oh = attention(*xs, causal=causal)
                        torch.sum(oh[:, rows].float() ** 2).backward()
                        want = (oh[:, rows].detach(), xs[0].grad[:, rows],
                                xs[1].grad, xs[2].grad)
                        for n, g, w in zip(err, got, want):
                            err[n] = max(err[n], _rel_err(g[:, :, h],
                                                          w[:, :, 0]))
                        del xs, oh, want
                    case = {"policy": pol, "causal": causal, "shard": r,
                            "fwd_bwd_ms": ms, "peak_bytes": peak,
                            "fwd_flops": fwd_flops,
                            **{f"rel_err_{n}": e for n, e in err.items()}}
                    # fwd + bwd: the two forward products and the four
                    # backward ones of every score, 3x the forward
                    tflops = 3 * fwd_flops / (ms * 1e-3) / 1e12
                    print(f"attention: ring shard {r}/{ranks} of L={seq} "
                          f"(B=1, H={heads}, D={d}), {pol}"
                          f"{', causal' if causal else ''}: fwd+bwd "
                          f"{ms:.2f} ms ({tflops:.1f} TFLOP/s at 3 x "
                          f"{fwd_flops / 1e12:.4f} TFLOP), peak "
                          f"{'not measured' if peak is None else f'{peak / 2**30:.2f} GiB'}"
                          f"; max err / max ref: out {err['out']:.2e}, dq "
                          f"{err['dq']:.2e}, dk {err['dk']:.2e}, dv "
                          f"{err['dv']:.2e} (tolerance {ATTN_TOL[pol]}) "
                          f"[{card}]", flush=True)
                    for n, e in err.items():
                        if not e <= ATTN_TOL[pol]:
                            fail(f"attention: ring shard {r} {n} off exact "
                                 f"attention by {e:.3e} of its largest "
                                 f"value ({pol}, causal {causal}; tolerance "
                                 f"{ATTN_TOL[pol]})")
                    cases.append(case)
                    del got
    del q, k, v
    if cuda:
        torch.cuda.empty_cache()

    # (b) the host-level wrapper on a world of one group (NCCL on the card)
    gen = torch.Generator(device=dev).manual_seed(17)
    q, k, v = (torch.randn((1, world1_seq, heads, d), generator=gen,
                           device=dev) for _ in range(3))
    world1 = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_attn_") as tmp:
        group = init_data_group(device, store_path=os.path.join(tmp, "store"),
                                rank=0, world_size=1)
        try:
            with precision.policy("float32"):
                for causal in (False, True):
                    want = attention(q, k, v, causal=causal)
                    for impl in ("ring", "ulysses"):
                        got = make_ring_attention(group, causal=causal,
                                                  impl=impl)(q, k, v)
                        e = _rel_err(got, want)
                        world1[f"{impl}{'_causal' if causal else ''}"] = e
                        if not e <= ATTN_TOL["float32"]:
                            fail(f"attention: {impl} on a world of one off "
                                 f"exact attention by {e:.3e} (causal "
                                 f"{causal})")
        finally:
            group.close()
    print(f"attention: make_ring_attention on a world of one "
          f"({'NCCL' if cuda else 'gloo'}) at L={world1_seq}, float32, "
          f"max err / max ref against exact attention: "
          f"{json.dumps(world1)} [{card}]", flush=True)
    launches = _read_counts()
    if any(launches.values()):
        fail(f"attention: the path launched the port's kernels {launches}")
    secs = time.perf_counter() - t_phase
    print(f"attention: phase 16 took {secs:.1f} s; kernel launches "
          f"{launches} [{card}]", flush=True)
    return {"card": card, "shape": {"B": 1, "L": seq, "H": heads, "D": d,
                                    "ranks": ranks, "block": lq},
            "tolerance": ATTN_TOL, "ring_rank_cases": cases,
            "world_of_one": {"L": world1_seq, "rel_err": world1},
            "kernel_launches": launches, "seconds": secs}


def _equal_state(label: str, workers, state) -> None:
    """A study's one-worker params and momentum against a one-rank
    trainer's state: torch.equal, tensor for tensor."""
    import torch
    if not torch.equal(workers.flat, state.flat_params.detach()):
        d = (workers.flat - state.flat_params.detach()).abs().max().item()
        fail(f"studies[{label}]: the study round's params differ from the "
             f"trainer round's (max |diff| {d:.3e})")
    for l, lp in state.momentum.items():
        for p, m in lp.items():
            if not torch.equal(workers.momentum[0][l][p], m):
                fail(f"studies[{label}]: momentum {l}/{p} differs from the "
                     f"trainer round's")
    if workers.it != state.it:
        fail(f"studies[{label}]: it {workers.it} != the trainer's "
             f"{state.it}")


def phase_studies(card: str, device: str = "cuda", crop: int = 227,
                  size: int = 256, batch: int = 256, n_classes: int = 64,
                  caffe_tau: int = 5, cifar_tau: int = 10,
                  cifar_workers: int = 4, cifar_rounds: int = 5,
                  run_workers: int = 2, run_rounds: int = 3) -> dict:
    """Phase 17 (module docstring): the convergence studies' rounds
    (`sparknet_tpu_torch/scripts/`) at a world of one, cuDNN's
    deterministic algorithms. Returns each part's launch counts and
    steps. The arguments let the phase be rehearsed on the CPU at a
    small size (counts then 0)."""
    import shutil
    import tempfile

    import numpy as np
    import torch

    from sparknet_tpu_torch import precision
    from sparknet_tpu_torch.data import synth
    from sparknet_tpu_torch.parallel.mesh import init_data_group
    from sparknet_tpu_torch.parallel.trainer import ParallelTrainer
    from sparknet_tpu_torch.scripts import parity_caffenet as pc
    from sparknet_tpu_torch.scripts import parity_synth as ps
    from sparknet_tpu_torch.scripts.study import WorkerRounds

    dev = torch.device(device)
    kernels = device == "cuda"
    out: dict = {"launches": {}, "steps": {}, "ms": {}}
    t_phase = time.perf_counter()

    def counted(label, fn, steps, want):
        """Run `fn` between zeroed and read launch counts; check them
        against `want` (per-step counts x steps, plus extras) on the
        card."""
        _zero_counts()
        t0 = time.perf_counter()
        res = fn()
        if kernels:
            torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        counts = _read_counts()
        out["launches"][label], out["steps"][label] = counts, steps
        out["ms"][label] = ms
        print(f"studies[{label}]: {steps} steps in {ms:.1f} ms (host "
              f"clock, synchronized), launches {counts} [{card}]",
              flush=True)
        if kernels and counts != want:
            fail(f"studies[{label}]: launches {counts}, want {want}")
        return res

    def per_step(steps, lrn=0, pool=1, evals=0):
        return {"lrn_fwd": lrn * steps + lrn * evals, "lrn_fwd_scale": 0,
                "lrn_bwd": lrn * steps, "maxpool_bwd": pool * steps}

    det = (torch.backends.cudnn.deterministic,
           torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    prev_policy = "bfloat16" if precision.compute_dtype() == \
        torch.bfloat16 else "float32"
    tmp = tempfile.mkdtemp(prefix="chip_smoke_studies_")
    group = init_data_group(device, store_path=os.path.join(tmp, "store"),
                            rank=0, world_size=1)
    try:
        # (a) cifar10_quick: one worker's round against the trainer's,
        # then the study's own run at W workers
        precision.set_policy("float32")
        net, cfg = ps.build()
        b = ps.BATCH
        x, y = synth.synthetic_cifar(cifar_tau * b, seed=0)
        mean = x.mean(axis=0)
        corpus = torch.from_numpy(np.ascontiguousarray(
            (x - mean).transpose(0, 2, 3, 1)).astype(np.float32)).to(dev)
        labels = torch.from_numpy(y[:, None]).to(dev)
        params = net.init_params(torch.Generator().manual_seed(0), dev)
        idx = torch.arange(cifar_tau * b, device=dev).view(1, cifar_tau, b)
        workers = WorkerRounds(net, cfg, 1, cifar_tau, params)
        loss = counted("cifar10_quick study round W=1",
                       lambda: ps.make_round_fn(workers)(
                           idx, corpus, labels, keys=(0, 0)),
                       cifar_tau, per_step(cifar_tau))
        trainer = ParallelTrainer(net, cfg, group, tau=cifar_tau)
        state = trainer.state_from_params(params)
        state, t_loss = counted(
            "cifar10_quick trainer round",
            lambda: trainer.train_round(
                state, {"data": corpus[idx[0]], "label": labels[idx[0]]},
                (0, 0)), cifar_tau, per_step(cifar_tau))
        if not torch.equal(loss, t_loss):
            fail(f"studies[cifar10_quick]: loss {loss.item()} != the "
                 f"trainer round's {t_loss.item()}")
        _equal_state("cifar10_quick", workers, state)
        del workers, trainer, state, corpus
        steps = cifar_workers * cifar_rounds * cifar_tau
        r = counted(
            f"cifar10_quick study run W={cifar_workers} tau={cifar_tau}",
            lambda: ps.run(cifar_workers, cifar_rounds * cifar_tau, seed=0,
                           device=device, n_train=2 * cifar_workers
                           * cifar_tau * b, n_test=10 * b,
                           tau=cifar_tau), steps, per_step(steps))
        losses = r["round_losses"]
        print(f"studies[cifar10_quick run]: round losses {losses}, "
              f"accuracy {[c['test_accuracy'] for c in r['curve']]} "
              f"[{card}]", flush=True)
        if len(losses) != cifar_rounds or not all(
                math.isfinite(v) for v in losses):
            fail(f"studies[cifar10_quick run]: round losses {losses}")
        if not losses[-1] < losses[0]:
            fail(f"studies[cifar10_quick run]: losses not falling "
                 f"{losses}")

        # (b) full-width CaffeNet, bfloat16: one worker's round (dropout
        # on) against the trainer's on the same prepared batches and key
        precision.set_policy("bfloat16")
        cdt = precision.compute_dtype()
        net = pc.build_net(batch=batch, crop=crop, n_classes=n_classes)
        cfg = pc.solver_config()
        rng = np.random.default_rng(17)
        n = caffe_tau * batch
        host = rng.integers(0, 256, (n, size, size, 3), dtype=np.uint8)
        host_mean = rng.uniform(100, 156, (size, size, 3)).astype(
            np.float32)
        corpus = torch.from_numpy(host).to(dev)
        mean_d = torch.from_numpy(host_mean).to(dev)
        labels = torch.from_numpy(
            rng.integers(0, n_classes, n).astype(np.int32)).to(dev)
        idx = torch.from_numpy(rng.permutation(n).reshape(
            1, caffe_tau, batch)).to(dev)
        offs = torch.from_numpy(rng.integers(
            0, size - crop + 1, (1, caffe_tau, batch, 2)).astype(
                np.int32)).to(dev)
        params = net.init_params(torch.Generator().manual_seed(0), dev)
        keys = (1000, 0)
        workers = WorkerRounds(net, cfg, 1, caffe_tau, params)
        per_caffe = lambda steps, evals=0: per_step(steps, 2, 3, evals)
        loss = counted(
            f"caffenet {crop}/{n_classes} b{batch} bf16 study round W=1",
            lambda: pc.make_round_fn(workers, crop=crop)(
                idx, offs, keys, corpus, labels, mean_d),
            caffe_tau, per_caffe(caffe_tau))
        data = torch.stack([pc.prep(corpus, mean_d, idx[0, t], offs[0, t],
                                    crop, cdt) for t in range(caffe_tau)])
        trainer = ParallelTrainer(net, cfg, group, tau=caffe_tau)
        state = trainer.state_from_params(params)
        state, t_loss = counted(
            f"caffenet {crop}/{n_classes} b{batch} bf16 trainer round",
            lambda: trainer.train_round(
                state, {"data": data, "label": labels[idx[0]][..., None]},
                keys), caffe_tau, per_caffe(caffe_tau))
        if not torch.equal(loss, t_loss):
            fail(f"studies[caffenet]: loss {loss.item()} != the trainer "
                 f"round's {t_loss.item()}")
        _equal_state("caffenet", workers, state)
        got = data[0].cpu()
        i0, o0 = idx[0, 0].cpu().numpy(), offs[0, 0].cpu().numpy()
        want = torch.stack([torch.from_numpy(np.ascontiguousarray(
            (host[i].astype(np.float32) - host_mean)[oy:oy + crop,
                                                      ox:ox + crop]))
            for i, (oy, ox) in zip(i0, o0)]).to(cdt)
        if not torch.equal(got, want):
            fail("studies[caffenet]: the card-side prep differs from the "
                 "host's mean subtraction and crop")
        print(f"studies[caffenet]: loss {loss.item():.6f}; the study round "
              f"torch.equal to the trainer round (loss, params, momentum); "
              f"prep of step 0 ({batch} images) torch.equal to the host's "
              f"[{card}]", flush=True)
        del workers, trainer, state, data, corpus

        # (c) the study's own run on a small in-memory corpus
        n = run_workers * caffe_tau * batch
        host = rng.integers(0, 256, (n + batch, size, size, 3),
                            dtype=np.uint8)
        lab = rng.integers(0, n_classes, n + batch).astype(np.int32)
        put = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
        run_data = (put(host[:n]), put(lab[:n]), mean_d, put(host[n:]),
                    put(lab[n:]), n)
        del host
        steps = run_workers * run_rounds * caffe_tau
        r = counted(
            f"caffenet study run W={run_workers} tau={caffe_tau}",
            lambda: pc.run(run_workers, run_rounds * caffe_tau, run_data,
                           seed=0, tau=caffe_tau, batch=batch, crop=crop,
                           size=size,
                           n_classes=n_classes),
            steps, per_caffe(steps, evals=2))
        losses = r["round_losses"]
        print(f"studies[caffenet run]: round losses {losses}, val "
              f"accuracy {[c['val_accuracy'] for c in r['curve']]} "
              f"[{card}]", flush=True)
        if len(losses) != run_rounds or not all(
                math.isfinite(v) for v in losses):
            fail(f"studies[caffenet run]: round losses {losses}")
        del run_data
    finally:
        group.close()
        shutil.rmtree(tmp, ignore_errors=True)
        precision.set_policy(prev_policy)
        (torch.backends.cudnn.deterministic,
         torch.backends.cudnn.benchmark) = det
        if kernels:
            torch.cuda.empty_cache()
    secs = time.perf_counter() - t_phase
    print(f"studies: phase 17 took {secs:.1f} s; launches by part "
          f"{json.dumps(out['launches'])} [{card}]", flush=True)
    out["seconds"] = secs
    return out


def _sum_rows(cases: dict, keys) -> dict:
    """The per-step sum of timed rows (`TIME_KEYS`, bound_ms) over
    `keys`."""
    out = {}
    for f in TIME_KEYS + ("bound_ms",):
        out[f] = 0.0
        for key in keys:
            out[f] = _add(out[f], cases[key][f])
    out["bound_by"] = ("bytes" if all(cases[key]["bound_by"] == "bytes"
                                      for key in keys) else "operations")
    return out


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke needs a CUDA "
             "card")
    root = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(root, "sparknet_tpu_torch")):
        fail(f"no sparknet_tpu_torch package beside {__file__}")
    sys.path.insert(0, root)
    from sparknet_tpu_torch.ops import _build

    card = card_line()
    print(card, flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device {torch.cuda.get_device_name(0)}, "
          f"count {torch.cuda.device_count()}", flush=True)
    t0 = time.perf_counter()
    libs = _build.build_all(["lrn_fwd", "lrn_bwd", "maxpool_bwd"])
    print(f"build: {sorted(libs)} in {time.perf_counter() - t0:.1f}s",
          flush=True)
    for name, path in libs.items():
        log = path.with_suffix(".log")
        if log.exists():
            # per kernel instantiation: its registers, spills, stack
            for line in log.read_text().splitlines():
                if "Used" in line or "spill" in line:
                    print(f"build: {name}: {line.split(':', 1)[-1].strip()}",
                          flush=True)

    agg = phase_kernels(card)
    lrn_train = phase_lrn_train_kernels(card)
    pool = phase_pool_kernels(card)
    serve = phase_serve(card)
    train = phase_train(card)
    ckp = phase_checkpoint(card)
    import shutil
    import tempfile
    corpus = tempfile.mkdtemp(prefix="chip_smoke_corpus_")
    try:
        write_corpus(corpus)
        inet = phase_imagenet(card, corpus)
        stream = phase_stream(card, corpus, inet["mean"])
    finally:
        shutil.rmtree(corpus, ignore_errors=True)
    elastic = phase_elastic(card, train["warm_round_s"])
    http = phase_serve_http(card, serve["steady_img_s"])
    sharded = phase_sharded(card)
    routed = phase_router(card, serve["steady_img_s"], http["http_img_s"])
    fleet = phase_fleet(card)
    batch = phase_batch(card)
    trainers = phase_trainers(card, train["warm_round_s"])
    graph = phase_graph(card)
    attn = phase_attention(card)
    studies = phase_studies(card)

    # the main training path's shapes: batch 256, bfloat16
    lc, pc = lrn_train["cases"], pool["cases"]
    fwd = _sum_rows(lc, [("fwd_y", l, 256, "bfloat16") for l in LRN_SHAPES])
    bwd = _sum_rows(lc, [("bwd_recompute", l, 256, "bfloat16")
                         for l in LRN_SHAPES])
    saved = {k: _sum_rows(lc, [(k, l, 100, "float32") for l in LRN_SHAPES])
             for k in ("fwd_scale", "bwd_saved")}
    mp = {kind: _sum_rows(pc, [(n, "bfloat16", kind) for n in TRAIN_POOLS])
          for kind in ("ties", "dense")}
    common = {"route": "cuda", "passed": True, "card": card,
              "timing": "ms, plain_ms, library_ms: CUDA events over "
                        "host-paced calls, launch overhead included; "
                        "device_ms: the kernel's calls queued behind a sleep "
                        "kernel, back to back on the card (null: not "
                        "measured); host_ms: the host's time to queue one "
                        "call there (the wrapper and the launch)"}
    print(json.dumps({"attention": attn}), flush=True)
    print(json.dumps({"kernels": [
        {"name": "lrn_fwd",
         "source": "sparknet_tpu_torch/csrc/lrn_fwd.cu",
         "replaces": "sparknet_tpu/ops/pallas_lrn.py:51",
         "also_replaces": "sparknet_tpu/ops/pallas_lrn.py:206",
         "launches": train["launches"]["lrn_fwd"],
         "checkpoint_phase_launches": {
             k: c["lrn_fwd"] for k, c in ckp["launches"].items()},
         "imagenet_phase_launches": {
             k: c["lrn_fwd"] for k, c in inet["launches"].items()},
         "stream_phase_launches": {
             k: c["lrn_fwd"] for k, c in stream["launches"].items()},
         "elastic_phase_launches": {
             k: c["lrn_fwd"] for k, c in elastic["launches"].items()},
         "sharded_phase_launches": {
             k: c["lrn_fwd"] for k, c in sharded["launches"].items()},
         "trainers_phase_launches": {
             k: c["lrn_fwd"] for k, c in trainers["launches"].items()},
         "studies_phase_launches": {
             k: c["lrn_fwd"] for k, c in studies["launches"].items()},
         "max_abs_err": max(agg["max_abs_err"], lrn_train["max_abs_err"]),
         **fwd, "timed_at": "norm1 + norm2, batch 256, bfloat16, y only "
                            "(the training step's forward)",
         "serve_launches": serve["launches"],
         "serve_http_phase_launches": http["launches"],
         "serve_http_phase_forwards": http["forwards"],
         "router_phase_launches": routed["launches"],
         "router_phase_forwards": routed["forwards"],
         "fleet_phase_launches": fleet["launches"],
         "fleet_phase_forwards": fleet["forwards"],
         "batch_phase_launches": batch["launches"],
         "batch_phase_forwards": batch["forwards"],
         "graph_phase_launches": graph["launches"],
         "graph_phase_forwards": graph["forwards"],
         "serve": {k: v for k, v in agg.items() if k.endswith("_ms")
                   or k == "ms"},
         "serve_timed_at": "norm1 + norm2, bucket 128, float32",
         "saved_scale_route_launches": train["saved_launches"][
             "lrn_fwd_scale"],
         "with_scale": saved["fwd_scale"],
         "with_scale_timed_at": "norm1 + norm2, batch 100, float32",
         **common},
        {"name": "lrn_bwd",
         "source": "sparknet_tpu_torch/csrc/lrn_bwd.cu",
         "replaces": "sparknet_tpu/ops/pallas_lrn.py:216",
         "also_replaces": "sparknet_tpu/ops/pallas_lrn.py:62",
         "launches": train["launches"]["lrn_bwd"],
         "checkpoint_phase_launches": {
             k: c["lrn_bwd"] for k, c in ckp["launches"].items()},
         "imagenet_phase_launches": {
             k: c["lrn_bwd"] for k, c in inet["launches"].items()},
         "stream_phase_launches": {
             k: c["lrn_bwd"] for k, c in stream["launches"].items()},
         "elastic_phase_launches": {
             k: c["lrn_bwd"] for k, c in elastic["launches"].items()},
         "sharded_phase_launches": {
             k: c["lrn_bwd"] for k, c in sharded["launches"].items()},
         "trainers_phase_launches": {
             k: c["lrn_bwd"] for k, c in trainers["launches"].items()},
         "studies_phase_launches": {
             k: c["lrn_bwd"] for k, c in studies["launches"].items()},
         "max_abs_err": lrn_train["max_abs_err"], **bwd,
         "timed_at": "norm1 + norm2, batch 256, bfloat16, recompute mode",
         "saved_scale_route_launches": train["saved_launches"]["lrn_bwd"],
         "saved_mode": saved["bwd_saved"],
         "saved_mode_timed_at": "norm1 + norm2, batch 100, float32",
         **common},
        {"name": "maxpool_bwd",
         "source": "sparknet_tpu_torch/csrc/maxpool_bwd.cu",
         "replaces": "sparknet_tpu/ops/pallas_pool.py:61",
         "launches": train["launches"]["maxpool_bwd"],
         "checkpoint_phase_launches": {
             k: c["maxpool_bwd"] for k, c in ckp["launches"].items()},
         "imagenet_phase_launches": {
             k: c["maxpool_bwd"] for k, c in inet["launches"].items()},
         "stream_phase_launches": {
             k: c["maxpool_bwd"] for k, c in stream["launches"].items()},
         "elastic_phase_launches": {
             k: c["maxpool_bwd"] for k, c in elastic["launches"].items()},
         "sharded_phase_launches": {
             k: c["maxpool_bwd"] for k, c in sharded["launches"].items()},
         "trainers_phase_launches": {
             k: c["maxpool_bwd"] for k, c in trainers["launches"].items()},
         "studies_phase_launches": {
             k: c["maxpool_bwd"] for k, c in studies["launches"].items()},
         "max_abs_err": pool["max_abs_err"], **mp["ties"],
         "timed_at": "pool1 + pool2 + pool5, batch 256, bfloat16, "
                     "tie-heavy input",
         "dense": mp["dense"],
         "dense_timed_at": "the same, ReLU-of-Gaussian input",
         **common}],
        "train_steps": train["steps"],
        "checkpoint_phase_steps": ckp["steps"],
        "imagenet_phase_steps": inet["steps"],
        "stream_phase_steps": stream["steps"],
        "elastic_phase_steps": elastic["steps"],
        "sharded_phase_steps": sharded["steps"],
        "trainers_phase_steps": trainers["steps"],
        "studies_phase_steps": studies["steps"]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
