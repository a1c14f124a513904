"""Replica providers: where new serve capacity comes from.

A copy of `sparknet_tpu/fleet/provider.py` for the port, with two known
differences (ROADMAP C):

  - `SubprocessReplicaProvider` spawns the port's serve CLI
    (`python -m sparknet_tpu_torch.serve.app`); its children run on the
    CUDA card unless `extra_args` carries `--device cpu`. With
    `compile_cache_dir` they share the port's warm-up cache (the kernel
    build directory, `--compile-cache DIR`), as the JAX provider's
    children share the persistent XLA compile cache.
  - `PodReplicaProvider` assembles the same `scripts/tpu_pod_launch.sh`
    command sequence as the JAX stub, except that the serve command it
    runs is the port's module. The JAX package has no GPU provisioning
    protocol, and the port does not invent one.

The FleetController decides *when* the fleet grows or shrinks; a
`ReplicaProvider` knows *how* — it turns "grow model m" into a running
serve replica reachable over a URL, and "retire" into a clean teardown:

  - `SubprocessReplicaProvider`: spawns serve child processes on THIS
    host, each with its own binary frame port (spkn://) and heartbeat
    file.
  - `PodReplicaProvider`: a stub riding the `tpu_pod_launch.sh`
    protocol — grow assembles the launcher's create/setup/run command
    sequence for a fresh single-host VM serving the model, retire
    assembles the delete. The command runner is injectable (tests
    record; real deployments pass subprocess).

A `ReplicaHandle` is the provider's receipt: the URL the router should
route to, the heartbeat path health probes should watch, and whatever
the provider needs to retire it later.
"""
from __future__ import annotations

import os
import socket
import subprocess
import sys
import tempfile
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence


@dataclass
class ReplicaHandle:
    """One grown replica: routing address + health + teardown state."""

    model: str
    url: str                            # spkn://host:port or http://...
    heartbeat_path: Optional[str] = None
    meta: Dict[str, Any] = field(default_factory=dict)


class ReplicaProvider:
    """The grow/retire/alive interface the controller drives."""

    def grow(self, model: str) -> ReplicaHandle:
        raise NotImplementedError

    def retire(self, handle: ReplicaHandle) -> None:
        raise NotImplementedError

    def alive(self, handle: ReplicaHandle) -> bool:
        """Is the replica's PROCESS still there? (Routability is the
        router's heartbeat-health call; this is the cheaper, blunter
        probe a kill -9 flips instantly.)"""
        return True

    def stop(self) -> None:
        """Tear down everything this provider still owns."""


def _free_port() -> int:
    """An OS-assigned free TCP port (bind-0, read, close). Racy in
    principle; in practice the child binds it immediately and a grow
    that loses the race fails loudly inside spawn_timeout_s."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


#: the serve CLI a grown replica runs
SERVE_MODULE = "sparknet_tpu_torch.serve.app"


class SubprocessReplicaProvider(ReplicaProvider):
    """Real serve children (`python -m sparknet_tpu_torch.serve.app`)
    over spkn:// on this host.

    `sources[model]` is the model source the child builds (zoo name or
    .prototxt path — exactly the serve CLI's `--model` argument).
    Children write fast heartbeats (`heartbeat_every_s`) so the
    router's staleness rule sees a kill -9 promptly, and serve prob-only
    outputs at `max_batch` unless overridden via `extra_args`.

    Continuous learning: with `checkpoint_dir` set (a path/URL, `{model}`
    substituted), children watch the training store and hot-swap; each
    gets its provider tag as `--replica-name` — the identity the rollout
    gate (`rollout_gate`, when set) approves steps under — plus the
    fleet-shared `poll_interval_s`/`poll_jitter` cadence.

    `compile_cache_dir`: the warm-up cache every child builds its kernels
    into and loads them from (`--compile-cache`), so a replica grown after
    the first runs no nvcc."""

    def __init__(self, sources: Dict[str, str],
                 workdir: Optional[str] = None,
                 max_batch: int = 8,
                 outputs: Sequence[str] = ("prob",),
                 compile_cache_dir: Optional[str] = None,
                 heartbeat_every_s: float = 0.5,
                 spawn_timeout_s: float = 120.0,
                 extra_args: Sequence[str] = (),
                 python: str = sys.executable,
                 checkpoint_dir: Optional[str] = None,
                 poll_interval_s: Optional[float] = None,
                 poll_jitter: Optional[float] = None,
                 rollout_gate: Optional[str] = None):
        self.sources = dict(sources)
        self.workdir = workdir or tempfile.mkdtemp(
            prefix="sparknet-fleet-")
        os.makedirs(self.workdir, exist_ok=True)
        self.max_batch = int(max_batch)
        self.outputs = tuple(outputs or ())
        self.compile_cache_dir = compile_cache_dir
        self.heartbeat_every_s = float(heartbeat_every_s)
        self.spawn_timeout_s = float(spawn_timeout_s)
        self.extra_args = tuple(extra_args)
        self.python = python
        self.checkpoint_dir = checkpoint_dir
        self.poll_interval_s = poll_interval_s
        self.poll_jitter = poll_jitter
        self.rollout_gate = rollout_gate
        self._n = 0
        self._procs: List[subprocess.Popen] = []

    def grow(self, model: str) -> ReplicaHandle:
        src = self.sources.get(model)
        if src is None:
            raise KeyError(f"no model source registered for {model!r} "
                           f"(have {sorted(self.sources)})")
        self._n += 1
        tag = f"{model.replace('/', '_')}-{self._n}"
        port = _free_port()
        hb = os.path.join(self.workdir, f"replica-{tag}.heartbeat.json")
        log_path = os.path.join(self.workdir, f"replica-{tag}.log")
        cmd = [self.python, "-m", SERVE_MODULE,
               "--model", src, "--model-name", model,
               "--binary-port", str(port),
               "--max-batch", str(self.max_batch),
               "--heartbeat", hb,
               "--heartbeat-every", str(self.heartbeat_every_s)]
        if self.outputs:
            cmd += ["--outputs", ",".join(self.outputs)]
        if self.compile_cache_dir:
            cmd += ["--compile-cache", self.compile_cache_dir]
        if self.checkpoint_dir:
            cmd += ["--checkpoint-dir",
                    self.checkpoint_dir.replace("{model}", model),
                    "--replica-name", tag]
            if self.poll_interval_s is not None:
                cmd += ["--poll-interval", str(self.poll_interval_s)]
            if self.poll_jitter is not None:
                cmd += ["--poll-jitter", str(self.poll_jitter)]
            if self.rollout_gate:
                cmd += ["--rollout-gate",
                        self.rollout_gate.replace("{model}", model)]
        cmd += list(self.extra_args)
        # the child must resolve the package however THIS process did
        # (editable install, or a bare checkout run from the repo root)
        env = dict(os.environ)
        pkg_root = os.path.dirname(os.path.dirname(
            os.path.dirname(os.path.abspath(__file__))))
        env["PYTHONPATH"] = pkg_root + os.pathsep + \
            env.get("PYTHONPATH", "")
        log_f = open(log_path, "ab")
        try:
            proc = subprocess.Popen(cmd, stdout=log_f, stderr=log_f,
                                    cwd=self.workdir, env=env)
        finally:
            log_f.close()  # the child holds its own fd now
        # shm_eligible: the child is a colocated loopback process — the
        # binary client's spkn-shm handshake will succeed against it
        # (the nonce proof still decides at connect time; this flag is
        # advisory, for status/placement readers)
        handle = ReplicaHandle(model, f"spkn://127.0.0.1:{port}",
                               heartbeat_path=hb,
                               meta={"proc": proc, "port": port,
                                     "log": log_path, "tag": tag,
                                     "shm_eligible": True})
        self._procs.append(proc)
        deadline = time.monotonic() + self.spawn_timeout_s
        while time.monotonic() < deadline:
            if proc.poll() is not None:
                break  # died during bring-up: fail with the log tail
            try:
                socket.create_connection(("127.0.0.1", port),
                                         timeout=1.0).close()
                return handle
            except OSError:
                time.sleep(0.1)
        self.retire(handle)
        tail = ""
        try:
            with open(log_path, "rb") as f:
                tail = f.read()[-2000:].decode("utf-8", "replace")
        except OSError:
            pass
        raise RuntimeError(
            f"replica {tag} did not come up on port {port} within "
            f"{self.spawn_timeout_s:.0f}s (exit={proc.poll()}); "
            f"log tail:\n{tail}")

    def retire(self, handle: ReplicaHandle) -> None:
        proc = handle.meta.get("proc")
        if proc is None or proc.poll() is not None:
            return
        proc.terminate()
        try:
            proc.wait(timeout=5.0)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(timeout=5.0)

    def alive(self, handle: ReplicaHandle) -> bool:
        proc = handle.meta.get("proc")
        return proc is not None and proc.poll() is None

    def stop(self) -> None:
        for proc in self._procs:
            if proc.poll() is None:
                proc.terminate()
        deadline = time.monotonic() + 5.0
        for proc in self._procs:
            if proc.poll() is None:
                try:
                    proc.wait(timeout=max(0.1,
                                          deadline - time.monotonic()))
                except subprocess.TimeoutExpired:
                    proc.kill()
        self._procs = []


class PodReplicaProvider(ReplicaProvider):
    """The `tpu_pod_launch.sh` protocol stub: one fresh single-host VM
    per grow, serving the model over the binary plane on `port` with the
    port's serve module (the JAX stub's command sequence otherwise).

    `runner(argv)` executes one launcher invocation (tests inject a
    recorder; production passes e.g.
    `lambda argv: subprocess.run(argv, check=True)`). The VM's DNS name
    doubles as the spkn:// host — the launcher's network setup resolves
    it inside the pod's VPC. `alive` defers to the launcher's own
    `watch` supervision (this provider cannot cheaply probe a remote
    VM's process table)."""

    def __init__(self, sources: Dict[str, str], zone: str,
                 accel_type: str, name_prefix: str = "sparknet-fleet",
                 port: int = 8470,
                 launcher: str = "scripts/tpu_pod_launch.sh",
                 runner: Optional[Callable[[List[str]], Any]] = None):
        self.sources = dict(sources)
        self.zone = zone
        self.accel_type = accel_type
        self.name_prefix = name_prefix
        self.port = int(port)
        self.launcher = launcher
        self.runner = runner or (lambda argv: subprocess.run(
            argv, check=True))
        self._n = 0
        self._live: List[str] = []

    def grow(self, model: str) -> ReplicaHandle:
        src = self.sources.get(model)
        if src is None:
            raise KeyError(f"no model source registered for {model!r}")
        self._n += 1
        name = f"{self.name_prefix}-{model.replace('/', '-')}-{self._n}"
        serve_cmd = (f"python -m {SERVE_MODULE} --model {src} "
                     f"--model-name {model} "
                     f"--binary-port {self.port} "
                     f"--binary-host 0.0.0.0 --outputs prob")
        commands = [
            [self.launcher, "create", name, self.zone, self.accel_type],
            [self.launcher, "setup", name, self.zone],
            [self.launcher, "run", name, self.zone, serve_cmd],
        ]
        for argv in commands:
            self.runner(argv)
        self._live.append(name)
        return ReplicaHandle(model, f"spkn://{name}:{self.port}",
                             meta={"name": name, "commands": commands})

    def retire(self, handle: ReplicaHandle) -> None:
        name = handle.meta.get("name")
        if name is None:
            return
        self.runner([self.launcher, "delete", name, self.zone])
        if name in self._live:
            self._live.remove(name)

    def stop(self) -> None:
        for name in list(self._live):
            self.runner([self.launcher, "delete", name, self.zone])
        self._live = []
