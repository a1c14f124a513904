"""The port's warm-up cache and compile-event record against the JAX
package's (`utils/compile_cache.py`, the compile half of `obs/device.py`,
the spec memo of `CompiledNet.compile`, the serve bucket's compile event).

The build box has no nvcc, so the cold/warm verdicts run `ops/_build.py`
against a stub `$CUDA_HOME/bin/nvcc` that answers `--version` and writes
its `-o` file: a cold region runs it once (`builds == 1`, a miss), a second
region on the same directory finds the library on disk (a hit), and so
does another process pointed at the directory by `SPARKNET_COMPILE_CACHE`.
The same `note_compile` sequence fed to both packages' `obs/device.py`
gives equal `compile_stats()` and equal Prometheus text, the late
registry's replay included. The port's server and the JAX server record
one "serve_bucket" event per bucket; the labels differ (ROADMAP C: on the
CPU the port builds nothing, a hit; the JAX server's first forward of a
bucket is a cold XLA compile, a miss).
"""
import json
import os
import stat
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import sparknet_tpu.obs.device as jax_device
from sparknet_tpu import zoo as jax_zoo
from sparknet_tpu.model.net import CompiledNet as JaxCompiledNet
from sparknet_tpu.net_api import JaxNet
from sparknet_tpu.obs.registry import MetricsRegistry as JaxRegistry
from sparknet_tpu.serve.server import InferenceServer as JaxServer
from sparknet_tpu.serve.server import ServeConfig as JaxServeConfig

import sparknet_tpu_torch.obs.device as port_device
from sparknet_tpu_torch import zoo
from sparknet_tpu_torch.model.net import CompiledNet
from sparknet_tpu_torch.net_api import TorchNet
from sparknet_tpu_torch.obs.registry import MetricsRegistry
from sparknet_tpu_torch.ops import _build
from sparknet_tpu_torch.serve.server import InferenceServer, ServeConfig
from sparknet_tpu_torch.utils import compile_cache
from sparknet_tpu_torch.utils.compile_cache import track_compiles

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent

STUB_NVCC = """#!/bin/sh
# a stand-in for nvcc: --version names a toolkit, a build writes its -o file
if [ "$1" = "--version" ]; then echo "stub nvcc, release {release}"; exit 0; fi
while [ $# -gt 0 ]; do
  if [ "$1" = "-o" ]; then shift; echo built > "$1"; fi
  shift
done
echo "ptxas info    : Used 1 registers"
"""


def _stub_cuda_home(root: Path, release: str) -> Path:
    nvcc = root / "bin" / "nvcc"
    nvcc.parent.mkdir(parents=True)
    nvcc.write_text(STUB_NVCC.format(release=release))
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)
    return root


@pytest.fixture()
def fresh_cache(monkeypatch):
    """A process whose warm-up cache is not initialized yet, restored to
    the default `_build/` after the test."""
    compile_cache.reset_for_tests()
    monkeypatch.delenv("SPARKNET_COMPILE_CACHE", raising=False)
    monkeypatch.setattr(_build, "_toolkit", None)
    yield
    compile_cache.reset_for_tests()


def test_a_cold_region_builds_and_a_warm_one_hits(tmp_path, monkeypatch,
                                                  fresh_cache):
    monkeypatch.setenv("CUDA_HOME", str(_stub_cuda_home(tmp_path / "cuda",
                                                        "1.0")))
    cache = tmp_path / "cache"
    assert compile_cache.init_compile_cache(str(cache)) == str(cache)
    with track_compiles() as cold:
        built = _build.build_all(["lrn_fwd"])
    assert (cold.builds, cold.cache_hits, cold.cache_misses) == (1, 0, 1)
    assert cold.cache_hit is False
    lib = built["lrn_fwd"]
    assert lib.parent == cache and lib.read_text() == "built\n"
    assert lib.with_suffix(".log").read_text().startswith("ptxas info")
    with track_compiles() as warm:
        assert _build.build_all(["lrn_fwd"]) == built
    assert (warm.builds, warm.cache_hits, warm.cache_misses) == (0, 1, 0)
    assert warm.cache_hit is True
    # another process pointed at the directory by the environment: a hit
    env = dict(os.environ, SPARKNET_COMPILE_CACHE=str(cache),
               PYTHONPATH=str(REPO) + os.pathsep +
               os.environ.get("PYTHONPATH", ""))
    code = ("import json\n"
            "from sparknet_tpu_torch.ops import _build\n"
            "from sparknet_tpu_torch.utils import compile_cache as cc\n"
            "d = cc.init_compile_cache()\n"
            "with cc.track_compiles() as t:\n"
            "    p = _build.build_all(['lrn_fwd'])['lrn_fwd']\n"
            "print(json.dumps([d, str(p), t.builds, t.cache_hits,"
            " t.cache_hit]))\n")
    r = subprocess.run([sys.executable, "-c", code], env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert json.loads(r.stdout.strip().splitlines()[-1]) == \
        [str(cache), str(lib), 0, 1, True]
    # another toolkit never loads this one's library
    monkeypatch.setenv("CUDA_HOME", str(_stub_cuda_home(tmp_path / "cuda2",
                                                        "2.0")))
    monkeypatch.setattr(_build, "_toolkit", None)
    assert _build.library_path("lrn_fwd") != lib
    with track_compiles() as other:
        _build.build_all(["lrn_fwd"])
    assert other.builds == 1 and other.cache_hit is False


def test_a_failed_build_raises_with_nvcc_s_output(tmp_path, monkeypatch,
                                                  fresh_cache):
    home = tmp_path / "cuda"
    (home / "bin").mkdir(parents=True)
    nvcc = home / "bin" / "nvcc"
    nvcc.write_text('#!/bin/sh\n[ "$1" = "--version" ] && exit 0\n'
                    'echo "error: no such intrinsic"; exit 2\n')
    nvcc.chmod(0o755)
    monkeypatch.setenv("CUDA_HOME", str(home))
    compile_cache.init_compile_cache(str(tmp_path / "cache"))
    with track_compiles() as t:
        with pytest.raises(RuntimeError, match="no such intrinsic"):
            _build.build_all(["lrn_fwd"])
    assert t.builds == 1 and t.cache_hit is False
    assert not list((tmp_path / "cache").glob("*.so*"))


def test_the_first_caller_wins_and_reset_for_tests(tmp_path, monkeypatch,
                                                   fresh_cache):
    assert compile_cache.init_compile_cache() is None
    assert not compile_cache.is_initialized()
    assert _build.BUILD_DIR == _build.DEFAULT_BUILD_DIR
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    assert compile_cache.init_compile_cache(a) == a
    assert compile_cache.init_compile_cache(b) == a
    assert compile_cache.init_compile_cache() == a
    assert compile_cache.cache_dir() == a and os.path.isdir(a)
    assert not os.path.exists(b) and _build.BUILD_DIR == Path(a)
    compile_cache.reset_for_tests()
    assert compile_cache.cache_dir() is None
    assert _build.BUILD_DIR == _build.DEFAULT_BUILD_DIR
    monkeypatch.setenv("SPARKNET_COMPILE_CACHE", b)
    assert compile_cache.init_compile_cache() == b
    compile_cache.reset_for_tests()
    (tmp_path / "file").write_text("")
    with pytest.raises(OSError):
        compile_cache.init_compile_cache(str(tmp_path / "file" / "sub"))
    assert not compile_cache.is_initialized()


def test_a_region_without_builds_is_a_hit():
    with track_compiles() as t:
        pass
    assert (t.builds, t.cache_hits, t.cache_misses, t.cache_hit) == \
        (0, 0, 0, True)


# -- the compile-event record -------------------------------------------------

#: (what, seconds, cache_hit) for both packages' note_compile
EVENTS = [("net", 0.004, None), ("net", 0.0, True),
          ("serve_bucket", 0.31, False), ("serve_bucket", 0.02, True),
          ("serve_bucket", 7.5, False), ("custom", 0.2, None)]


@pytest.fixture()
def isolated_records(monkeypatch):
    """Both packages' process-wide records, emptied for the test."""
    for mod in (jax_device, port_device):
        monkeypatch.setattr(mod, "_events", [])
        monkeypatch.setattr(mod, "_attached", [])


def _compile_families(text):
    keep = ("sparknet_compile_events_total", "sparknet_compile_seconds")
    return [l for l in text.splitlines()
            if any(k in l for k in keep)]


def test_the_record_and_its_exposition_are_the_jax_package_s(
        isolated_records):
    regs = {"jax": (JaxRegistry(), JaxRegistry()),
            "port": (MetricsRegistry(), MetricsRegistry())}
    mods = {"jax": jax_device, "port": port_device}
    for k, mod in mods.items():
        mod.attach_compile_metrics(regs[k][0])   # attached before
        for e in EVENTS[:3]:
            mod.note_compile(*e)
        mod.attach_compile_metrics(regs[k][1])   # late: replayed
        for e in EVENTS[3:]:
            mod.note_compile(*e)
    assert port_device.compile_stats() == jax_device.compile_stats()
    stats = port_device.compile_stats()
    assert stats["serve_bucket"] == {"events": 3, "seconds": 7.83,
                                     "cache_hits": 1, "cache_misses": 2}
    for i in (0, 1):
        texts = {k: regs[k][i].render_prometheus() for k in regs}
        assert _compile_families(texts["port"]) == \
            _compile_families(texts["jax"])
        assert _compile_families(texts["port"])
        snap = regs["port"][i].snapshot()
        # the seconds histogram counts the non-hit events only
        assert snap["sparknet_compile_seconds"]["values"][
            ("serve_bucket",)]["count"] == 2
        assert snap["sparknet_compile_events_total"]["values"][
            ("serve_bucket", "true")] == 1


def test_timed_compile_stamps_the_region_s_verdict(tmp_path, monkeypatch,
                                                   isolated_records,
                                                   fresh_cache):
    monkeypatch.setenv("CUDA_HOME", str(_stub_cuda_home(tmp_path / "cuda",
                                                        "1.0")))
    compile_cache.init_compile_cache(str(tmp_path / "cache"))
    for _ in range(2):
        with port_device.timed_compile("kernels"):
            _build.build_all(["lrn_fwd", "maxpool_bwd"])
    st = port_device.compile_stats()["kernels"]
    assert (st["events"], st["cache_misses"], st["cache_hits"]) == (2, 1, 1)


def test_the_spec_memo_returns_the_same_net_and_records_a_hit():
    spec = zoo.lenet(batch=3)
    a = CompiledNet.compile(spec)
    before = port_device.compile_stats()["net"]
    b = CompiledNet.compile(zoo.lenet(batch=3))
    after = port_device.compile_stats()["net"]
    assert b is a
    assert after["events"] == before["events"] + 1
    assert after["cache_hits"] == before["cache_hits"] + 1
    assert after["cache_misses"] == before["cache_misses"]
    # the JAX package's memo does the same
    ja = JaxCompiledNet.compile(jax_zoo.lenet(batch=3))
    assert JaxCompiledNet.compile(jax_zoo.lenet(batch=3)) is ja


def test_both_servers_record_one_serve_bucket_event_per_bucket():
    r = np.random.default_rng(5)
    reqs = [{"data": r.standard_normal((28, 28, 1)).astype(np.float32)}
            for _ in range(4)]
    got = {}
    for k, (srv_cls, cfg_cls, net) in {
            "port": (InferenceServer, ServeConfig,
                     TorchNet(zoo.lenet(batch=4), device="cpu")),
            "jax": (JaxServer, JaxServeConfig,
                    JaxNet(jax_zoo.lenet(batch=4)))}.items():
        mod = port_device if k == "port" else jax_device
        zero = {"events": 0, "cache_hits": 0, "cache_misses": 0}
        before = mod.compile_stats().get("serve_bucket", zero)
        # a long wait: the burst of 4 fills its batch before it is formed
        cfg = cfg_cls(max_batch=4, max_wait_ms=500.0, buckets=(1, 4),
                      outputs=("prob",), metrics_every_batches=0)
        with srv_cls(net, cfg) as srv:
            srv.infer(reqs[0])                       # bucket 1
            for f in [srv.submit(x) for x in reqs]:  # bucket 4
                f.result(timeout=60)
            assert set(srv._compiled_buckets) == {1, 4}
        after = mod.compile_stats()["serve_bucket"]
        got[k] = {f: after[f] - before[f] for f in zero}
        assert got[k]["events"] == 2
    assert got["port"]["events"] == got["jax"]["events"]
    # the port on the CPU builds no kernel: every event a hit
    assert got["port"]["cache_hits"] == got["port"]["events"]
    assert got["port"]["cache_misses"] == 0


class _KernelNet(TorchNet):
    """A CPU net whose every forward goes through the kernel builder for
    lrn_fwd, as the card's LRN route does on its first launch (the CPU
    forwards themselves launch no kernel)."""

    def forward(self, *args, **kwargs):
        _build.build_all(["lrn_fwd"])
        return super().forward(*args, **kwargs)


def _serve_cold_then_warm(canary):
    """The "serve_bucket" events and this thread's nvcc runs of a server
    that installs a checkpoint's weights at `start` (where the canary, when
    on, runs) on a cold kernel-build directory, then of one on the warm
    directory: {"cold" | "warm": (events, builds)}."""
    jnet = JaxNet(jax_zoo.lenet(batch=4), seed=7)
    flat = {f"{lname}/{pname}": np.asarray(v)
            for lname, lp in jnet.params.items() for pname, v in lp.items()}
    r = np.random.default_rng(5)
    reqs = [{"data": r.standard_normal((28, 28, 1)).astype(np.float32)}
            for _ in range(4)]
    got = {}
    for child in ("cold", "warm"):
        before = len(port_device._events)
        cfg = ServeConfig(max_batch=4, max_wait_ms=500.0, buckets=(1, 4),
                          outputs=("prob",), metrics_every_batches=0,
                          canary=canary)
        srv = InferenceServer(_KernelNet(zoo.lenet(batch=4), device="cpu"),
                              cfg)
        assert (srv.manager.canary_batch is not None) == canary
        with track_compiles() as tc:
            srv.start(weights=flat)
            try:
                srv.infer(reqs[0])                       # bucket 1
                for f in [srv.submit(x) for x in reqs]:  # bucket 4
                    f.result(timeout=60)
            finally:
                srv.stop()
        got[child] = ([e for e in port_device._events[before:]
                       if e[0] == "serve_bucket"], tc.builds)
    return got


def test_a_canary_that_reaches_no_kernel_joins_no_event(fresh_cache,
                                                        isolated_records):
    """On the CPU the install canary's forward launches no kernel, so
    `start` keeps nothing for the first "serve_bucket" event, whose
    seconds are then its own forward's."""
    cfg = ServeConfig(max_batch=1, buckets=(1,), metrics_every_batches=0,
                      canary=True)
    with InferenceServer(TorchNet(zoo.lenet(batch=1), device="cpu"),
                         cfg) as srv:
        assert srv.manager.canary_batch is not None
        assert srv._startup_build is None
        srv.infer({"data": np.zeros((28, 28, 1), np.float32)})
    assert [e[2] for e in port_device._events
            if e[0] == "serve_bucket"] == [True]


def test_a_cold_server_records_its_kernel_build_and_a_warm_one_none(
        tmp_path, monkeypatch, fresh_cache, isolated_records):
    """A server with its install canary on: the canary's forward, which
    `start` runs, is the first to reach the kernel builder, and `start`
    folds that region into the server's first "serve_bucket" event. On a
    cold kernel-build directory (the stub nvcc runs, on `start`'s thread)
    that event reads cache_hit="false"; a second server on the now warm
    directory records no "false" event; both record one event per bucket,
    as before."""
    monkeypatch.setenv("CUDA_HOME", str(_stub_cuda_home(tmp_path / "cuda",
                                                        "1.0")))
    compile_cache.init_compile_cache(str(tmp_path / "cache"))
    got = _serve_cold_then_warm(canary=True)
    (cold, cold_builds), (warm, warm_builds) = got["cold"], got["warm"]
    assert (cold_builds, warm_builds) == (1, 0)
    assert len(cold) == len(warm) == 2
    assert cold[0][2] is False and cold[1][2] is True
    assert [e[2] for e in warm] == [True, True]


def test_without_a_canary_the_first_bucket_records_the_build(
        tmp_path, monkeypatch, fresh_cache, isolated_records):
    """With the canary off, the first bucket's forward builds the kernel
    on the serve worker's thread, inside its own compile region: the same
    events as with the canary on."""
    monkeypatch.setenv("CUDA_HOME", str(_stub_cuda_home(tmp_path / "cuda",
                                                        "1.0")))
    compile_cache.init_compile_cache(str(tmp_path / "cache"))
    got = _serve_cold_then_warm(canary=False)
    (cold, cold_builds), (warm, warm_builds) = got["cold"], got["warm"]
    assert (cold_builds, warm_builds) == (0, 0)      # not this thread's
    assert [e[2] for e in cold] == [False, True]
    assert [e[2] for e in warm] == [True, True]
