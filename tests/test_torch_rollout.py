"""The port's rollout duty and gate (fleet/rollout.py) against the JAX
package's, and the port's serving manager obeying the gate.

- The gate file: `write_gate` of the same gate is byte-equal in both
  packages, and each package's `read_gate` reads the other's, on a local
  path and on the fake GCS and S3 of `tests/fake_stores.py`.
- `RolloutManager`: the two packages' managers get the same scripted
  adoption views, newest steps and burn under an injected clock (`now`)
  and must make the same transitions — the state after every tick, the
  audit events, the gate bytes and `status()`: staggered waves; a halt on
  burn, on a canary or wave timeout, on a rejected canary (which never
  reaches a peer); a denied step never retried; and seeded random fleets.
- A port `ModelManager` obeys a gate the JAX package wrote, step for
  step as the JAX manager does over the same store (hold, per-replica
  approval, "all", a denied step, a swap back down), and a rollout driven
  over two port managers keeps a corrupt step on the canary only.
Everything is driven by `tick(..., now=...)` and `poll(now=...)`: no
thread, no sleep.
"""
import contextlib
import os

import numpy as np
import pytest
import torch

from fake_stores import bucket_store
from sparknet_tpu.fleet import rollout as jro
from sparknet_tpu.net_api import JaxNet
from sparknet_tpu.serve.model_manager import ModelManager as JaxManager
from sparknet_tpu.zoo import lenet as jax_lenet

from sparknet_tpu_torch import zoo
from sparknet_tpu_torch.data import gcs, s3
from sparknet_tpu_torch.fleet import rollout as pro
from sparknet_tpu_torch.model.net import params_to_jax
from sparknet_tpu_torch.net_api import TorchNet
from sparknet_tpu_torch.serve.model_manager import ModelManager
from sparknet_tpu_torch.utils import checkpoint as ckpt

torch.set_num_threads(2)

GATES = [
    {"v": 1, "state": "idle", "wave": 0, "approved": {}, "denied": []},
    {"v": 1, "state": "canary", "wave": 0, "approved": {"local": 12},
     "denied": [], "target": 12, "all": 8},
    {"v": 1, "state": "wave", "wave": 2,
     "approved": {"local": 12, "m-1": 12, "m-2": 12}, "denied": [11, 9],
     "target": 12, "all": 8},
    {"v": 1, "state": "idle", "wave": 0, "approved": {}, "denied": [13],
     "all": 12},
]


@pytest.mark.parametrize("i", range(len(GATES)))
def test_the_gate_file_is_byte_equal(tmp_path, i):
    jp, pp = str(tmp_path / "j" / "ROLLOUT.json"), \
        str(tmp_path / "p" / "ROLLOUT.json")
    jro.write_gate(jp, GATES[i])
    pro.write_gate(pp, GATES[i])
    with open(jp, "rb") as a, open(pp, "rb") as b:
        assert b.read() == a.read()
    assert pro.read_gate(jp) == jro.read_gate(pp) == GATES[i]
    # no temp file left behind
    assert os.listdir(tmp_path / "p") == ["ROLLOUT.json"]


def test_a_missing_or_torn_gate_reads_as_none(tmp_path):
    p = str(tmp_path / "ROLLOUT.json")
    assert pro.read_gate(p) is None and jro.read_gate(p) is None
    with open(p, "w") as f:
        f.write('{"v": 1, "appro')
    assert pro.read_gate(p) is None and jro.read_gate(p) is None
    with open(p, "w") as f:
        f.write("[1, 2]")
    assert pro.read_gate(p) is None and jro.read_gate(p) is None


def _clear_port_caches():
    for m in (gcs, s3):
        m._CLIENTS.clear()
        m._SIZE_CACHE.clear()
        m._STAT_CACHE.clear()


@contextlib.contextmanager
def _bucket(kind, monkeypatch):
    with bucket_store(kind) as (url, srv):
        _clear_port_caches()
        monkeypatch.setattr(gcs, "BACKOFF_S", 0.01)
        try:
            yield url
        finally:
            _clear_port_caches()


@pytest.mark.parametrize("kind", ["gs", "s3"])
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_each_package_reads_the_others_bucket_gate(kind, writer,
                                                   monkeypatch):
    with _bucket(kind, monkeypatch) as url:
        path = f"{url}/fleet/m/ROLLOUT.json"
        assert pro.read_gate(path) is None
        w, r = (jro, pro) if writer == "jax" else (pro, jro)
        w.write_gate(path, GATES[2])
        assert r.read_gate(path) == GATES[2]
        _clear_port_caches()
        assert pro.read_gate(path) == GATES[2]
        w.write_gate(path, GATES[3])  # one-object replace
        _clear_port_caches()
        assert r.read_gate(path) == GATES[3]


class Twin:
    """A JAX and a port RolloutManager ticked alike; after each tick the
    state, the events so far and the gate bytes must be equal."""

    def __init__(self, tmp_path, **kw):
        self.events = {"jax": [], "port": []}
        self.paths = {k: str(tmp_path / k / "ROLLOUT.json")
                      for k in ("jax", "port")}
        self.m = {}
        for k, mod in (("jax", jro), ("port", pro)):
            self.m[k] = mod.RolloutManager(
                self.paths[k], event=(lambda d, r, _k=k, **ex:
                                      self.events[_k].append((d, r, ex))),
                **kw)
        self.states = []

    def tick(self, views, newest, burn, now):
        got = {}
        for k, mod in (("jax", jro), ("port", pro)):
            vs = [mod.ReplicaView(*v) for v in views]
            got[k] = self.m[k].tick(vs, newest, burn, now=now)
        assert got["port"] == got["jax"]
        assert self.events["port"] == self.events["jax"]
        assert self.m["port"].status() == self.m["jax"].status()
        if os.path.exists(self.paths["jax"]):
            with open(self.paths["jax"], "rb") as a, \
                    open(self.paths["port"], "rb") as b:
                assert b.read() == a.read()
        self.states.append(got["port"])
        return got["port"]

    def gate(self):
        return pro.read_gate(self.paths["port"])


KEYS = ["local", "m-1", "m-2", "m-3", "m-4"]


def test_staggered_waves_then_fleet_wide(tmp_path):
    t = Twin(tmp_path, wave_size=2, timeout_s=10.0)
    views = {k: [k, 1, 0] for k in KEYS}
    now = 0.0

    def step():
        nonlocal now
        now += 1.0
        return t.tick([tuple(v) for v in views.values()], 2, 0.2, now)

    assert step() == "canary"
    # everyone else holds: no "all" yet, the canary's step is the fallback
    assert t.gate()["approved"] == {"local": 2} and "all" not in t.gate()
    assert t.m["port"].fallback == 1
    assert step() == "canary"          # not adopted yet: hold
    views["local"][1] = 2
    assert step() == "wave"
    assert t.gate()["approved"] == {"local": 2, "m-1": 2, "m-2": 2}
    views["m-1"][1] = views["m-2"][1] = 2
    assert step() == "wave" and t.m["port"].wave == 2
    views["m-3"][1] = views["m-4"][1] = 2
    assert step() == "idle"            # wave 2 adopted, nothing pending
    # the done gate still names the last wave (JAX `_finish` writes first)
    assert t.gate() == {"v": 1, "state": "idle", "wave": 2,
                        "approved": {}, "denied": [], "all": 2}
    assert [e[1] for e in t.events["port"]] == \
        ["canary", "wave", "wave", "done"]
    assert t.m["port"].status()["rollouts"] == 1
    assert step() == "idle"            # the same newest step: nothing


def test_a_rejected_canary_never_reaches_a_peer(tmp_path):
    t = Twin(tmp_path, wave_size=2)
    views = {k: [k, 1, 0] for k in KEYS}
    assert t.tick([tuple(v) for v in views.values()], 3, 0.0, 1.0) == \
        "canary"
    views["local"][2] = 1              # the canary refused step 3
    assert t.tick([tuple(v) for v in views.values()], 3, 0.0, 2.0) == \
        "idle"
    gate = t.gate()
    assert gate["denied"] == [3] and gate["all"] == 1
    assert gate["approved"] == {}
    assert t.events["port"][-1][1] == "halt"
    assert "canary local rejected" in t.events["port"][-1][2]["why"]
    # the denied step is never rolled out again
    for i in range(3):
        assert t.tick([tuple(v) for v in views.values()], 3, 0.0,
                      3.0 + i) == "idle"
    # a newer step opens a new rollout from the old fallback
    assert t.tick([tuple(v) for v in views.values()], 4, 0.0, 9.0) == \
        "canary"
    assert t.gate()["approved"] == {"local": 4}


@pytest.mark.parametrize("where", ["canary", "wave"])
def test_burn_halts_the_rollout(tmp_path, where):
    t = Twin(tmp_path, wave_size=1, halt_burn=1.5)
    views = {k: [k, 1, 0] for k in KEYS[:3]}
    t.tick([tuple(v) for v in views.values()], 2, 0.0, 1.0)
    views["local"][1] = 2
    if where == "wave":
        assert t.tick([tuple(v) for v in views.values()], 2, 0.5,
                      2.0) == "wave"
    assert t.tick([tuple(v) for v in views.values()], 2, 1.6, 3.0) == \
        "idle"
    assert t.events["port"][-1][1] == "halt"
    assert "burn 1.60 >= 1.5" in t.events["port"][-1][2]["why"]
    # the adopters swap back down to the fallback
    assert t.gate()["all"] == 1 and t.gate()["denied"] == [2]


@pytest.mark.parametrize("where", ["canary", "wave"])
def test_an_adoption_timeout_halts_the_rollout(tmp_path, where):
    t = Twin(tmp_path, wave_size=2, timeout_s=5.0)
    views = {k: [k, 1, 0] for k in KEYS[:3]}
    t.tick([tuple(v) for v in views.values()], 2, 0.0, 0.0)
    if where == "wave":
        views["local"][1] = 2
        t.tick([tuple(v) for v in views.values()], 2, 0.0, 1.0)
        t0 = 1.0
    else:
        t0 = 0.0
    assert t.tick([tuple(v) for v in views.values()], 2, 0.0,
                  t0 + 5.0) != "idle"     # at the bound: still waiting
    assert t.tick([tuple(v) for v in views.values()], 2, 0.0,
                  t0 + 5.5) == "idle"
    assert "never adopted within 5.0s" in t.events["port"][-1][2]["why"]


@pytest.mark.parametrize("seed", range(12))
def test_seeded_fleets_make_the_same_transitions(tmp_path, seed):
    """Random fleets: replicas adopt what the gate approves for them
    (some slowly, some refusing a bad step), burn wanders, new steps
    commit; both managers must agree on every tick."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 6))
    keys = KEYS[:n]
    t = Twin(tmp_path, wave_size=int(rng.integers(1, 3)),
             halt_burn=1.5, timeout_s=float(rng.integers(3, 8)))
    step = {k: 1 for k in keys}
    rolls = {k: 0 for k in keys}
    bad = {int(s) for s in rng.choice([3, 5, 6], size=1)}
    newest = 1
    for i in range(80):
        if rng.uniform() < 0.08:
            newest += 1
        burn = float(rng.choice([0.1, 0.5, 1.0, 1.7], p=[.5, .3, .15, .05]))
        t.tick([(k, step[k], rolls[k]) for k in keys], newest, burn,
               float(i))
        gate = t.gate() or {}
        for k in keys:
            want = gate.get("approved", {}).get(k, gate.get("all"))
            if want is None or want == step[k] or \
                    want in gate.get("denied", ()):
                continue
            if want in bad:
                if rng.uniform() < 0.5:
                    rolls[k] += 1
            elif rng.uniform() < 0.6:
                step[k] = want
    assert len(t.states) == 80


# -- the serving manager obeys the gate ---------------------------------------


@pytest.fixture(scope="module")
def store(tmp_path_factory):
    """Steps 1 and 2 (lenet, seeds 1 and 2) in the JAX package's
    monolithic format, written through the port's store."""
    d = str(tmp_path_factory.mktemp("gate_store") / "ck")
    for step in (1, 2):
        net = TorchNet(zoo.lenet(batch=4), seed=step, device="cpu")
        ckpt.save(d, {"params": params_to_jax(net.net, net.params)},
                  step=step)
    return d


# (gate the JAX package writes, the step the manager serves after a poll,
# from an initial step of 1)
GATE_CASES = [
    ("none", None, 2),
    ("hold", {"v": 1, "state": "canary", "wave": 0,
              "approved": {"other": 2}, "denied": []}, 1),
    ("approved", {"v": 1, "state": "canary", "wave": 0,
                  "approved": {"r1": 2}, "denied": [], "all": 1}, 2),
    ("all", {"v": 1, "state": "idle", "wave": 0, "approved": {},
             "denied": [], "all": 2}, 2),
    ("denied", {"v": 1, "state": "idle", "wave": 0,
                "approved": {"r1": 2}, "denied": [2], "all": 1}, 1),
    ("torn", "{\"v\": 1", 2),
]


@pytest.mark.parametrize("case", GATE_CASES, ids=[c[0] for c in GATE_CASES])
def test_a_port_manager_obeys_a_jax_gate(tmp_path, store, case):
    _, gate, want = case
    path = str(tmp_path / "ROLLOUT.json")
    if isinstance(gate, dict):
        jro.write_gate(path, gate)
    elif gate is not None:
        with open(path, "w") as f:
            f.write(gate)
    got = {}
    for k, mgr in (("port", ModelManager(
            TorchNet(zoo.lenet(batch=4), device="cpu"),
            checkpoint_dir=store, poll_interval_s=1.0, replica="r1",
            rollout_gate=path)),
            ("jax", JaxManager(JaxNet(jax_lenet(batch=4)),
                               checkpoint_dir=store, poll_interval_s=1.0,
                               replica="r1", rollout_gate=path))):
        flat, s, extra = ckpt.restore_flat(store, step=1)
        if k == "port":
            assert mgr.install(flat, s, extra, initial=True)
        else:
            assert mgr._install(flat, s, extra, initial=True)
        mgr.poll(now=10.0)
        got[k] = mgr.step
        assert mgr.latest_seen == 2
    assert got["port"] == got["jax"] == want


def test_a_halted_rollout_swaps_the_canary_back_down(tmp_path, store):
    """A rollout over two port managers through the port's duty: the
    canary takes step 2 first, the peer waits; a halt on burn reverts the
    canary to step 1 and denies step 2 to both."""
    gate = str(tmp_path / "ROLLOUT.json")
    mgrs = {k: ModelManager(TorchNet(zoo.lenet(batch=4), device="cpu"),
                            checkpoint_dir=store, poll_interval_s=1.0,
                            replica=k, rollout_gate=gate)
            for k in ("local", "m-1")}
    flat, s, extra = ckpt.restore_flat(store, step=1)
    for m in mgrs.values():
        assert m.install(flat, s, extra, initial=True)
    ro = pro.RolloutManager(gate, wave_size=1, halt_burn=1.5)

    def tick(now, burn=0.0):
        views = [pro.ReplicaView(k, m.step, m.swap_failures)
                 for k, m in mgrs.items()]
        state = ro.tick(views, 2, burn, now=now)
        for m in mgrs.values():
            m.poll(now=now)
        return state

    assert tick(1.0) == "canary"
    assert mgrs["local"].step == 2 and mgrs["m-1"].step == 1
    assert tick(3.0, burn=2.0) == "idle"      # halt: burn on the canary
    assert pro.read_gate(gate)["denied"] == [2]
    assert tick(5.0) == "idle"
    assert mgrs["local"].step == 1 and mgrs["m-1"].step == 1
    assert mgrs["m-1"].swaps == 0 and mgrs["local"].swaps == 2


def test_a_corrupt_step_stays_on_the_canary(tmp_path, store):
    """Step 3 is corrupt (one digest-covered byte flipped): the canary
    rejects it, the duty halts, and the peer never fetches it."""
    import shutil
    from fake_stores import corrupt_npz_bytes
    d = str(tmp_path / "ck")
    shutil.copytree(store, d)
    net = TorchNet(zoo.lenet(batch=4), seed=3, device="cpu")
    ckpt.save(d, {"params": params_to_jax(net.net, net.params)}, step=3)
    npz = os.path.join(d, "step-3", "state.npz")
    with open(npz, "rb") as f:
        raw = f.read()
    with open(npz, "wb") as f:
        f.write(corrupt_npz_bytes(raw))
    gate = str(tmp_path / "ROLLOUT.json")
    pro.write_gate(gate, {"v": 1, "state": "idle", "wave": 0,
                          "approved": {}, "denied": [], "all": 2})
    mgrs = {k: ModelManager(TorchNet(zoo.lenet(batch=4), device="cpu"),
                            checkpoint_dir=d, poll_interval_s=1.0,
                            replica=k, rollout_gate=gate)
            for k in ("local", "m-1")}
    for m in mgrs.values():
        m.poll(now=0.0)
        assert m.step == 2
    ro = pro.RolloutManager(gate, wave_size=1)
    ro._all = 2
    states = []
    for i in range(1, 6):
        views = [pro.ReplicaView(k, m.step, m.swap_failures)
                 for k, m in mgrs.items()]
        states.append(ro.tick(views, 3, 0.0, now=float(i)))
        for m in mgrs.values():
            m.poll(now=float(i))
    assert states[0] == "canary" and states[-1] == "idle"
    assert mgrs["local"].swap_failures == 1
    assert mgrs["m-1"].swap_failures == 0
    assert mgrs["local"].step == mgrs["m-1"].step == 2
    assert ro.status()["denied"] == [3] and ro.halts == 1
