"""The port's admission door and bucket ladders against the JAX package's.

`serve/admission.py` and `serve/buckets.py` are copies of the JAX
package's pure modules. The same scripted acquisitions — tenant, priority
and clock instant, with pressure changes — go through both packages'
`TenantAdmission` and `PriorityAdmission` under one injected clock (each
module's `time` replaced by a fake whose `monotonic()` the script sets),
and must give identical admit/shed decisions, counters, status rows and
construction errors. The same histograms and JSONL files through both
packages' `derive_buckets`, `padded_slots`, `fill_ratio` and
`size_hist_from_jsonl` must give equal ladders. Everything here is
exact: tolerance 0.
"""
import json

import numpy as np
import pytest

import sparknet_tpu.serve.admission as jax_adm
import sparknet_tpu.serve.buckets as jax_buckets
from sparknet_tpu.serve.batcher import QueueFullError as JaxQueueFull

import sparknet_tpu_torch.serve.admission as adm
import sparknet_tpu_torch.serve.buckets as buckets
from sparknet_tpu_torch.serve.batcher import QueueFullError

PKGS = {"port": adm, "jax": jax_adm}


class FakeClock:
    """Stands in for a module's `time`: monotonic() is what the script
    says."""

    def __init__(self):
        self.now = 1000.0

    def monotonic(self):
        return self.now


@pytest.fixture
def clocks(monkeypatch):
    out = {}
    for k, mod in PKGS.items():
        out[k] = FakeClock()
        monkeypatch.setattr(mod, "time", out[k])
    return out


def _script(seed, n=400):
    """(dt, tenant, priority, pressure or None) steps from a seed."""
    r = np.random.default_rng(seed)
    tenants = ["a", "b", "c", "", None, "heavy"]
    prios = ["high", "normal", "low", "LOW ", "bogus", None]
    out = []
    for i in range(n):
        dt = float(r.choice([0.0, 0.001, 0.05, 0.2, 1.0]))
        pressure = (float(r.choice([0.0, 0.3, 0.6, 0.95, 1.0]))
                    if i % 37 == 0 else None)
        out.append((dt, tenants[r.integers(len(tenants))],
                    prios[r.integers(len(prios))], pressure))
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("door", [
    ("TenantAdmission", dict(rate_rps=5.0, burst=3.0)),
    ("TenantAdmission", dict(rate_rps=2.0, max_tenants=3)),
    ("PriorityAdmission", dict(rate_rps=4.0, burst=2.0,
                               weights={"heavy": 3.0, "a": 0.5})),
    ("PriorityAdmission", dict(rate_rps=None)),
    ("PriorityAdmission", dict(rate_rps=10.0, max_tenants=2,
                               shed_at={"normal": 0.5, "high": 0.99},
                               tighten=0.5, rate_floor=0.2)),
], ids=["tenant", "tenant-evict", "priority-weighted", "priority-only",
        "priority-custom"])
def test_scripted_acquisitions_decide_as_the_jax_door(clocks, door, seed):
    cls, kw = door
    doors = {k: getattr(mod, cls)(**kw) for k, mod in PKGS.items()}
    decisions = {k: [] for k in PKGS}
    for dt, tenant, prio, pressure in _script(seed):
        for k, d in doors.items():
            clocks[k].now += dt
            if pressure is not None and hasattr(d, "set_pressure"):
                d.set_pressure(pressure)
            decisions[k].append(d.admit(tenant, prio))
            if cls == "TenantAdmission":
                decisions[k].append(d.allow(tenant))
    assert decisions["port"] == decisions["jax"]
    assert {None, "tenant_limit"} & set(decisions["port"])
    p, j = doors["port"], doors["jax"]
    assert p.shed == j.shed and p.tracked_tenants() == j.tracked_tenants()
    assert p.snapshot() == j.snapshot()
    if cls == "PriorityAdmission":
        assert p.status() == j.status()
        assert p.starvation_s() == j.starvation_s()


def test_low_class_starvation_clock_matches(clocks):
    doors = {k: mod.PriorityAdmission(rate_rps=100.0)
             for k, mod in PKGS.items()}
    for k, d in doors.items():
        d.set_pressure(0.6)   # low sheds at 0.5
        assert d.admit("t", "low") == "priority"
        clocks[k].now += 7.5
        assert d.starvation_s() == 7.5
        d.set_pressure(0.0)
        assert d.admit("t", "low") is None
        assert d.starvation_s() == 0.0


@pytest.mark.parametrize("cls,kw", [
    ("TenantAdmission", dict(rate_rps=0.0)),
    ("TenantAdmission", dict(rate_rps=1.0, burst=0.5)),
    ("PriorityAdmission", dict(rate_rps=1.0, weights={"x": 0.0})),
    ("PriorityAdmission", dict(rate_rps=1.0, shed_at={"urgent": 0.1})),
    ("PriorityAdmission", dict(rate_rps=1.0, tighten=1.5)),
    ("PriorityAdmission", dict(rate_rps=1.0, rate_floor=0.0)),
])
def test_construction_errors_are_the_jax_door_s(cls, kw):
    errs = {}
    for k, mod in PKGS.items():
        with pytest.raises(ValueError) as e:
            getattr(mod, cls)(**kw)
        errs[k] = str(e.value)
    assert errs["port"] == errs["jax"]


def test_priority_parsing_and_error_types():
    for v in ("high", " Normal ", "LOW", "bogus", "", None):
        assert adm.parse_priority(v) == jax_adm.parse_priority(v)
    assert adm.PRIORITIES == jax_adm.PRIORITIES
    assert adm.DEFAULT_SHED_AT == jax_adm.DEFAULT_SHED_AT
    # both shed errors are 429s: subclasses of the package's QueueFullError
    for name in ("TenantLimitError", "PriorityShedError"):
        assert issubclass(getattr(adm, name), QueueFullError)
        assert issubclass(getattr(jax_adm, name), JaxQueueFull)
        assert getattr(adm, name).__mro__[1].__name__ == \
            getattr(jax_adm, name).__mro__[1].__name__


# -- bucket ladders ----------------------------------------------------------

def _hists(seed, n=8):
    r = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        max_batch = int(r.choice([1, 4, 8, 16, 128]))
        sizes = {int(s): int(r.integers(0, 50))
                 for s in r.integers(1, max_batch + 4, size=6)}
        out.append((sizes, max_batch))
    return out


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_derive_buckets_equals_the_jax_ladder(seed):
    for sizes, max_batch in _hists(seed):
        for k in (1, 2, 3, 4, 6):
            got = buckets.derive_buckets(sizes, max_batch, k=k)
            want = jax_buckets.derive_buckets(sizes, max_batch, k=k)
            assert got == want and got[-1] == max_batch
            clipped = {s: n for s, n in sizes.items() if s <= max_batch}
            assert buckets.padded_slots(clipped, got) == \
                jax_buckets.padded_slots(clipped, want)
            assert buckets.fill_ratio(clipped, got) == \
                jax_buckets.fill_ratio(clipped, want)
    # string keys (JSON) and the empty histogram
    assert buckets.derive_buckets({"3": 5, "8": 1}, 8, k=2) == \
        jax_buckets.derive_buckets({"3": 5, "8": 1}, 8, k=2)
    assert buckets.derive_buckets({}, 16) == \
        jax_buckets.derive_buckets({}, 16) == (16,)


@pytest.mark.parametrize("args", [({1: 1}, 0, 4), ({1: 1}, 4, 0)])
def test_derive_buckets_errors_match(args):
    errs = []
    for mod in (buckets, jax_buckets):
        with pytest.raises(ValueError) as e:
            mod.derive_buckets(*args[:2], k=args[2])
        errs.append(str(e.value))
    assert errs[0] == errs[1]
    with pytest.raises(ValueError, match="exceeds the largest bucket"):
        buckets.padded_slots({9: 1}, (4, 8))


def test_size_hist_from_jsonl_equals_the_jax_reader(tmp_path):
    r = np.random.default_rng(7)
    paths = []
    for f in range(3):
        p = tmp_path / f"serving_metrics_{f}.jsonl"
        lines = []
        for row in range(5):
            for model in ("a", "b"):
                hist = {str(int(s)): int(r.integers(1, 30))
                        for s in r.integers(1, 9, size=3)}
                lines.append(json.dumps({"step": row, "model": model,
                                         "batch_size_hist": hist}))
            lines.append("not json")
            lines.append(json.dumps({"step": row, "loss": 1.0}))
        lines.append(json.dumps({"batch_size_hist": {"x": 1, "2": 3}}))
        p.write_text("\n".join(lines) + "\n\n")
        paths.append(str(p))
    for model in (None, "a", "b", "default", "zzz"):
        got = buckets.size_hist_from_jsonl(paths, model=model)
        assert got == jax_buckets.size_hist_from_jsonl(paths, model=model)
    merged = buckets.size_hist_from_jsonl(paths)
    assert set(merged) == {"a", "b", "default"}
    assert merged["default"] == {2: 9}
