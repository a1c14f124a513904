"""The seam between the harness and the kinds of configuration and traffic.

- What both sides are handed stays what it was when the harness branched
  on the backend's name: the weights, the rows, the reference's rounds,
  the comparison's arithmetic and the FLOPs, pinned as SHA-256 digests and
  numbers made on the CPU in one thread, at the seed below.
- A third backend and a second traffic kind, both defined here alone and
  put in `sys.modules` under the names the harness looks up, run through
  `cell.run_rank` and come out correct: the port's LeNet through `train()`
  on seeded float32 rows, against a plain-torch loss of its own.
- No shared module of the harness compares a backend or a traffic kind
  to a literal, or names one.
"""
from __future__ import annotations

import ast
import hashlib
import math
import struct
import sys
import time
import types

import pytest
import torch
import torch.nn.functional as F

from portbench import cell as cell_mod
from portbench import compare, flops, inputs, load, programs
from portbench.reference.train import follow
from portbench.tests import tiny

CPU = torch.device("cpu")
SEED = 2 ** 31 + 77

#: made from the harness as it branched on "caffe" / "graph", one thread
PINNED = {
    "caffe": {
        "weights": "02dd3dc618eb91613df999f704f47b6af9f6b3ef41f47ef6b2fcb0d30e35ea58",
        "round0.0": "f55676b88f3f7d9245f20199090d5fae4f33176ff456c0d3fc3c7e7bde6fa123",
        "round0.1": "0a08cbdfd5094fa106ccb5082827bb1244f097788a9c12692f411f65d13798d4",
        "round0.2": "86daea4f9fb4f340fc8d6961b26b0d1f673a1a97fa5d6d0cb57f0b486639318c",
        "round1.0": "c36724409ec745d3545566d23842c7839b57856cb14a2f68013fc682eee79a4b",
        "round1.1": "924ebcdbcec63405845ee0765aef84a1bc31d7259ba2434c82f69b0564a72f67",
        "round1.2": "6cb053888f900899b1e9b3d669196dc1bdde2f56bc6b5ea32186f1c0b237877a",
        "loss": "6098e3cfc16fea2007be23d440f7411ab4c4e6020220f83cb8c18a46fa4a24d5",
        "first": "b74fb95c2e76ed8a6df03a28598a96c030f0b35e82f67c0cff75dbb1482fe066",
        "momentum": "2fa3183525376969b808243cb525661bd0dd3a14a48c79d5fb7b2ee33b86e579",
        "params": "9a5e1f4cabfe1a1090b73bda6b8327dc80f2d8c4f46d0a7e0b2dd6577ba1aaac",
        "numbers": {"loss_gap": 0.00029999999999993037,
                    "grad_gap": 0.0002949096355370854,
                    "grad_unit_gap": 1.6422719958664104e-05,
                    "momentum_gap": 0.0003810057394473435,
                    "change_gap": 0.0007284696134802659},
    },
    "graph": {
        "weights": "ed35d288679174ee047822e918c77ac840dfc1d35388f65231d63226eda32df0",
        "round0.0": "b9af1aecfeb97aa298b24599d129d31574c3462365abf0c14ae207e8dabe1682",
        "round0.1": "ba2d3fd3f4dc81a0857b4b55a4b370808fdfd327bcdaeb057b4fd3bb4e8febdf",
        "round0.2": "7781fe73a62f3c58d0874b95683d873d740119da9f25f646c5ed4923afff17fd",
        "round1.0": "ac4e4a5285e409d799e5919d77eea7a65787af5d11b527aa991f2c869efc22c8",
        "round1.1": "6db64781602bd5bf8f2ed5e1aaec8cf2bcd9822647f37f4bc7085b31c148f4b5",
        "round1.2": "481c9098352c5352e8ae3634054c25dae09dcd6b461ef72dd1a03619aeac7739",
        "loss": "369339e0b84e590ab281be2737cd43a3737eeb1e97f7eab09ee41ad668fb3321",
        "first": "7b71b114934ad564e28b12eaf48ad1f608ee3a586975ed16683b28fbb145ecf5",
        "momentum": "d669f05dcce6da82ffb5b5300b1a5ca7931ea11fda6e79491a2a7d7c0212495a",
        "params": "3039600a5ecc0813b0b2d924b7110e88442cbd8fc78b246d03d70acf7c098a0e",
        "numbers": {"loss_gap": 0.00029999999999996897,
                    "grad_gap": 0.00017248500159244623,
                    "grad_unit_gap": 9.539688446811911e-05,
                    "momentum_gap": 0.0002673129390469859,
                    "change_gap": 0.00020688119265468877},
    },
}
TRAIN_FLOPS = {"caffenet": 4346440896.0, "alexnet_graph": 4417730688.0}


def digest(tree) -> str:
    """SHA-256 over each leaf's key, dtype, shape and bytes, keys sorted."""
    h = hashlib.sha256()
    for k in sorted(tree):
        t = tree[k].detach().to("cpu").contiguous()
        h.update(f"{k}|{t.dtype}|{tuple(t.shape)}|".encode())
        h.update(t.numpy().tobytes())
    return h.hexdigest()


def floats_digest(xs) -> str:
    return hashlib.sha256(struct.pack(f"<{len(xs)}d", *xs)).hexdigest()


def perturbed(tree, seed: int):
    """Each leaf times (1 + 1e-3 of a seeded normal), leaves in key
    order."""
    g = torch.Generator().manual_seed(seed)
    return {k: v * (1 + 1e-3 * torch.randn(v.shape, generator=g))
            for k, v in sorted(tree.items())}


@pytest.fixture
def one_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


@pytest.mark.parametrize("backend", ["caffe", "graph"])
def test_weights_rows_rounds_and_numbers_are_pinned(backend, one_thread):
    config, traffic = getattr(tiny, backend)()
    want = PINNED[backend]
    assert digest(inputs.make_weights(config, SEED, CPU)) == want["weights"]
    for rank in (0, 1):
        for rnd in range(3):
            got = inputs.make_round(config, traffic, SEED, rank, rnd, CPU)
            assert digest(got) == want[f"round{rank}.{rnd}"], (rank, rnd)
    ref = follow(config, traffic, SEED, 2, 3, CPU)
    assert floats_digest(ref["loss"]) == want["loss"]
    for part in ("first", "momentum", "params"):
        assert digest(ref[part]) == want[part], part
    assert digest(ref["init"]) == want["weights"]
    # the comparison's arithmetic, over fixed trees: the reference against
    # a seeded perturbation of its losses, states and change
    prog = {"loss": [x * (1 + 1e-4 * (i + 1))
                     for i, x in enumerate(ref["loss"])],
            "first": perturbed(ref["first"], 1),
            "momentum": perturbed(ref["momentum"], 2),
            "params": {k: ref["init"][k] + d for k, d in perturbed(
                {k: v - ref["init"][k] for k, v in ref["params"].items()},
                3).items()}}
    assert compare.numbers(prog, ref, compare.unit_axes(
        config, ref["first"])) == want["numbers"]


@pytest.mark.parametrize("name", sorted(TRAIN_FLOPS))
def test_training_flops_of_the_published_configs_are_pinned(name):
    config = tiny._json(f"configs/{name}.json")
    assert flops.train_flops_per_image(config) == TRAIN_FLOPS[name]


# -- a third backend and a second traffic kind, defined here alone ----------

BACKEND, KIND = "seam_lenet", "seam_rows"
SIDE, CLASSES = 28, 10
#: (layer, kind, out, kernel, std, bias) of the zoo's LeNet; the weights
#: are the benchmark's, drawn with stds near 1/sqrt(fan-in) so that the
#: first rounds train smoothly
LENET = (("conv1", "conv", 32, 5, 0.1, 0.0),
         ("conv2", "conv", 64, 5, 0.02, 0.0),
         ("fc1", "ip", 512, None, 0.01, 0.1),
         ("fc2", "ip", CLASSES, None, 0.04, 0.1))


def _shapes(config):
    """Each layer's NCHW output (N, D for inner products) and its input
    under `<layer>:in`: 5x5 convolutions padded by 2, each followed by a
    2x2 MAX pool."""
    n = config["batch"]
    x, out = (n, 1, SIDE, SIDE), {}
    for name, kind, width, _, _, _ in LENET:
        out[f"{name}:in"] = x
        if kind == "conv":
            out[name] = (n, width, x[2], x[3])
            x = (n, width, x[2] // 2, x[3] // 2)
        else:
            x = out[name] = (n, width)
    return out


def _weight_leaves(config):
    shapes, leaves = _shapes(config), []
    for name, kind, width, k, std, bias in LENET:
        fan_in = shapes[f"{name}:in"]
        w = ((width, fan_in[1], k, k) if kind == "conv"
             else (width, math.prod(fan_in[1:])))
        leaves.append((f"{name}/w", w, {"type": "gaussian", "std": std}))
        leaves.append((f"{name}/b", (width,),
                       {"type": "constant", "value": bias}))
    return leaves


def _loss(config, weights, rows, mode, step_keys):
    x = rows["data"].permute(0, 3, 1, 2).float()
    for name, kind, _, _, _, _ in LENET:
        w, b = weights[f"{name}/w"], weights[f"{name}/b"]
        if kind == "conv":
            x = F.max_pool2d(F.relu(F.conv2d(x, w, b, padding=2)), 2, 2)
        else:
            x = F.linear(x.reshape(x.shape[0], -1), w, b)
            if name != LENET[-1][0]:
                x = F.relu(x)
    logp = F.log_softmax(x, dim=-1)
    return -logp.gather(-1, rows["label"].reshape(-1, 1).long())[:, 0].mean()


class _Sgd:
    """Caffe SGD as the zoo's LeNet sets it: V = m V + rate * lr_mult *
    (g + wd * W), lr_mult 1 for weights and 2 for biases; W -= V."""

    def __init__(self, config):
        self.s = config["solver"]

    def zeros(self, params):
        return {k: torch.zeros_like(v) for k, v in params.items()}

    @torch.no_grad()
    def update(self, params, momentum, grads, it):
        for k, w in params.items():
            mult = 2.0 if k.endswith("/b") else 1.0
            v = self.s["momentum"] * momentum[k] + self.s["base_lr"] * mult * (
                grads[k] + self.s["weight_decay"] * w)
            w.sub_(v)
            momentum[k] = v


def _forward_flops(config):
    shapes = _shapes(config)
    total = 0.0
    for name, kind, width, k, _, _ in LENET:
        fan_in = shapes[f"{name}:in"]
        if kind == "conv":  # padded to keep its input's size
            total += 2.0 * fan_in[2] * fan_in[3] * k * k * fan_in[1] * width
        else:
            total += 2.0 * math.prod(fan_in[1:]) * width
    return total


class _Program:
    """The port's zoo LeNet through `train()`, as the caffe adapter drives
    CaffeNet."""

    def __init__(self, config, traffic):
        self.config, self.traffic = config, traffic

    def run(self, seed, weights, source, logger, hook, device, workdir,
            cache_dir, trace_out=None):
        from sparknet_tpu_torch import zoo
        from sparknet_tpu_torch.apps.train_loop import train
        from sparknet_tpu_torch.parallel.trainer import ParallelTrainer
        from sparknet_tpu_torch.solver import SolverConfig

        cfg = programs._run_config(self.config, self.traffic, seed, workdir,
                                   cache_dir, trace_out,
                                   solver=SolverConfig(**self.config["solver"]))
        hook.cfg = cfg
        handed = []

        def init_state(trainer, seed=0):
            tree = {}
            for key in list(weights):
                layer, leaf = key.split("/")
                tree.setdefault(layer, {})[leaf] = weights.pop(key)
            handed.append(programs.FirstStep(
                trainer.solver, "update",
                lambda out, args: programs._host_tree(args[1].momentum, "/")))
            return trainer.state_from_params(tree)

        with programs._replaced(ParallelTrainer, "init_state", init_state):
            state = train(cfg, zoo.lenet(batch=self.config["batch"]), source,
                          logger=logger, round_hook=hook,
                          batch_transform=programs._as_is(), device=device)
        hook.first = handed[0].value
        return state

    @staticmethod
    def momentum(state):
        return programs._host_tree(state.momentum, "/")

    @staticmethod
    def params(state):
        return programs._host_tree(state.params, "/")


def _check(traffic):
    if traffic["std"] <= 0:
        raise ValueError("rows need a positive std")


def _make_round(config, traffic, seed, rank, rnd, device):
    tau, b = traffic["tau"], traffic["local_batch"]
    g = inputs.generator(device, seed, inputs.DATA, rank, rnd)
    data = traffic["std"] * torch.randn((tau, b, SIDE, SIDE, 1), generator=g,
                                        device=device)
    label = torch.randint(0, CLASSES, (tau, b, 1), generator=g,
                          device=device, dtype=torch.int32)
    return {"data": data, "label": label}


def _module(name, **attrs):
    mod = types.ModuleType(name)
    mod.__dict__.update(attrs)
    return mod


@pytest.fixture
def third_backend(monkeypatch):
    mods = {
        f"portbench.adapters.{BACKEND}": _module(
            f"portbench.adapters.{BACKEND}", Program=_Program),
        f"portbench.reference.{BACKEND}": _module(
            f"portbench.reference.{BACKEND}", shapes=_shapes,
            weight_leaves=_weight_leaves, optimizer=_Sgd, loss=_loss,
            unit_axis=lambda config, key: 0,
            forward_flops_per_sample=_forward_flops),
        f"portbench.kinds.{KIND}": _module(
            f"portbench.kinds.{KIND}", check=_check, make_round=_make_round),
    }
    for name, mod in mods.items():
        monkeypatch.setitem(sys.modules, name, mod)
    config = {"name": "lenet", "backend": BACKEND, "zoo": "lenet",
              "precision": "float32", "batch": 4, "crop": SIDE,
              "channels": 1, "n_classes": CLASSES,
              "solver": {"base_lr": 0.01, "momentum": 0.9,
                         "weight_decay": 5e-4, "lr_policy": "fixed"}}
    traffic = {"kind": KIND, "tau": 2, "local_batch": 4, "rounds_held": 3,
               "std": 1.0}
    yield config, traffic
    from sparknet_tpu_torch import precision
    precision.set_policy("float32")


@pytest.mark.parametrize("broken", [False, True])
def test_a_third_backend_and_kind_run_through_the_cell(third_backend, broken,
                                                       tmp_path, monkeypatch):
    """Broken: the adapter hands the check half the momentum the program
    holds after round 0, and the check sees it."""
    config, traffic = third_backend
    if broken:
        monkeypatch.setattr(_Program, "momentum", staticmethod(
            lambda state: {k: 0.5 * v for k, v in programs._host_tree(
                state.momentum, "/").items()}))
    c = tiny.cell("lenet.seam", config, traffic,
                  limits_of="caffenet.b256.tau5")
    res = cell_mod.run_rank(c, SEED, 0.5, False, 0, 1, "cpu", time.time(),
                            str(tmp_path), str(tmp_path / "kernels"))
    assert res["correct"] is not broken, res["checks"]
    assert res["failed"] == 0 and res["forbidden"] == []
    assert res["metrics"]["train_img_per_s"]["value"] > 0
    # LeNet's forward: the convolutions at 28 and 14, then 3136-512-10
    hand = (2 * 28 * 28 * 25 * 1 * 32 + 2 * 14 * 14 * 25 * 32 * 64
            + 2 * 3136 * 512 + 2 * 512 * 10)
    assert flops.train_flops_per_image(config) == 3 * hand


def test_an_unknown_backend_or_kind_names_the_file_it_lacks():
    with pytest.raises(ValueError, match="adapters/nowhere.py"):
        load.adapter({"backend": "nowhere"})
    with pytest.raises(ValueError, match="kinds/nowhere.py"):
        load.kind({"kind": "nowhere"})


# -- no shared module names a backend or a traffic kind ----------------------

SHARED = ("cell.py", "compare.py", "flops.py", "inputs.py", "programs.py",
          "reference/train.py", "calibrate.py", "run.py")
#: the names the harness finds files by
NAMED = ({p.stem for p in (load.HERE / "adapters").glob("*.py")}
         | {p.stem for p in (load.HERE / "kinds").glob("*.py")}) - {"__init__"}


def _docstrings(tree):
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.FunctionDef,
                             ast.AsyncFunctionDef, ast.ClassDef)):
            body = node.body
            if body and isinstance(body[0], ast.Expr) and isinstance(
                    body[0].value, ast.Constant):
                yield body[0].value


def _mentions(node) -> bool:
    """Whether an expression reads something called backend or kind."""
    for n in ast.walk(node):
        if isinstance(n, ast.Name) and n.id in ("backend", "kind"):
            return True
        if isinstance(n, ast.Attribute) and n.attr in ("backend", "kind"):
            return True
        if isinstance(n, ast.Constant) and n.value in ("backend", "kind"):
            return True
    return False


@pytest.mark.parametrize("rel", SHARED)
def test_no_shared_module_branches_on_a_backend_or_kind(rel):
    assert {"caffe", "graph", "train_rounds"} <= NAMED
    tree = ast.parse((load.HERE / rel).read_text())
    docs = {id(d) for d in _docstrings(tree)}
    for node in ast.walk(tree):
        if isinstance(node, ast.Compare):
            sides = [node.left] + node.comparators
            literal = any(isinstance(s, ast.Constant)
                          and isinstance(s.value, str) for s in sides)
            assert not (literal and any(_mentions(s) for s in sides)), (
                f"{rel}:{node.lineno} compares a backend or kind to a "
                f"literal")
        if isinstance(node, ast.Constant) and id(node) not in docs:
            assert node.value not in NAMED, (
                f"{rel}:{node.lineno} names {node.value!r}")
