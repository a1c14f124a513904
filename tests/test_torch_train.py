"""The port's training math (TRAIN-phase net, autograd, solver, net API)
against the JAX package.

Weights come from the JAX package (`CompiledNet.init_params`) and cross
into the port with `params_from_jax`; batches, gradients and dropout-free
nets are the same numpy data on both sides. Dropout masks cannot equal
`jax.random`'s bits, so every parity test runs copies of the nets with each
dropout ratio set to 0 (built as spec data); the dropout test checks the
port's own masks. Tolerances:
  - gradients, per tensor: max |port - JAX| <= 1e-4 * max |JAX| + 1e-7
    (convolution and matrix sums run in another order on the two sides);
  - the solver, 20 steps from identical gradients: within 4 f32 ulps of
    each tensor's largest magnitude (the update is elementwise and keeps
    the JAX op order; `pow` and `exp` in the lr policies may differ by an
    ulp between XLA and PyTorch); a bf16 velocity within 4 bf16 ulps;
  - the 50-iteration cifar10_quick trajectory against the independent
    numpy oracle (`tests/numpy_oracle.py`): the bands of the JAX package's
    own oracle test (`tests/test_parity.py`), losses 1e-4 for iterations
    0-9 and 0.20 after, params 0.08 at iteration 10 and 0.25 at 50
    (relative L2); the trajectory is chaotic through max-pool near-ties.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import numpy_oracle as orc
from sparknet_tpu import zoo as jax_zoo
from sparknet_tpu.data import synth
from sparknet_tpu.model.layers import OpsImpl as JaxOpsImpl
from sparknet_tpu.model.net import CompiledNet as JaxCompiledNet
from sparknet_tpu.model.spec import DropoutParam as JaxDropoutParam
from sparknet_tpu.model.spec import ParamSpec as JaxParamSpec
from sparknet_tpu.net_api import JaxNet
from sparknet_tpu.solver import SgdSolver as JaxSgdSolver
from sparknet_tpu.solver import SolverConfig as JaxSolverConfig

import sparknet_tpu_torch.model.spec as tspec
from sparknet_tpu_torch import zoo
from sparknet_tpu_torch.model.layers import ApplyCtx, OpsImpl, apply_dropout
from sparknet_tpu_torch.model.net import (CompiledNet, params_from_jax,
                                          params_to_jax)
from sparknet_tpu_torch.net_api import TorchNet
from sparknet_tpu_torch.solver import (SgdSolver, SolverConfig,
                                       learning_rate, value_and_grad)

torch.set_num_threads(2)
CPU = torch.device("cpu")

# (builder kwargs, input scale): x50 drives CaffeNet's LRNs off identity
NETS = {
    "cifar10_quick": (dict(batch=2), 1.0),
    "lenet": (dict(batch=2), 1.0),
    "adult_mlp": (dict(batch=3, n_features=5), 1.0),
    "caffenet": (dict(batch=2, crop=67, n_classes=16), 50.0),
}


def to_port_spec(obj):
    """A JAX-package spec object as the port's (the same dataclasses)."""
    if dataclasses.is_dataclass(obj):
        cls = getattr(tspec, type(obj).__name__)
        return cls(**{f.name: to_port_spec(getattr(obj, f.name))
                      for f in dataclasses.fields(obj)})
    if isinstance(obj, tuple):
        return tuple(to_port_spec(o) for o in obj)
    return obj


def dropout_free(spec):
    """The spec with every dropout ratio 0 (either package's spec)."""
    dp = JaxDropoutParam if type(spec).__module__.startswith(
        "sparknet_tpu.") else tspec.DropoutParam
    return spec.replace(layers=tuple(
        dataclasses.replace(l, dropout=dp(dropout_ratio=0.0))
        if l.type == "Dropout" else l for l in spec.layers))


def jax_net(name, **kw):
    """(JAX CompiledNet, port CompiledNet) of a dropout-free zoo net."""
    spec = dropout_free(getattr(jax_zoo, name)(**kw))
    return JaxCompiledNet.compile(spec), CompiledNet.compile(
        to_port_spec(spec))


def jax_params(jnet, seed=0):
    return jax.tree_util.tree_map(
        np.asarray, jnet.init_params(jax.random.PRNGKey(seed)))


def make_batch(net, scale=1.0, seed=0, n=None):
    r = np.random.default_rng(seed)
    out = {}
    for name, shape in net.input_shapes.items():
        shape = ((n,) + tuple(shape[1:])) if n else shape
        if net.input_dtypes[name] == "int32":
            out[name] = r.integers(0, 10, shape).astype(np.int32)
        else:
            out[name] = (scale * r.standard_normal(shape)).astype(np.float32)
    return out


def objective(blobs, proj):
    """The net's loss; adult_mlp has none, so a fixed projection of its
    prob (the same numpy `proj` on both sides)."""
    if "loss" in blobs:
        return blobs["loss"]
    return (blobs["prob"] * proj).sum()


def port_grads(tnet, jp, batch, ops=None, proj=None):
    params = params_from_jax(tnet, jp, CPU)
    for lp in params.values():
        for w in lp.values():
            w.requires_grad_(True)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    p = None if proj is None else torch.from_numpy(proj)

    def loss_fn(params, batch, generator=None):
        blobs = tnet.apply(params, batch, train=True, generator=generator,
                           ops=ops)
        return objective(blobs, p), blobs

    loss, grads = value_and_grad(loss_fn, params, tb)
    return float(loss), params_to_jax(tnet, grads)


def assert_grads_close(got, want):
    for l in want:
        for p in want[l]:
            a, b = got[l][p], np.asarray(want[l][p])
            err = np.abs(a - b).max()
            assert err <= 1e-4 * np.abs(b).max() + 1e-7, (l, p, err)


@pytest.mark.parametrize("name,lrn_path",
                         [(n, "fused") for n in sorted(NETS)]
                         + [("caffenet", "pallas")])  # the LRN-bearing net
def test_every_gradient_matches_jax_grad(name, lrn_path):
    kw, scale = NETS[name]
    jnet, tnet = jax_net(name, **kw)
    jp = jax_params(jnet)
    batch = make_batch(jnet, scale)
    jops = (JaxOpsImpl(lrn="pallas", interpret=True) if lrn_path == "pallas"
            else JaxOpsImpl(lrn="fused"))
    proj = np.random.default_rng(9).standard_normal(
        jnet.blob_shapes["prob"]).astype(np.float32)
    jloss, jgrads = jax.value_and_grad(
        lambda p: objective(jnet.apply(
            p, {k: jnp.asarray(v) for k, v in batch.items()}, train=True,
            rng=jax.random.PRNGKey(0), ops=jops), jnp.asarray(proj)))(jp)
    loss, grads = port_grads(tnet, jp, batch, proj=proj)
    assert abs(loss - float(jloss)) <= 1e-5 * abs(float(jloss))
    assert_grads_close(grads, jgrads)


def test_kernel_route_and_plain_route_agree_on_cpu():
    """On CPU tensors "auto" takes the plain versions: identical grads."""
    _, tnet = jax_net("caffenet", batch=2, crop=67, n_classes=16)
    jp = jax_params(JaxCompiledNet.compile(dropout_free(
        jax_zoo.caffenet(batch=2, crop=67, n_classes=16))))
    batch = make_batch(tnet, 50.0)
    _, a = port_grads(tnet, jp, batch)
    _, b = port_grads(tnet, jp, batch, OpsImpl(lrn="plain", pool="plain"))
    for l in a:
        for p in a[l]:
            assert np.array_equal(a[l][p], b[l][p])


# -- the solver ----------------------------------------------------------

SOLVERS = {
    "fixed": dict(lr_policy="fixed"),
    "step": dict(lr_policy="step", gamma=0.5, stepsize=5),
    "exp": dict(lr_policy="exp", gamma=0.95),
    "inv": dict(lr_policy="inv", gamma=0.01, power=0.75),
    "multistep": dict(lr_policy="multistep", gamma=0.3,
                      stepvalue=(3, 10, 15)),
    "poly": dict(lr_policy="poly", power=0.9, max_iter=40),
    "sigmoid": dict(lr_policy="sigmoid", gamma=-0.5, stepsize=10),
    "bf16_velocity": dict(lr_policy="fixed", velocity_dtype="bfloat16"),
}


def _ulps(a, b):
    """Largest distance between a and b in f32 ulps of b's largest
    magnitude."""
    b = np.asarray(b, np.float32)
    _, e = np.frexp(np.abs(b).max())
    return (np.abs(np.asarray(a, np.float64) - b).max()
            / np.ldexp(1.0, int(e) - 24))


def _with_multipliers(spec, pkg):
    """cifar10_quick with conv2's lr_mult/decay_mult set apart."""
    ps = JaxParamSpec if pkg == "jax" else tspec.ParamSpec
    return spec.replace(layers=tuple(
        dataclasses.replace(l, params=(ps(lr_mult=0.5, decay_mult=3.0),
                                       ps(lr_mult=4.0, decay_mult=0.0)))
        if l.name == "conv2" else l for l in spec.layers))


# lr_scale multiplies whatever the policy gives: two policies suffice
@pytest.mark.parametrize("policy,lr_scale",
                         [(p, 1.0) for p in sorted(SOLVERS)]
                         + [("fixed", 0.5), ("step", 0.5)])
def test_update_matches_jax_over_20_steps(policy, lr_scale):
    kw = dict(base_lr=0.05, momentum=0.9, weight_decay=0.004,
              **SOLVERS[policy])
    jspec = _with_multipliers(jax_zoo.cifar10_quick(batch=2), "jax")
    jnet = JaxCompiledNet.compile(jspec)
    tnet = CompiledNet.compile(_with_multipliers(zoo.cifar10_quick(batch=2),
                                                 "port"))
    jsolver = JaxSgdSolver(jnet, JaxSolverConfig(**kw))
    tsolver = SgdSolver(tnet, SolverConfig(**kw))
    jp = jax.tree_util.tree_map(jnp.asarray, jax_params(jnet))
    jstate = jsolver.init_state(jp)
    tp = params_from_jax(tnet, jax_params(jnet), CPU)
    tstate = tsolver.init_state(tp)
    r = np.random.default_rng(1)
    for _ in range(20):
        g = {l: {p: r.standard_normal(v.shape).astype(np.float32)
                 for p, v in lp.items()} for l, lp in jp.items()}
        jp, jstate = jsolver.update(jp, jstate,
                                    jax.tree_util.tree_map(jnp.asarray, g),
                                    lr_scale=lr_scale)
        tp, tstate = tsolver.update(tp, tstate, params_from_jax(tnet, g, CPU),
                                    lr_scale=lr_scale)
    assert tstate.it == int(jstate.it) == 20
    got_p = params_to_jax(tnet, tp)
    got_v = params_to_jax(tnet, tstate.momentum)
    for l in got_p:
        for p in got_p[l]:
            assert _ulps(got_p[l][p], np.asarray(jp[l][p])) <= 4, (l, p)
            want_v = np.asarray(jstate.momentum[l][p]).astype(np.float32)
            assert tstate.momentum[l][p].dtype == getattr(
                torch, kw.get("velocity_dtype", "float32"))
            assert _ulps(got_v[l][p], want_v) <= 4 * (
                1 if "velocity_dtype" not in kw else 2 ** 16), (l, p)


@pytest.mark.parametrize("policy", sorted(SOLVERS))
def test_learning_rate_matches_jax(policy):
    from sparknet_tpu.solver import learning_rate as jax_lr
    cfg = dict(base_lr=0.05, **SOLVERS[policy])
    for it in (0, 1, 4, 5, 9, 10, 11, 16, 39):
        want = float(jax_lr(JaxSolverConfig(**cfg), jnp.asarray(it)))
        got = learning_rate(SolverConfig(**cfg), it)
        assert got.dtype == torch.float32
        assert _ulps(float(got), np.float32(want)) <= 1, (it, float(got),
                                                          want)


def test_iter_size_accumulation_matches_jax():
    """iter_size = 2: two micro-batches' grads averaged, one update."""
    kw = dict(base_lr=0.05, momentum=0.9, weight_decay=0.004, iter_size=2)
    jspec = jax_zoo.lenet(batch=2)
    jn = JaxNet(jspec, seed=0, solver=JaxSolverConfig(**kw))
    tn = TorchNet(to_port_spec(jspec), device="cpu",
                  solver=SolverConfig(**kw))
    tn.load_jax_params(jax_params(jn.net))
    jn.params = jax.tree_util.tree_map(jnp.asarray, jax_params(jn.net))
    jn.solver_state = jn.solver.init_state(jn.params)
    for i in range(3):
        batch = make_batch(jn.net, seed=i, n=4)
        a, b = tn.step(batch), jn.step(batch)
        assert abs(a - b) <= 1e-5 * abs(b)
    assert_grads_close(params_to_jax(tn.net, tn.params),
                       jax.tree_util.tree_map(np.asarray, jn.params))


def test_torchnet_step_and_forward_backward_match_jaxnet():
    kw = dict(base_lr=0.01, momentum=0.9, weight_decay=0.0005)
    jspec = dropout_free(jax_zoo.caffenet(batch=2, crop=67, n_classes=16))
    jn = JaxNet(jspec, seed=0, solver=JaxSolverConfig(**kw))
    tn = TorchNet(to_port_spec(jspec), device="cpu",
                  solver=SolverConfig(**kw))
    tn.load_jax_params(jax_params(jn.net))
    batch = make_batch(jn.net, 50.0, seed=3)
    jg = jn.forward_backward(batch)
    assert_grads_close(params_to_jax(tn.net, tn.forward_backward(batch)), jg)
    for i in range(3):
        b = make_batch(jn.net, 50.0, seed=10 + i)
        a, w = tn.step(b), jn.step(b)
        assert abs(a - w) <= 1e-5 * abs(w), (i, a, w)
    got = params_to_jax(tn.net, tn.params)
    for l in got:
        for p in got[l]:
            want = np.asarray(jn.params[l][p])
            assert np.abs(got[l][p] - want).max() <= \
                1e-5 * np.abs(want).max() + 1e-7, (l, p)
    with pytest.raises(ValueError, match="solver="):
        TorchNet(to_port_spec(jspec), device="cpu").step(batch)


def test_fifty_iterations_track_the_numpy_oracle():
    """cifar10_quick, the recipe's solver (lr 0.001, momentum 0.9, wd
    0.004, lr_mult 1/2), batch 20, against tests/numpy_oracle.py."""
    B, ITERS = 20, 50
    spec = zoo.cifar10_quick(batch=B)
    tn = TorchNet(spec, device="cpu", solver=SolverConfig(
        base_lr=0.001, momentum=0.9, weight_decay=0.004))
    jnet = JaxCompiledNet.compile(jax_zoo.cifar10_quick(batch=B))
    np_params = jax_params(jnet)
    tn.load_jax_params(np_params)
    np_params = {l: {p: v.copy() for p, v in lp.items()}
                 for l, lp in np_params.items()}
    mean = synth.mean_image(seed=0)
    imgs, labels = synth.synthetic_cifar(B * ITERS, seed=0)
    nhwc = np.ascontiguousarray((imgs - mean).transpose(0, 2, 3, 1))
    velocity = {l: {p: np.zeros_like(v) for p, v in lp.items()}
                for l, lp in np_params.items()}

    def param_dev():
        got = params_to_jax(tn.net, tn.params)
        return max(np.linalg.norm(got[l][p] - np_params[l][p])
                   / max(np.linalg.norm(np_params[l][p]), 1e-12)
                   for l in np_params for p in np_params[l])

    for i in range(ITERS):
        x, y = nhwc[i * B:(i + 1) * B], labels[i * B:(i + 1) * B]
        loss = tn.step({"data": x, "label": y[:, None]})
        np_loss, grads = orc.forward_backward(np_params, x, y)
        orc.sgd_update(np_params, velocity, grads, 0.001, 0.9, 0.004)
        band = 1e-4 if i < 10 else 0.20
        assert abs(loss - np_loss) <= band * abs(np_loss), (i, loss, np_loss)
        if i + 1 == 10:
            assert param_dev() < 0.08
    assert param_dev() < 0.25


# -- dropout -------------------------------------------------------------

def _dropout(ratio, x, seed=0, name="drop6", train=True):
    layer = tspec.LayerSpec(name=name, type="Dropout", bottoms=("x",),
                            tops=("x",),
                            dropout=tspec.DropoutParam(dropout_ratio=ratio))
    ctx = ApplyCtx(train=train,
                   generator=torch.Generator().manual_seed(seed))
    return apply_dropout(layer, None, (x,), ctx)[0]


def test_dropout_keeps_one_minus_ratio_scaled_by_inverse_keep():
    x = torch.full((400, 500), 3.0)
    for ratio in (0.5, 0.25):
        y = _dropout(ratio, x)
        kept = y != 0
        keep = 1.0 - ratio
        frac = kept.float().mean().item()
        # 200k Bernoulli draws: 5 sigma is < 0.006
        assert abs(frac - keep) < 5 * np.sqrt(keep * ratio / x.numel())
        assert torch.all(y[kept] == torch.tensor(3.0 / keep))
    assert torch.equal(_dropout(0.5, x, seed=4), _dropout(0.5, x, seed=4))
    assert not torch.equal(_dropout(0.5, x, seed=4), _dropout(0.5, x, 5))
    assert not torch.equal(_dropout(0.5, x), _dropout(0.5, x, name="drop7"))
    assert torch.equal(_dropout(0.5, x, train=False), x)
    assert torch.equal(_dropout(0.0, x), x)
    with pytest.raises(ValueError, match="generator"):
        layer = tspec.LayerSpec(name="d", type="Dropout", bottoms=("x",),
                                tops=("x",))
        apply_dropout(layer, None, (x,), ApplyCtx(train=True))


def test_train_phase_runs_dropout_and_masks_follow_the_generator():
    tn = TorchNet(zoo.caffenet(batch=2, crop=67, n_classes=16),
                  device="cpu")
    batch = {k: torch.from_numpy(v)
             for k, v in make_batch(tn.net, 50.0).items()}

    def fc7(seed, train=True):
        with torch.no_grad():
            return tn.net.apply(tn.params, batch, train=train,
                                generator=torch.Generator().manual_seed(seed)
                                )["fc7"]
    assert torch.equal(fc7(1), fc7(1))
    assert not torch.equal(fc7(1), fc7(2))
    assert torch.equal(fc7(1, train=False), fc7(2, train=False))
