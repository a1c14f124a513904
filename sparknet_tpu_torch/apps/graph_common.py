"""Shared plumbing of the serialized-graph apps (graph_mnist_app,
graph_imagenet_app): graph-file dispatch, input-shape validation and the
GraphTrainer loop wiring — the counterpart of
`sparknet_tpu/apps/graph_common.py` (the reference's `apps/MnistApp.scala`
and `apps/TFImageNetApp.scala` pairings)."""
from __future__ import annotations

from typing import Callable, Optional, Tuple

from .. import precision
from ..backend import GraphDef, GraphNet
from ..backend.tf_import import import_tf_graphdef_file
from ..parallel.graph_trainer import GraphTrainer
from ..parallel.mesh import init_data_group
from ..utils.config import RunConfig
from ..utils.logger import Logger, default_logger
from .train_loop import check_config, run_loop


def load_graph(path: Optional[str],
               default_builder: Optional[Callable[[], GraphDef]]
               ) -> GraphDef:
    """`None` -> build natively; `.pb` -> frozen TF GraphDef import;
    anything else -> portable GraphDef JSON."""
    if path is None:
        return default_builder()
    if path.endswith(".pb"):
        return import_tf_graphdef_file(path)
    return GraphDef.load(path)


def check_input_shape(net: GraphNet, field: str,
                      expect: Tuple[int, ...]) -> None:
    """Fail fast (and name the knob) when the graph's placeholder disagrees
    with the data pipeline's per-example shape — otherwise the mismatch
    surfaces as a bare matmul shape error deep inside a round that never
    mentions e.g. `crop`."""
    shapes = net.input_shapes()
    if field not in shapes:
        # graph uses a different input name — GraphNet's own "batch missing
        # graph input" validation will name the real inputs at run time
        return
    got = shapes[field][1:]  # drop the batch dim
    if got and got != tuple(expect):
        raise ValueError(
            f"graph input {field!r} expects per-example shape {got} but the "
            f"data pipeline produces {tuple(expect)} — check crop/model "
            f"settings against the graph (a natively built alexnet graph "
            f"is fixed at 227x227x3)")


def train_graph(cfg: RunConfig, graph: GraphDef, train_ds, test_ds=None,
                logger: Optional[Logger] = None, batch_transform=None,
                eval_transform=None,
                expect_data_shape: Optional[Tuple[int, ...]] = None,
                device=None, round_hook=None, prefetch: bool = True):
    """The reference graph-backend loop: GraphNet -> data group ->
    GraphTrainer -> the shared `run_loop` driver, on this process's card
    (default cuda; `device="cpu"` for the CPU). Joins the process group a
    caller formed, else forms (and ends) a world of one. Returns this
    rank's final state."""
    log = logger or default_logger(cfg.workdir)
    levers = check_config(cfg)
    precision.set_policy(cfg.precision)
    group = init_data_group(device, workdir=cfg.workdir)
    try:
        if cfg.n_devices is not None and cfg.n_devices != group.size:
            raise ValueError(f"n_devices={cfg.n_devices}, but the data "
                             f"group has {group.size} ranks (one per card)")
        net = GraphNet(graph, seed=cfg.seed, device=group.device)
        if expect_data_shape is not None:
            check_input_shape(net, "data", expect_data_shape)
        trainer = GraphTrainer(net, group, tau=cfg.tau,
                               compute_health=(cfg.health is not None
                                               and cfg.health.enabled),
                               donate_batches=cfg.donate_batches)
        log.log(f"graph backend: {len(net.variable_names)} variables; "
                f"rank {group.rank} of {group.size} on {group.device}; "
                f"tau={cfg.tau} local_batch={cfg.local_batch} "
                f"precision={cfg.precision}")
        if levers:
            log.log(f"accepted, not yet ported (no effect on the numbers): "
                    f"{', '.join(levers)}")
        return run_loop(cfg, trainer, train_ds, test_ds, log,
                        batch_transform=batch_transform,
                        eval_transform=eval_transform,
                        round_hook=round_hook, prefetch=prefetch)
    finally:
        group.close()
