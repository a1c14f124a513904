"""One rank of a four-rank world laid out as two machines of two ranks, for
tests/test_torch_multimachine.py. It imports torch and the port only: the
test spawns it with torch.multiprocessing; it sets torchrun's topology
variables (RANK, WORLD_SIZE, LOCAL_RANK, LOCAL_WORLD_SIZE), joins a gloo
group through a FileStore, starts from the given params and writes what
the test compares to `<out>/rank<r>.pkl`:
- streaming (`--stream always`): the app's mean image, its val set after
  the eval agreement, three raw rounds and their cursors from the rank's
  source, then two trained rounds with checkpoints in `<out>/ck_stream`;
- cached (`--stream never`): the mean image and two trained rounds with
  checkpoints in `<out>/ck_cached`; each rank's losses in its workdir;
- the CIFAR, MNIST and adult apps' `main()`: the datasets each hands
  `train()` (the machine's share); CIFAR then trains two rounds from the
  given params with checkpoints in `<out>/ck_cifar`, its losses and test
  accuracies in `<out>/cifar_w<r>`.
`cifar_to`: the CIFAR app's two rounds again from the given params, with
the default checkpoint layout, into the given checkpoint directory (a
bucket); nothing else.
"""
import argparse
import dataclasses
import os
import pickle

import torch

from sparknet_tpu_torch.apps import adult_app, cifar_app, imagenet_app
from sparknet_tpu_torch.apps import mnist_app
from sparknet_tpu_torch.apps.train_loop import resolve_spec, train
from sparknet_tpu_torch.parallel.mesh import init_data_group, machine_topology
from sparknet_tpu_torch.parallel.trainer import ParallelTrainer


def _args(data_dir, *argv):
    p = argparse.ArgumentParser()
    imagenet_app.add_data_args(p)
    return p.parse_args(["--data-dir", data_dir, *argv])


def _train(cfg, data_dir, mode, out_dir, name, rank):
    cfg = dataclasses.replace(
        cfg, workdir=os.path.join(out_dir, f"{name}_w{rank}"),
        checkpoint_dir=os.path.join(out_dir, f"ck_{name}"))
    src, test_ds, pp, pp_eval, _ = imagenet_app.prepare_data(
        cfg, _args(data_dir, "--stream", mode), group=_train.group)
    spec = resolve_spec(cfg, data=(cfg.local_batch, 3, cfg.crop, cfg.crop),
                        label=(cfg.local_batch, 1))
    try:
        train(cfg, spec, src, test_ds, batch_transform=pp,
              eval_transform=pp_eval, device="cpu")
    finally:
        if hasattr(src, "close"):
            src.close()
    return pp.mean_image


def _start_from(params):
    start = {l: {p: torch.from_numpy(v) for p, v in lp.items()}
             for l, lp in params.items()}
    ParallelTrainer.init_state = \
        lambda self, seed=0: self.state_from_params(start)


def _app_datasets(app, argv, trains):
    """The (train, test) arrays `app.main(argv)` hands `train()`; the
    real `train()` runs after only when `trains`."""
    real, seen = app.train, {}

    def capture(cfg, spec, train_ds, test_ds, **kw):
        seen.update(train=dict(train_ds.arrays), test=dict(test_ds.arrays))
        return real(cfg, spec, train_ds, test_ds, **kw) if trains else None

    app.train = capture
    try:
        app.main(argv)
    finally:
        app.train = real
    return seen


def run(rank, world, local_size, store_path, params, data_dir, overrides,
        out_dir, apps):
    torch.set_num_threads(1)
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank % local_size),
                      LOCAL_WORLD_SIZE=str(local_size))
    _start_from(params)
    group = _train.group = init_data_group("cpu", store_path=store_path,
                                           rank=rank, world_size=world)
    out = {"topology": machine_topology(group)}
    try:
        cfg = imagenet_app.default_config().with_overrides(
            f"data_dir={data_dir}", *overrides)
        src, test_ds, pp, _, info = imagenet_app.prepare_data(
            cfg, _args(data_dir, "--stream", "always"), group=group)
        with src:
            out["stream_rounds"] = [
                {k: v.copy() for k, v in
                 src.next_round(round_index=r).items()} for r in range(3)]
            out["stream_cursors"] = [src.cursor_at(r) for r in range(3)]
        out["stream_mean"] = pp.mean_image
        out["readers"] = [l.shard_paths for l in getattr(
            src, "loaders", [getattr(src, "loader", None)])]
        out["test"] = None if test_ds is None else dict(test_ds.arrays)
        _train(cfg, data_dir, "always", out_dir, "stream", rank)
        out["cached_mean"] = _train(cfg, data_dir, "never", out_dir,
                                    "cached", rank)
        _start_from(apps["cifar_params"])
        out["cifar"] = _app_datasets(cifar_app, [
            "--device", "cpu", "--data-dir", apps["cifar"],
            *apps["cifar_overrides"],
            f"workdir={os.path.join(out_dir, f'cifar_w{rank}')}",
            f"checkpoint_dir={os.path.join(out_dir, 'ck_cifar')}"], True)
        out["mnist"] = _app_datasets(mnist_app, [
            "--device", "cpu", "--data-dir", apps["mnist"]], False)
        out["adult"] = _app_datasets(adult_app, [
            "--device", "cpu", "--data", apps["adult"]], False)
    finally:
        group.close()
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


def cifar_to(rank, world, local_size, store_path, params, cifar_dir,
             overrides, ckdir, out_dir):
    torch.set_num_threads(1)
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank % local_size),
                      LOCAL_WORLD_SIZE=str(local_size))
    _start_from(params)
    group = init_data_group("cpu", store_path=store_path, rank=rank,
                            world_size=world)
    try:
        cifar_app.main(["--device", "cpu", "--data-dir", cifar_dir,
                        *overrides, f"checkpoint_dir={ckdir}",
                        f"workdir={os.path.join(out_dir, f'to_w{rank}')}"])
    finally:
        group.close()
