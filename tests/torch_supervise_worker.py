"""One rank of a supervised elastic run, for tests/test_torch_supervise.py.
The relaunch supervisor starts it as a command,

    python -m sparknet_tpu_torch.parallel.supervise ... -- \\
        python tests/torch_supervise_worker.py SPEC.pkl

with torchrun's environment (RANK, WORLD_SIZE, LOCAL_RANK,
LOCAL_WORLD_SIZE, MASTER_ADDR, MASTER_PORT). It imports torch and the
port only. SPEC holds the net, the params every rank starts from, the
data, the output directory and two runs: "first", and "relaunch" for a
launch that follows an exit 75 ($SPARKNET_ELASTIC_RELAUNCH). Each is
`train()` of `tests/torch_elastic_worker.py`'s loop with the run's round
hook; an ElasticRelaunch leaves the process with exit code 75, a finished
run writes its state to `<out>/<name>_rank<r>.pkl` and exits 0.
"""
import os
import pickle
import sys

import torch

import torch_elastic_worker as w
from sparknet_tpu_torch.apps.train_loop import train
from sparknet_tpu_torch.data.dataset import ArrayDataset
from sparknet_tpu_torch.model.prototxt import net_from_prototxt
from sparknet_tpu_torch.parallel.elastic import RELAUNCHED_ENV
from sparknet_tpu_torch.parallel.trainer import ParallelTrainer
from sparknet_tpu_torch.utils.config import RunConfig
from sparknet_tpu_torch.utils.logger import Logger


def main(spec_path):
    with open(spec_path, "rb") as f:
        spec = pickle.load(f)
    torch.set_num_threads(1)
    rank = int(os.environ["RANK"])
    start = w._tensors(spec["params"])
    ParallelTrainer.init_state = \
        lambda self, seed=0: self.state_from_params(start)
    run = spec["relaunch" if os.environ.get(RELAUNCHED_ENV) == "1"
               else "first"]
    cfg = RunConfig(**run["cfg"])
    os.makedirs(cfg.workdir, exist_ok=True)
    log = Logger(os.path.join(cfg.workdir, f"l{rank}.txt"), echo=False,
                 jsonl_path=os.path.join(cfg.workdir, f"m{rank}.jsonl"))
    try:
        state = train(cfg, net_from_prototxt(spec["net"]),
                      ArrayDataset(spec["data"]), None, logger=log,
                      round_hook=w._hook(run["plan"], rank, cfg.pod_dir),
                      device="cpu")
    finally:
        log.close()
    w._save(spec["out"], run["name"], rank,
            {"end": "done", "state": w._numpy_state(state)})


if __name__ == "__main__":
    main(sys.argv[1])
