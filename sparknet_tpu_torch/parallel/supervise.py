"""The relaunch supervisor: run a training command until it finishes,
relaunching it at every elastic membership change.

The counterpart of `scripts/tpu_pod_launch.sh watch` (its l.292-360),
without the VM recreation (the port's supervisor runs on a machine that
is already there):

    python -m sparknet_tpu_torch.parallel.supervise [--nproc N] \\
        [--nnodes M --node-rank R --master-addr HOST --master-port PORT] \\
        [--progress-secs 900] [--poll-secs 60] -- COMMAND ...

Launch. COMMAND starts as N rank processes on this machine, one per card,
each with torchrun's environment: RANK = R·N + l, WORLD_SIZE = M·N,
LOCAL_RANK = l, LOCAL_WORLD_SIZE = N, MASTER_ADDR, MASTER_PORT. A world
of one machine rendezvous on 127.0.0.1 at a free port taken anew at every
launch; a world of several machines runs one supervisor per machine, each
given the same --master-addr (machine 0's) and --master-port. A rank that
fails (an exit code other than 0 and 75) stops the others on this
machine; ranks that exit 0 or 75 are waited for, so the one still
committing the boundary checkpoint finishes it.

Exits.
  - 0 on every rank: done; the supervisor exits 0.
  - 75 (`ELASTIC_RELAUNCH_EXIT`, on any rank, none failing): the
    membership changed. Relaunch at once, with no strike, and reset the
    strike count. The relaunched command resumes from the checkpoint
    store at the new size ($SPARKNET_ELASTIC_RELAUNCH=1 marks it, so the
    loop logs the elastic resume).
  - anything else: a failure. After a run of at least --progress-secs it
    is no strike (the checkpoint resume makes the retry a continuation);
    otherwise it is a strike, and two consecutive strikes stop the
    supervisor with exit 1. It waits --poll-secs before each retry.
It prints one line per launch and a summary: launches, relaunches,
strikes and the final code.

How the new size is decided. Every launch gets $SPARKNET_RELAUNCH_RECORD,
a file of the supervisor's: before it exits 75, the train loop's local
rank 0 of each machine writes there the membership that the resize
decision left behind (`parallel/elastic.py:write_relaunch_record`) — the
new members, the previous ones, and the old world (ranks, machines, this
machine's index). From it:
  - over several machines a member is a machine: the new world is the
    surviving machines, each with its N local ranks, in the order of
    their ids (this machine's node rank is its place among them; machine
    0, the one that decides, always stays node 0 and keeps the master
    address). A machine that is no longer a member stops its supervisor
    with exit 75: the run goes on without it;
  - on one machine the members own equal blocks of ranks: each member
    held max(1, old ranks // old members) ranks, and the new world is the
    new members times that, at most --nproc (the cards this machine
    has). A world of one rank watching a nominal second worker stays one
    rank;
  - without a record (a command that exits 75 by itself) the world keeps
    its size.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import socket
import subprocess
import sys
import tempfile
import time
from typing import Callable, Dict, List, Optional

from .elastic import (ELASTIC_RELAUNCH_EXIT, RELAUNCH_RECORD_ENV,
                      RELAUNCHED_ENV)


def free_port() -> int:
    """A TCP port nothing on this machine listens on right now."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class Supervisor:
    """Launch, watch and relaunch one command (module docstring)."""

    def __init__(self, command: List[str], nproc: int = 1, nnodes: int = 1,
                 node_rank: int = 0, master_addr: str = "127.0.0.1",
                 master_port: Optional[int] = None,
                 progress_secs: float = 900.0, poll_secs: float = 60.0,
                 echo: Callable[[str], None] = print):
        if not command:
            raise ValueError("no command to supervise")
        if nproc < 1 or nnodes < 1 or not 0 <= node_rank < nnodes:
            raise ValueError(f"nproc={nproc}, nnodes={nnodes}, node_rank="
                             f"{node_rank}: need nproc >= 1 and 0 <= "
                             f"node_rank < nnodes")
        if nnodes > 1 and master_port is None:
            raise ValueError("a world of several machines needs "
                             "--master-addr and --master-port")
        self.command = list(command)
        self.max_nproc = self.nproc = int(nproc)
        self.nnodes, self.node_rank = int(nnodes), int(node_rank)
        self.master_addr, self.master_port = master_addr, master_port
        self.progress_secs = float(progress_secs)
        self.poll_secs = float(poll_secs)
        self.echo = echo
        self.launches = self.relaunches = self.strikes = 0

    # -- one launch ----------------------------------------------------------

    def _env(self, rank: int, local_rank: int, port: int, record: str,
             relaunched: bool) -> Dict[str, str]:
        env = dict(os.environ)
        env.update(RANK=str(rank), WORLD_SIZE=str(self.nnodes * self.nproc),
                   LOCAL_RANK=str(local_rank),
                   LOCAL_WORLD_SIZE=str(self.nproc),
                   MASTER_ADDR=(self.master_addr if self.nnodes > 1
                                else "127.0.0.1"),
                   MASTER_PORT=str(port))
        env[RELAUNCH_RECORD_ENV] = record
        if relaunched:
            env[RELAUNCHED_ENV] = "1"
        else:
            env.pop(RELAUNCHED_ENV, None)
        return env

    def launch(self, record: str, relaunched: bool) -> int:
        """Run the command's ranks on this machine to their end; returns
        the launch's code: the first failure's, else 75 when any rank
        asked for a relaunch, else 0."""
        port = self.master_port if self.nnodes > 1 else free_port()
        procs: List[subprocess.Popen] = []
        failed: Optional[int] = None
        try:
            for l in range(self.nproc):
                procs.append(subprocess.Popen(self.command, env=self._env(
                    self.node_rank * self.nproc + l, l, port, record,
                    relaunched)))
            while any(p.poll() is None for p in procs):
                for p in procs:
                    code = p.poll()
                    if code not in (None, 0, ELASTIC_RELAUNCH_EXIT) and \
                            failed is None:
                        failed = code
                        for q in procs:  # a failed rank stops its peers
                            if q.poll() is None:
                                q.terminate()
                time.sleep(0.05)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.terminate()
                try:
                    p.wait(timeout=30)
                except subprocess.TimeoutExpired:
                    p.kill()
                    p.wait()
        codes = [p.returncode for p in procs]
        if failed is not None:
            return failed
        bad = [c for c in codes if c not in (0, ELASTIC_RELAUNCH_EXIT)]
        if bad:
            return bad[0]
        return ELASTIC_RELAUNCH_EXIT if ELASTIC_RELAUNCH_EXIT in codes else 0

    # -- the new size --------------------------------------------------------

    def resize(self, rec: Optional[dict]) -> bool:
        """Size the next launch from a relaunch record (module docstring);
        False when this machine is no longer a member."""
        if rec is None:
            return True
        members = [str(m) for m in rec["members"]]
        if int(rec["n_machines"]) > 1:
            me = str(rec["machine"])
            if me not in members:
                return False
            order = sorted(members, key=int)
            self.nnodes, self.node_rank = len(order), order.index(me)
            return True
        per = max(1, int(rec["world"]) // max(1, len(rec["previous"])))
        self.nproc = min(self.max_nproc, max(1, len(members) * per))
        return True

    # -- the watch loop ------------------------------------------------------

    def run(self) -> int:
        """Supervise until done, two consecutive fast failures, or this
        machine leaving the membership; returns the supervisor's code."""
        tmp = tempfile.mkdtemp(prefix="sparknet_supervise_")
        consecutive, relaunched, final = 0, False, 1
        try:
            while True:
                self.launches += 1
                record = os.path.join(tmp, f"relaunch-{self.launches}.json")
                world = f"{self.nnodes * self.nproc} rank(s) ({self.nnodes} " \
                    f"machine(s) x {self.nproc}), node {self.node_rank}"
                t0 = time.monotonic()
                code = self.launch(record, relaunched)
                secs = time.monotonic() - t0
                self.echo(f"supervise: launch {self.launches}: {world}: exit "
                          f"{code} after {secs:.1f}s")
                relaunched = False
                if code == 0:
                    final = 0
                    break
                if code == ELASTIC_RELAUNCH_EXIT:
                    self.relaunches += 1
                    consecutive = 0
                    rec = None
                    if os.path.exists(record):
                        with open(record) as f:
                            rec = json.load(f)
                    if not self.resize(rec):
                        self.echo(f"supervise: machine {rec['machine']} is "
                                  f"not in membership epoch {rec['epoch']} "
                                  f"({rec['members']}): the run goes on "
                                  f"without it; stopping")
                        final = ELASTIC_RELAUNCH_EXIT
                        break
                    self.echo(f"supervise: exit 75 (elastic membership "
                              f"change"
                              + (f", epoch {rec['epoch']}: members "
                                 f"{rec['members']}" if rec else
                                 ", no membership record")
                              + f"); relaunching now at "
                              f"{self.nnodes * self.nproc} rank(s), no "
                              f"strike")
                    relaunched = True
                    continue
                if secs >= self.progress_secs:
                    consecutive = 0
                    self.echo(f"supervise: failed after {secs:.1f}s of "
                              f"progress: no strike; retrying in "
                              f"{self.poll_secs:g}s")
                else:
                    self.strikes += 1
                    consecutive += 1
                    if consecutive >= 2:
                        self.echo("supervise: two fast failures in a row — "
                                  "an error of the command, not of the "
                                  "machine; stopping")
                        final = 1
                        break
                    self.echo(f"supervise: fast failure (strike "
                              f"{consecutive} of 2); retrying in "
                              f"{self.poll_secs:g}s")
                time.sleep(self.poll_secs)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        self.echo(f"supervise: launches {self.launches}, relaunches "
                  f"{self.relaunches}, strikes {self.strikes}, code {final}")
        return final


def main(argv: Optional[List[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if "--" not in argv:
        raise SystemExit("usage: python -m sparknet_tpu_torch.parallel."
                         "supervise [options] -- COMMAND ...")
    cut = argv.index("--")
    p = argparse.ArgumentParser(
        prog="python -m sparknet_tpu_torch.parallel.supervise",
        description="Run COMMAND as N ranks; relaunch it at exit 75.")
    p.add_argument("--nproc", type=int, default=1,
                   help="rank processes on this machine, one per card")
    p.add_argument("--nnodes", type=int, default=1,
                   help="machines in the world (one supervisor each)")
    p.add_argument("--node-rank", type=int, default=0)
    p.add_argument("--master-addr", default="127.0.0.1")
    p.add_argument("--master-port", type=int, default=None)
    p.add_argument("--progress-secs", type=float, default=900.0,
                   help="a failure after this long is no strike")
    p.add_argument("--poll-secs", type=float, default=60.0,
                   help="wait before retrying a failure")
    a = p.parse_args(argv[:cut])
    sup = Supervisor(argv[cut + 1:], nproc=a.nproc, nnodes=a.nnodes,
                     node_rank=a.node_rank, master_addr=a.master_addr,
                     master_port=a.master_port,
                     progress_secs=a.progress_secs, poll_secs=a.poll_secs,
                     echo=lambda m: print(m, flush=True))
    return sup.run()


if __name__ == "__main__":
    sys.exit(main())
