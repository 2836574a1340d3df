"""Start the ranks of one ``torch.distributed`` group as processes of this
machine, wait for them under a time limit, and fail if any rank fails.

Nothing on a single machine tells a program of a cluster, so each rank is
given its address (``tcp://localhost:<port>``, a free port picked here),
its rank and the world size on its command line; the rank's own code calls
``init_process_group`` with them."""

from __future__ import annotations

import socket
import subprocess
import sys
import time
from pathlib import Path


class RankFailed(RuntimeError):
    """A rank exited non-zero or was killed at the time limit."""


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run_ranks(argv, world: int, log_dir, timeout_s: float, cwd=None):
    """Run ``python <argv(rank, port)>`` for ranks ``0 … world-1`` at once,
    each with its output in ``log_dir/rank_<r>.log``; wait for all, killing
    any still running after ``timeout_s`` seconds. Raises
    :class:`RankFailed` with the failing rank's log tail unless every rank
    exits 0."""
    log_dir = Path(log_dir)
    port = free_port()
    procs, logs = [], []
    try:
        for r in range(world):
            log = open(log_dir / f"rank_{r}.log", "w")
            logs.append(log)
            procs.append(subprocess.Popen([sys.executable, *map(str, argv(r, port))],
                                          cwd=cwd, stdout=log, stderr=subprocess.STDOUT))
        deadline = time.time() + timeout_s
        for p in procs:
            p.wait(timeout=max(deadline - time.time(), 1.0))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for log in logs:
            log.close()
    for r, p in enumerate(procs):
        if p.returncode != 0:
            tail = (log_dir / f"rank_{r}.log").read_text()[-4000:]
            raise RankFailed(f"rank {r} of {world} exited {p.returncode}:\n{tail}")
