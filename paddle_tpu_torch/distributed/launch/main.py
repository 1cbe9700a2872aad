"""The launcher (``paddle_tpu/distributed/launch/main.py``), one node.

    python -m paddle_tpu_torch.distributed.launch --nproc_per_node 2 \\
        [--devices 0,1] [--master 127.0.0.1:PORT] train.py --args...

starts one process a rank with the environment ``env.init_parallel_env``
reads, as the reference's launcher sets it: ``PADDLE_TRAINER_ID``,
``PADDLE_TRAINERS_NUM``, ``PADDLE_MASTER`` (rank 0 serves the store there;
default: a free port on 127.0.0.1), ``PADDLE_LOCAL_RANK``,
``PADDLE_NNODES`` and ``FLAGS_selected_gpus``, rank i's card being the
i-th of ``--devices`` / ``--gpus`` (default: card i). Naming a card twice
puts two ranks on it (they then need ``backend="gloo"``: NCCL refuses two
ranks on one device). Each rank's output goes to
``<log_dir>/workerlog.<rank>``. When a rank exits with an error the
launcher ends the others (SIGTERM, then SIGKILL after a grace period),
prints the tail of the failed rank's log and exits with its code; it
never restarts or re-launches anything.

More than one node (``--nnodes``), ``--rank auto`` (the rendezvous),
``--max_restarts`` and the elastic watch are not ported yet: they raise.
"""

from __future__ import annotations

import argparse
import os
import signal
import socket
import subprocess
import sys
import threading
import time


def _parse_args(argv=None):
    p = argparse.ArgumentParser(
        prog="paddle_tpu_torch.distributed.launch",
        description="Launch one process a rank on this node")
    p.add_argument("--nnodes", type=str, default="1")
    p.add_argument("--master", type=str, default=None,
                   help="host:port of rank 0's store (default: a free "
                        "port on 127.0.0.1)")
    p.add_argument("--rank", type=str, default="0",
                   help="this node's index (one node: 0)")
    p.add_argument("--nproc_per_node", type=int, default=1)
    p.add_argument("--log_dir", type=str, default="log")
    p.add_argument("--max_restarts", type=int, default=0)
    p.add_argument("--job_id", type=str, default="default")
    p.add_argument("--elastic_watch", choices=("auto", "on", "off"),
                   default="auto")
    p.add_argument("--devices", "--gpus", type=str, default=None,
                   help="comma-separated cards, one a rank")
    p.add_argument("--grace_s", type=float, default=10.0,
                   help="seconds between SIGTERM and SIGKILL for the ranks "
                        "left when one fails")
    p.add_argument("training_script", type=str)
    p.add_argument("training_script_args", nargs=argparse.REMAINDER)
    return p.parse_args(argv)


def _refuse_unported(args):
    for what, bad in (("--nnodes > 1 (multi-node)", args.nnodes != "1"),
                      ("--rank auto (the rendezvous)", args.rank == "auto"),
                      ("--max_restarts", args.max_restarts != 0),
                      ("--elastic_watch on", args.elastic_watch == "on")):
        if bad:
            raise NotImplementedError(
                f"launch: {what} is not ported to paddle_tpu_torch yet "
                f"(one node, no restarts)")
    if args.rank != "0":
        raise NotImplementedError("launch: one node, --rank 0")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _devices(args):
    n = args.nproc_per_node
    if args.devices is None:
        return [str(i) for i in range(n)]
    devs = [d.strip() for d in args.devices.split(",") if d.strip()]
    if len(devs) != n:
        raise ValueError(f"--devices names {len(devs)} cards for "
                         f"--nproc_per_node {n}")
    return devs


def _rank_env(args, rank, master, device):
    env = dict(os.environ)
    env.update({"PADDLE_TRAINER_ID": str(rank),
                "PADDLE_TRAINERS_NUM": str(args.nproc_per_node),
                "PADDLE_LOCAL_RANK": str(rank),
                "PADDLE_NNODES": "1",
                "PADDLE_MASTER": master,
                "FLAGS_selected_gpus": device})
    return env


def _stop(procs, grace_s):
    live = [p for p in procs if p.poll() is None]
    for p in live:
        p.send_signal(signal.SIGTERM)
    deadline = time.monotonic() + grace_s
    for p in live:
        try:
            p.wait(timeout=max(0.0, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()


def _tail(path, n=4000):
    with open(path, "rb") as f:
        f.seek(0, os.SEEK_END)
        f.seek(max(0, f.tell() - n))
        return f.read().decode(errors="replace")


def launch(argv=None) -> int:
    args = _parse_args(argv)
    _refuse_unported(args)
    if threading.current_thread() is threading.main_thread():
        # a SIGTERM to the launcher ends the ranks too (the finally below)
        signal.signal(signal.SIGTERM, lambda *_: sys.exit(143))
    devices = _devices(args)
    master = args.master or f"127.0.0.1:{_free_port()}"
    os.makedirs(args.log_dir, exist_ok=True)
    cmd = [sys.executable, "-u", args.training_script] + \
        args.training_script_args
    procs, logs = [], []
    try:
        for rank in range(args.nproc_per_node):
            path = os.path.join(args.log_dir, f"workerlog.{rank}")
            logs.append(path)
            with open(path, "wb") as logf:
                procs.append(subprocess.Popen(
                    cmd, env=_rank_env(args, rank, master, devices[rank]),
                    stdout=logf, stderr=subprocess.STDOUT))
        while True:
            codes = [p.poll() for p in procs]
            failed = [r for r, c in enumerate(codes)
                      if c is not None and c != 0]
            if failed:
                r = failed[0]
                _stop(procs, args.grace_s)
                print(f"launch: rank {r} exited with code {codes[r]}; the "
                      f"other ranks were stopped. Tail of {logs[r]}:\n"
                      f"{_tail(logs[r])}", file=sys.stderr)
                return codes[r] if codes[r] > 0 else 1
            if all(c == 0 for c in codes):
                print(f"launch: {len(procs)} ranks exited cleanly (logs: "
                      f"{args.log_dir}/workerlog.*)")
                return 0
            time.sleep(0.1)
    finally:
        _stop(procs, args.grace_s)


def main():
    sys.exit(launch())


if __name__ == "__main__":
    main()
