"""Multi-process job launcher.

Reference: python/paddle/distributed/launch.py — spawns one process per
device/worker on the node, wiring PADDLE_TRAINER_ID /
PADDLE_TRAINER_ENDPOINTS / PADDLE_CURRENT_ENDPOINT env vars. Usage:

  python -m paddle_tpu_torch.distributed.launch --worker_num 2 train.py

One process per card, the reference's model: --worker_num defaults to
the number of cards (1 without one), worker i gets LOCAL_RANK=i, and the
script calls distributed.init_parallel_env(), which binds that card and
makes the process group (NCCL by default; PADDLE_DISTRI_BACKEND=gloo or
--backend gloo for the host backend, which is what two ranks on one
card need: NCCL refuses two ranks on one GPU). Parameter-server mode
(--server_num) waits for ROADMAP §A8e.
"""
from __future__ import annotations

import argparse
import os
import signal
import socket
import subprocess
import sys

__all__ = ["launch"]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _parse_args(argv=None):
    p = argparse.ArgumentParser("paddle_tpu_torch.distributed.launch")
    p.add_argument("--cluster_node_ips", default="127.0.0.1")
    p.add_argument("--node_ip", default="127.0.0.1")
    p.add_argument("--started_port", type=int, default=0,
                   help="0 = pick free ports")
    p.add_argument("--worker_num", "--nproc_per_node", type=int,
                   default=None, help="ranks; default one per card")
    p.add_argument("--server_num", type=int, default=0,
                   help="parameter-server mode: waits for ROADMAP §A8e")
    p.add_argument("--backend", choices=("nccl", "gloo"), default=None,
                   help="the process group's backend (default NCCL)")
    p.add_argument("--log_dir", default=None)
    p.add_argument("training_script")
    p.add_argument("training_script_args", nargs=argparse.REMAINDER)
    return p.parse_args(argv)


def _endpoints(ip, n, started_port):
    ports = ([started_port + i for i in range(n)] if started_port
             else [_free_port() for _ in range(n)])
    return [f"{ip}:{p}" for p in ports]


def _cards() -> int:
    import torch
    return torch.cuda.device_count() if torch.cuda.is_available() else 0


def launch(argv=None):
    args = _parse_args(argv)
    if args.server_num:
        raise NotImplementedError(
            "--server_num: the parameter-server runtime waits for "
            "ROADMAP §A8e")
    if args.worker_num is None:
        args.worker_num = max(_cards(), 1)
    worker_eps = _endpoints(args.node_ip, args.worker_num,
                            args.started_port)

    procs = []
    log_fhs = []

    def _spawn(env_extra, tag):
        env = dict(os.environ, **{k: str(v) for k, v in env_extra.items()})
        cmd = [sys.executable, args.training_script,
               *args.training_script_args]
        out = None
        if args.log_dir:
            os.makedirs(args.log_dir, exist_ok=True)
            out = open(os.path.join(args.log_dir, f"{tag}.log"), "w")
            log_fhs.append(out)
        procs.append(subprocess.Popen(cmd, env=env, stdout=out,
                                      stderr=subprocess.STDOUT))

    common = {
        "PADDLE_TRAINER_ENDPOINTS": ",".join(worker_eps),
        "PADDLE_TRAINERS_NUM": args.worker_num,
    }
    if args.backend:
        common["PADDLE_DISTRI_BACKEND"] = args.backend
    for i, ep in enumerate(worker_eps):
        _spawn({**common, "TRAINING_ROLE": "TRAINER",
                "PADDLE_TRAINER_ID": i, "LOCAL_RANK": i,
                "PADDLE_CURRENT_ENDPOINT": ep}, f"workerlog.{i}")

    def _terminate(signum=None, frame=None):
        for p in procs:
            if p.poll() is None:
                p.terminate()

    signal.signal(signal.SIGINT, _terminate)
    signal.signal(signal.SIGTERM, _terminate)

    rc = 0
    try:
        for p in procs:
            p.wait()
            rc = rc or p.returncode
    finally:
        _terminate()
        for fh in log_fhs:
            fh.close()
    return rc


if __name__ == "__main__":
    sys.exit(launch())
