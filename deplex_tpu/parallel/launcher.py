"""Local multi-process launcher for jax.distributed (torchrun-style).

The reference is strictly single-process (SURVEY.md §2.4; no MPI/NCCL/Gloo
anywhere in the reference); multi-process execution is a new capability.
Nothing tells JAX of a cluster, so `parallel.distributed.initialize()` reads
the coordinator, the group size and the rank from the env contract below.
This launcher covers:

  * one process per GPU of a host (`--platform gpu`): process i sees only
    card i (CUDA_VISIBLE_DEVICES=i), since a JAX process reserves most of a
    card's memory and a second process on the same card would fail;
  * N-process CPU simulation of a multi-host group (tests / CI): each
    process gets `--local-devices` fake CPU devices and the group's
    collectives ride gloo;
  * generic multi-node bring-up where an external scheduler starts one
    process per node and only needs the env contract below.

Env contract (read by `parallel.distributed.initialize`):

    JAX_COORDINATOR_ADDRESS   host:port of process 0's coordinator
    JAX_NUM_PROCESSES         group size
    JAX_PROCESS_ID            this process's rank

CLI:

    python -m deplex_tpu.parallel.launcher --nprocs 2 --local-devices 4 \
        --platform cpu -- worker.py arg...
"""

from __future__ import annotations

import argparse
import os
import socket
import subprocess
import sys
from dataclasses import dataclass


def find_free_port() -> int:
    """Ask the OS for a free TCP port (process 0's coordinator endpoint)."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@dataclass
class ProcessResult:
    process_id: int
    returncode: int
    stdout: str
    stderr: str


def process_env(pid: int, num_processes: int, port: int, *,
                platform: str | None = None, local_devices: int | None = None,
                extra_env: dict[str, str] | None = None,
                base_env: dict[str, str] | None = None) -> dict[str, str]:
    """The environment of process `pid` of the group."""
    env = dict(os.environ if base_env is None else base_env)
    env["JAX_COORDINATOR_ADDRESS"] = f"127.0.0.1:{port}"
    env["JAX_NUM_PROCESSES"] = str(num_processes)
    env["JAX_PROCESS_ID"] = str(pid)
    if platform:
        env["JAX_PLATFORMS"] = "cuda" if platform == "gpu" else platform
    if platform in ("gpu", "cuda"):
        env["CUDA_VISIBLE_DEVICES"] = str(pid)     # one card per process
    if local_devices:
        flags = env.get("XLA_FLAGS", "")
        flags = " ".join(f for f in flags.split()
                         if "xla_force_host_platform_device_count" not in f)
        env["XLA_FLAGS"] = (
            f"{flags} --xla_force_host_platform_device_count={local_devices}"
        ).strip()
    if extra_env:
        env.update(extra_env)
    return env


def launch(cmd: list[str], num_processes: int, *,
           local_devices: int | None = None,
           platform: str | None = None,
           port: int | None = None,
           extra_env: dict[str, str] | None = None,
           timeout: float = 600.0) -> list[ProcessResult]:
    """Run `cmd` in `num_processes` local processes forming one jax.distributed
    group; returns per-process results, raising on any nonzero exit.

    cmd: argv of the worker (a `python script.py ...` prefix is added when
    cmd[0] ends in .py). Each process receives the env contract above, plus
    JAX_PLATFORMS=<platform>; on a GPU platform, one card each
    (CUDA_VISIBLE_DEVICES=<pid>); and, when local_devices is set,
    --xla_force_host_platform_device_count=<n> appended to XLA_FLAGS.
    """
    if num_processes < 1:
        raise ValueError("num_processes must be >= 1")
    if port is None:
        port = find_free_port()
    if cmd and cmd[0].endswith(".py"):
        cmd = [sys.executable] + cmd

    procs = []
    for pid in range(num_processes):
        env = process_env(pid, num_processes, port, platform=platform,
                          local_devices=local_devices, extra_env=extra_env)
        procs.append(subprocess.Popen(
            cmd, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True))

    results = []
    failed = []
    for pid, p in enumerate(procs):
        try:
            out, err = p.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            out, err = p.communicate()
            results.append(ProcessResult(pid, -9, out, err))
            failed.append(pid)
            continue
        results.append(ProcessResult(pid, p.returncode, out, err))
        if p.returncode != 0:
            failed.append(pid)
    if failed:
        detail = "\n".join(
            f"--- process {r.process_id} (rc={r.returncode}) ---\n"
            f"{r.stdout[-2000:]}\n{r.stderr[-4000:]}"
            for r in results if r.process_id in failed)
        raise RuntimeError(
            f"{len(failed)}/{num_processes} launched processes failed:\n{detail}")
    return results


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        description="Launch N local processes as one jax.distributed group.")
    ap.add_argument("--nprocs", type=int, required=True)
    ap.add_argument("--local-devices", type=int, default=None,
                    help="fake CPU devices per process (simulation mode)")
    ap.add_argument("--platform", default=None,
                    help="workers' platform: cpu, or gpu for one card each")
    ap.add_argument("--timeout", type=float, default=600.0)
    ap.add_argument("cmd", nargs=argparse.REMAINDER,
                    help="worker command (prefix with -- )")
    args = ap.parse_args(argv)
    cmd = args.cmd[1:] if args.cmd[:1] == ["--"] else args.cmd
    if not cmd:
        ap.error("no worker command given")
    results = launch(cmd, args.nprocs, local_devices=args.local_devices,
                     platform=args.platform, timeout=args.timeout)
    for r in results:
        sys.stdout.write(r.stdout)
        sys.stderr.write(r.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
