"""Local multi-process launcher (port of ``demucs_tpu/launcher.py``): the
reference's ``dora run -d``, one process per device with a
``torch.distributed`` rendezvous (docs/training.md:45-83, demucs/distrib.py).

Spawns N ranks of ``python -m <module> <overrides...>``, each with ``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``, ``MASTER_ADDR`` and
``MASTER_PORT`` (rank 0 hosts the rendezvous on ``127.0.0.1``), which
``demucs_tpu_torch.train.distrib.init`` reads:

- by default rank k trains on ``cuda:k`` under NCCL; a rank whose card is not
  there makes the launcher raise before anything starts (never the CPU);
- ``--platform cpu``: CPU ranks under Gloo (``DEMUCS_TORCH_PLATFORM=cpu``),
  the bring-up the tests use;
- ``--devices cuda:0,cuda:0 --backend gloo``: name each rank's device and the
  backend (two ranks on one card: NCCL refuses them, Gloo's ``all_reduce``
  and ``broadcast`` take CUDA tensors);
- ``--init-method file:///path``: a rendezvous file instead of the port.

Each line of a child's output is printed with a ``[rank N]`` prefix; the
first rank that fails terminates the others (the PIDs this launcher
started, never a pattern), and its exit code is the launcher's. A launcher
stopped by SIGTERM stops its ranks first.

``torchrun --nproc-per-node N -m demucs_tpu_torch.train ...`` and ``srun``
(a multi-task step) set the same environment and need no launcher.

Usage:
    python -m demucs_tpu_torch.launcher -n 2 --platform cpu -- epochs=1 ...
    python -m demucs_tpu_torch.launcher -n 2 --platform cpu \\
        --module demucs_tpu_torch.distprobe          # a cluster self-test
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
import typing as tp

__all__ = ["child_env", "cuda_device_count", "rank_devices", "launch", "main"]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def cuda_device_count() -> int:
    """The CUDA devices this process sees (``CUDA_VISIBLE_DEVICES`` applied),
    from ``libcuda`` itself (``cuDeviceGetCount``), so the launcher does not
    import torch; 0 where ``libcuda`` is absent."""
    import ctypes

    try:
        libcuda = ctypes.CDLL("libcuda.so.1")
    except OSError:
        return 0
    count = ctypes.c_int(0)
    if libcuda.cuInit(0) != 0 or libcuda.cuDeviceGetCount(ctypes.byref(count)) != 0:
        return 0
    return count.value


def rank_devices(n: int, platform: str = "",
                 devices: tp.Optional[tp.Sequence[str]] = None) -> tp.List[str]:
    """Each rank's device: ``devices`` as given, ``cpu`` under ``--platform
    cpu``, else ``cuda:k``. A CUDA device this machine does not have raises."""
    if devices:
        if len(devices) != n:
            raise ValueError(f"{len(devices)} devices named for {n} ranks")
        out = list(devices)
    else:
        out = ["cpu" if platform == "cpu" else f"cuda:{k}" for k in range(n)]
    wanted = [int(d.split(":")[1]) if ":" in d else 0 for d in out if d.startswith("cuda")]
    if wanted:
        count = cuda_device_count()
        if max(wanted) >= count:
            raise RuntimeError(f"ranks ask for cuda:{max(wanted)}, but this machine has "
                               f"{count} CUDA device(s); pass --platform cpu for CPU ranks "
                               "(nothing falls back to the CPU)")
    return out


def child_env(rank: int, world: int, port: int, device: str, backend: str = "",
              init_method: str = "", base: tp.Optional[tp.Mapping[str, str]] = None
              ) -> tp.Dict[str, str]:
    """The environment of rank ``rank`` of ``world`` (module docstring)."""
    from demucs_tpu_torch.train import distrib

    env = dict(os.environ if base is None else base)
    env.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
               LOCAL_WORLD_SIZE=str(world), MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    env[distrib.DEVICE_ENV] = device
    if device == "cpu":
        env[distrib.PLATFORM_ENV] = "cpu"
    else:
        env.pop(distrib.PLATFORM_ENV, None)
    for key, value in ((distrib.BACKEND_ENV, backend), (distrib.INIT_METHOD_ENV, init_method)):
        if value:
            env[key] = value
        else:
            env.pop(key, None)
    return env


def _stream(proc: subprocess.Popen, rank: int) -> None:
    assert proc.stdout is not None
    for line in proc.stdout:
        sys.stdout.write(f"[rank {rank}] {line}")
        sys.stdout.flush()


def launch(module: str, overrides: tp.Sequence[str], *, n: int, platform: str = "",
           devices: tp.Optional[tp.Sequence[str]] = None, backend: str = "",
           init_method: str = "") -> int:
    """Run ``n`` ranks of ``python -m module overrides...``; returns the first
    nonzero exit code (0 when every rank succeeds)."""
    placed = rank_devices(n, platform, devices)
    port = _free_port()
    repo_root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    procs: tp.List[subprocess.Popen] = []
    threads: tp.List[threading.Thread] = []
    code = 0
    try:
        for rank in range(n):
            env = child_env(rank, n, port, placed[rank], backend, init_method)
            env["PYTHONPATH"] = os.pathsep.join(
                p for p in (repo_root, env.get("PYTHONPATH", "")) if p)
            proc = subprocess.Popen([sys.executable, "-m", module, *overrides], env=env,
                                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            procs.append(proc)
            thread = threading.Thread(target=_stream, args=(proc, rank), daemon=True)
            thread.start()
            threads.append(thread)
        # wait for ANY rank: one that fails leaves the others in a collective
        live = list(procs)
        while live:
            done = [p for p in live if p.poll() is not None]
            if not done:
                time.sleep(0.1)
                continue
            live = [p for p in live if p.poll() is None]
            for p in done:
                if p.returncode != 0 and code == 0:
                    code = p.returncode
                    for other in live:
                        other.terminate()
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
            proc.wait()
        for thread in threads:
            thread.join(timeout=5)
    return code


def _stop(signum, frame):
    raise SystemExit(128 + signum)  # runs launch()'s cleanup: every rank is stopped


def main(argv: tp.Optional[tp.Sequence[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        "demucs_tpu_torch.launcher",
        description="Spawn N torch.distributed ranks of a module on this machine.")
    parser.add_argument("-n", "--num-processes", type=int, required=True)
    parser.add_argument("--module", default="demucs_tpu_torch.train",
                        help="module each rank runs (default: the trainer)")
    parser.add_argument("--platform", default="", choices=["", "cpu"],
                        help="'cpu': CPU ranks under Gloo; default: rank k on cuda:k")
    parser.add_argument("--devices", default="",
                        help="comma-separated device per rank, e.g. cuda:0,cuda:0")
    parser.add_argument("--backend", default="", choices=["", "nccl", "gloo"],
                        help="default: NCCL on cards, Gloo on the CPU")
    parser.add_argument("--init-method", default="",
                        help="rendezvous URL, e.g. file:///tmp/rdv (default: env://)")
    parser.add_argument("overrides", nargs="*", help="key=value overrides for every rank")
    args = parser.parse_args(argv)
    devices = [d for d in args.devices.split(",") if d] or None
    main_thread = threading.current_thread() is threading.main_thread()
    previous = signal.signal(signal.SIGTERM, _stop) if main_thread else None
    try:
        return launch(args.module, args.overrides, n=args.num_processes, platform=args.platform,
                      devices=devices, backend=args.backend, init_method=args.init_method)
    finally:
        if main_thread:
            signal.signal(signal.SIGTERM, previous)


if __name__ == "__main__":
    sys.exit(main())
