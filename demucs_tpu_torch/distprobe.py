"""A cluster self-test (port of ``demucs_tpu/distprobe.py``):

    python -m demucs_tpu_torch.launcher -n N [--platform cpu] \\
        --module demucs_tpu_torch.distprobe

Each rank starts the process group through ``distrib.init`` (the trainer's
path), all-reduces a tensor filled with its rank number on its own device,
checks the sum, shares an object from every rank (``distrib.share``, the
evaluation's pattern), runs each collective on the device's tensors
(``DISTPROBE_COLLECTIVES <rank> {...}``: Gloo takes CUDA tensors in some and
not in others; the ones the port runs, :data:`NEEDED`, must work) and prints
``DISTPROBE_OK <rank>/<world> device=<device> backend=<backend>``. A
mismatch exits nonzero, which makes the launcher stop every rank: a quick
answer to "is this multi-process setup wired" before a training run.
"""

from __future__ import annotations

import json
import sys

# what the port runs on the ranks' devices: the gradients', tensor
# parallelism's and the bag's all_reduce; broadcast (share) on the group
NEEDED = ("all_reduce", "broadcast")


def collectives(device) -> dict:
    """Each collective on tensors of ``device`` over the default group:
    ``"ok"`` where it ran and gave the right values, else the error."""
    import torch
    import torch.distributed as dist

    rank, world = dist.get_rank(), dist.get_world_size()
    want_sum = float(sum(range(world)))
    checks = {}

    def all_reduce():
        x = torch.full((3,), float(rank), device=device)
        dist.all_reduce(x)
        return bool((x == want_sum).all())

    def broadcast():
        x = torch.full((3,), float(rank), device=device)
        dist.broadcast(x, src=0)
        return bool((x == 0).all())

    def all_gather():
        parts = [torch.empty(2, device=device) for _ in range(world)]
        dist.all_gather(parts, torch.full((2,), float(rank), device=device))
        return all(bool((p == r).all()) for r, p in enumerate(parts))

    def reduce_scatter():
        out = torch.empty(2, device=device)
        dist.reduce_scatter(out, [torch.full((2,), float(rank), device=device)] * world)
        return bool((out == want_sum).all())

    for name, fn in (("all_reduce", all_reduce), ("broadcast", broadcast),
                     ("all_gather", all_gather), ("reduce_scatter", reduce_scatter)):
        try:
            checks[name] = "ok" if fn() else "wrong values"
        except Exception as err:  # noqa: BLE001 — reported, not hidden
            checks[name] = f"{type(err).__name__}: {str(err).splitlines()[0][:120]}"
    return checks


def check(device) -> int:
    """The probe's checks on this rank of the group (module docstring); 0 when
    they pass. The launcher's ranks of other modules may run it first."""
    import torch
    import torch.distributed as dist

    from demucs_tpu_torch.train import distrib

    rank, world = distrib.rank(), distrib.world_size()
    x = torch.full((4,), float(rank), device=device)
    if dist.is_initialized():
        dist.all_reduce(x)
    got = float(x.sum())
    want = 4.0 * sum(range(world))
    if abs(got - want) > 1e-6:
        print(f"DISTPROBE_FAIL rank {rank}: all_reduce {got} != {want}", flush=True)
        return 1
    merged: dict = {}
    for src in range(world):
        merged.update(distrib.share({f"r{rank}": rank}, src))
    if merged != {f"r{r}": r for r in range(world)}:
        print(f"DISTPROBE_FAIL rank {rank}: share {merged}", flush=True)
        return 1
    distrib.barrier()
    backend = dist.get_backend() if dist.is_initialized() else "none"
    if dist.is_initialized():
        support = collectives(device)
        print(f"DISTPROBE_COLLECTIVES {rank} {json.dumps(support)}", flush=True)
        needed = {k: v for k, v in support.items() if k in NEEDED and v != "ok"}
        if needed:
            print(f"DISTPROBE_FAIL rank {rank}: {backend} cannot run {needed} on {device}",
                  flush=True)
            return 1
    print(f"DISTPROBE_OK {rank}/{world} device={device} backend={backend}", flush=True)
    return 0


def main() -> int:
    import torch.distributed as dist

    from demucs_tpu_torch.train import distrib

    code = check(distrib.init())
    if dist.is_initialized():
        dist.destroy_process_group()
    return code


if __name__ == "__main__":
    sys.exit(main())
