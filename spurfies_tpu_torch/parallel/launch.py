"""Start the ranks of ``train.data_parallel`` (the JAX package needs no
counterpart: its mesh is one program in one process).

    results = launch(fn, n, *args)          # fn(group, *args) on n ranks

starts ``n`` worker processes with the ``spawn`` start method (``fork`` is
wrong once CUDA is initialised), joins them in a ``torch.distributed``
group over a localhost TCP rendezvous, calls ``fn(group, *args)`` on each
with its :class:`parallel.mesh.RankGroup` and returns their results in rank
order (tensors come back as numpy arrays).  Rank r runs on ``cuda:r``
unless ``devices`` says otherwise: ``devices=("cpu", "cpu")`` puts two ranks
on the CPU, ``devices=("cuda:0", "cuda:0")`` two on one card (the
counterpart of JAX's ``xla_force_host_platform_device_count``).  The backend
is NCCL when every rank has a card of its own and gloo otherwise.

Under ``torchrun`` (``RANK`` and ``WORLD_SIZE`` set) nothing is started:
this process joins the group that ``torchrun`` set up as its rank, runs
``fn`` and returns ``[its result]``.
"""

import os
import queue
import socket
import traceback

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from spurfies_tpu_torch.parallel import mesh


def rank_devices(n: int, devices=None) -> list:
    """``torch.device`` of each of ``n`` ranks: ``devices`` if given, else
    ``cuda:r`` for rank r, which needs ``n`` cards."""
    if devices is None:
        have = torch.cuda.device_count()
        if have < n:
            raise ValueError(
                f"train.data_parallel={n} but only {have} devices visible")
        devices = [f"cuda:{r}" for r in range(n)]
    devices = [torch.device(d) for d in devices]
    if len(devices) != n:
        raise ValueError(f"{len(devices)} devices given for {n} ranks")
    return devices


def pick_backend(devices) -> str:
    """NCCL when every rank has a card of its own, gloo otherwise (the CPU,
    or several ranks on one card, which NCCL refuses)."""
    cards = [d.index or 0 for d in devices if d.type == "cuda"]
    if len(cards) == len(devices) and len(set(cards)) == len(cards):
        return "nccl"
    return "gloo"


def _to_host(obj):
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu().numpy()
    if isinstance(obj, dict):
        return {k: _to_host(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_host(v) for v in obj)
    return obj


def _join(rank, world, device, backend, init_method):
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world)
    group = mesh.RankGroup(rank, world, device, backend)
    mesh.set_current(group)
    return group


def _leave():
    mesh.set_current(None)
    if dist.is_initialized():
        dist.destroy_process_group()


def _rank_main(fn, rank, world, device, backend, init_method, threads, args,
               results):
    try:
        if device.type == "cpu":
            torch.set_num_threads(threads)
        group = _join(rank, world, device, backend, init_method)
        out = _to_host(fn(group, *args))
        results.put((rank, True, out))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
    finally:
        _leave()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch(fn, n: int, *args, devices=None):
    """``[fn(group, *args) for each of n ranks]`` (see the module's
    docstring).  ``fn`` and ``args`` must pickle (``fn`` a module-level
    function).  A rank that raises ends the run: the others are stopped
    and a ``RuntimeError`` carries its traceback.  CPU ranks share this
    process's torch threads among them."""
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        return [_run_joined(fn, n, args, devices)]
    devs = rank_devices(n, devices)
    backend = pick_backend(devs)
    n_cpu = sum(d.type == "cpu" for d in devs)
    threads = max(1, torch.get_num_threads() // max(n_cpu, 1))
    init_method = f"tcp://127.0.0.1:{_free_port()}"
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_main, args=(
        fn, r, n, devs[r], backend, init_method, threads, args, results))
        for r in range(n)]
    for p in procs:
        p.start()
    got = {}
    try:
        while len(got) < n:
            try:
                rank, ok, out = results.get(timeout=1.0)
            except queue.Empty:
                dead = [p for p in procs if p.exitcode not in (None, 0)]
                if dead:
                    raise RuntimeError(
                        f"a rank exited with code {dead[0].exitcode} "
                        "before reporting") from None
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} failed:\n{out}")
            got[rank] = out
    finally:
        for p in procs:
            p.join(timeout=30 if len(got) == n else 0)
            if p.is_alive():
                p.kill()
                p.join()
    return [got[r] for r in range(n)]


def _run_joined(fn, n, args, devices):
    """This process as rank ``$RANK`` of the group ``torchrun`` set up."""
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    if world != n:
        raise ValueError(f"train.data_parallel={n} but torchrun started "
                         f"{world} ranks")
    local = int(os.environ.get("LOCAL_RANK", rank))
    if devices is None:
        if torch.cuda.device_count() <= local:
            raise ValueError(
                f"train.data_parallel={n} but only "
                f"{torch.cuda.device_count()} devices visible")
        device = torch.device(f"cuda:{local}")
    else:
        device = torch.device(list(devices)[rank])
    backend = ("nccl" if devices is None else
               pick_backend([torch.device(d) for d in devices]))
    group = _join(rank, world, device, backend, "env://")
    try:
        return fn(group, *args)
    finally:
        _leave()

