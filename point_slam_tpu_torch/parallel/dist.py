"""Data parallelism over torch.distributed: one process per rank.

The port of ``point_slam_tpu.parallel.mesh``. The per-iteration ray batch
of the tracking and mapping loops is split over the ranks of the default
process group; the point cloud, the cell tables, the decoders, the pose
and the optimiser state are replicated. The caller initialises the group
(``point_slam_tpu_torch.run`` does it under torchrun with ``init_from_env``:
NCCL on CUDA, gloo on the CPU); ``cuda.data_parallel`` must equal its size.

Every rank draws the WHOLE padded batch from its replicated generator,
computes what is global over the batch (the depth cut's median and
maximum, the window slots, the random-fill vectors, the far bound of
depth-free rays) on all of it, and renders only its contiguous block
``[rank*R/W, (rank+1)*R/W)``, the layout of JAX's ``P("dp")``. The kNN is
per ray and needs no collective. The losses are sums over rays, so each
rank's partial sums (and their gradients) are all-reduced in one flat
bucket an iteration; statistics taken after the render (the tracker's
robust-mask median and mean) are taken over all ranks' rays. Every rank
then steps the same reduced gradient, so the replicas stay bit-equal.
Rank 0 alone writes files (``is_writer``).

``Ranks`` starts such groups inside one host for the tools and tests that
compare world sizes: spawned processes that join a gloo group over a
FileStore, run a job and leave it.

The loops call these helpers whether or not a group exists: with a group
of any size, world size 1 included, they take the collectives; without
one each is the local computation (``shard`` the whole batch, the
reductions nothing, the statistics this process's own).
"""

from __future__ import annotations

import datetime
import os
import time
from typing import Any, Callable, Dict, List, Optional, Sequence

import torch
import torch.distributed as dist

from point_slam_tpu_torch.common import image

# the finite timeout of every process group the port creates: a rank that
# waits longer at a collective (a crashed or hung peer) fails
TIMEOUT = datetime.timedelta(minutes=30)

# the default timeout of a ``Ranks`` group and of its ranks' join
RANKS_TIMEOUT_S = 300

# bytes this rank has sent into all_reduce and all_gather (the counts of
# the reduced or gathered tensors), for the smoke test's traffic line
SENT = {"all_reduce": 0, "all_gather": 0}


def active() -> bool:
    """Whether the default process group is initialised."""
    return dist.is_available() and dist.is_initialized()


def world() -> int:
    return dist.get_world_size() if active() else 1


def rank() -> int:
    return dist.get_rank() if active() else 0


def is_writer() -> bool:
    """Rank 0 writes the run's files; the other ranks write none."""
    return rank() == 0


def data_parallel(cfg: Dict[str, Any]) -> int:
    return int(cfg["cuda"].get("data_parallel", 1) or 1)


def padded(n: int, dp: int) -> int:
    """``n`` rays rounded up to a multiple of ``dp``."""
    return -(-n // dp) * dp


def check_group(cfg: Dict[str, Any]) -> None:
    """``cuda.data_parallel`` against the process group: equal to its size
    when one is initialised, else 1."""
    dp = data_parallel(cfg)
    if active():
        if dp != world():
            raise ValueError(
                f"cuda.data_parallel is {dp} but the process group has "
                f"{world()} ranks; they must be equal")
    elif dp > 1:
        raise RuntimeError(
            f"cuda.data_parallel {dp} needs a process group of {dp} ranks: "
            f"launch with torchrun --nproc_per_node {dp} -m "
            f"point_slam_tpu_torch.run <config.yaml>, or call "
            f"torch.distributed.init_process_group before building PointSLAM")


def init_from_env(device: str = "cuda") -> torch.device:
    """Under torchrun (``LOCAL_RANK`` set): initialise the default group,
    NCCL for ``device`` "cuda" (this rank's card is cuda:LOCAL_RANK) and
    gloo for the CPU, with ``TIMEOUT``; return this rank's device. Without
    torchrun: no group, ``device`` as given."""
    dev = torch.device(device)
    if "LOCAL_RANK" not in os.environ:
        return dev
    local = int(os.environ["LOCAL_RANK"])
    if dev.type == "cuda":
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if local >= n:
            raise RuntimeError(
                f"LOCAL_RANK {local} has no card behind it: CUDA is not "
                f"available on this host or it has {n} CUDA devices; pass "
                f"--device cpu to run the ranks on the host")
        dev = torch.device("cuda", local)
        torch.cuda.set_device(dev)
        dist.init_process_group("nccl", timeout=TIMEOUT)
    else:
        dist.init_process_group("gloo", timeout=TIMEOUT)
    return dev


def shard(x: torch.Tensor) -> torch.Tensor:
    """This rank's contiguous block of ``x``'s leading dimension, which the
    world size must divide."""
    w = world()
    if w == 1:
        return x
    n = x.shape[0]
    if n % w:
        raise ValueError(f"{n} rows do not split over {w} ranks")
    b = n // w
    r = rank()
    return x[r * b:(r + 1) * b]


def all_reduce_flat(tensors: Sequence[torch.Tensor]) -> None:
    """Sum each tensor over the ranks, in place, with ONE all_reduce of a
    flat bucket of them all (same dtype); without a group, nothing."""
    if not active():
        return
    flat = torch.cat([t.reshape(-1) for t in tensors])
    SENT["all_reduce"] += flat.numel() * flat.element_size()
    dist.all_reduce(flat)
    for t, part in zip(tensors, flat.split([t.numel() for t in tensors])):
        t.copy_(part.view_as(t))


def all_gather_cat(x: torch.Tensor) -> torch.Tensor:
    """Every rank's ``x`` (one shape on all ranks) concatenated in rank
    order along the leading dimension: the whole batch of its blocks
    (without a group, ``x``)."""
    if not active():
        return x
    x = x.detach().contiguous()
    parts: List[torch.Tensor] = [torch.empty_like(x) for _ in range(world())]
    SENT["all_gather"] += x.numel() * x.element_size()
    dist.all_gather(parts, x)
    return torch.cat(parts)


def masked_mean(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """``image.masked_mean`` over all ranks' entries: one all_reduce of the
    masked sum and the count (no gradient); without a group, this
    process's."""
    if not active():
        return image.masked_mean(x, mask)
    x = x.detach()
    s = torch.stack([torch.sum(torch.where(mask, x, 0.0)),
                     mask.sum().to(x.dtype)])
    all_reduce_flat([s])
    return s[0] / torch.clamp(s[1], min=1)


def masked_median(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """``image.masked_median`` over all ranks' entries (gathered; no
    gradient); without a group, this process's."""
    if not active():
        return image.masked_median(x, mask)
    return image.masked_median(all_gather_cat(x),
                               all_gather_cat(mask.to(torch.uint8)).bool())


def barrier() -> None:
    if active():
        dist.barrier()


def _rank_worker(slot: int, tasks, results, device: str) -> None:
    """A ``Ranks`` process: for each task it joins the task's gloo group as
    rank ``slot`` (or none), runs the job, saves what it returns with
    torch.save and leaves the group; (the task's number, slot, None or
    the traceback) goes to ``results``. ``None`` ends it."""
    import traceback
    cuda = torch.device(device).type == "cuda"
    if cuda:
        # every rank on the one card
        torch.cuda.set_device(0)
    while True:
        task = tasks.get()
        if task is None:
            return
        n, job, payload, world, store, out, timeout_s = task
        try:
            if not cuda:
                # one intra-op thread, so that the CPU's sums run in one
                # order and runs with and without a group can be bit-equal
                torch.set_num_threads(1)
            if store:
                dist.init_process_group(
                    "gloo", store=dist.FileStore(store, world), rank=slot,
                    world_size=world,
                    timeout=datetime.timedelta(seconds=timeout_s))
            try:
                res = job(payload)
            finally:
                if store:
                    dist.destroy_process_group()
            torch.save(res, out)
            if cuda:
                torch.cuda.empty_cache()
            results.put((n, slot, None))
        except Exception:
            # the process serves the next job; the parent raises
            results.put((n, slot, traceback.format_exc()))


class Ranks:
    """``n`` spawned processes that run jobs as the ranks of gloo groups:
    for a job of world size W, the first W of them join a group of their
    own over a new FileStore under ``root`` (timeout ``timeout_s``), run
    ``job(payload)``, save what it returns there and leave the group, so
    one set of processes serves several world sizes. On CUDA every process
    uses card 0 (NCCL refuses two ranks on one card; gloo does not), and
    the kernels must be built before the processes start; on the CPU each
    runs one intra-op thread. Leaving the ``with`` block ends the
    processes and kills any that hang."""

    def __init__(self, n: int, device, root: str,
                 timeout_s: float = RANKS_TIMEOUT_S):
        self.n, self.device, self.root = n, str(device), str(root)
        self.timeout_s = timeout_s
        self.jobs = 0

    def __enter__(self):
        import multiprocessing as mp
        os.makedirs(self.root, exist_ok=True)
        ctx = mp.get_context("spawn")
        self.results = ctx.Queue()
        self.tasks = [ctx.Queue() for _ in range(self.n)]
        self.procs = [ctx.Process(target=_rank_worker,
                                  args=(r, self.tasks[r], self.results,
                                        self.device))
                      for r in range(self.n)]
        for p in self.procs:
            p.start()
        return self

    def run(self, job: Callable[[Any], Any], payload: Any = None,
            world: int = 1, group: bool = True) -> List[Any]:
        """``job(payload)`` (a function a spawned process can import) on
        ranks 0..world-1 of a new gloo group (``group`` False: each
        process without one); what each returned, in rank order. Raises
        when a rank fails, ends or still runs after ``timeout_s``."""
        import queue
        if world > self.n:
            raise ValueError(f"a job of {world} ranks on {self.n} processes")
        self.jobs += 1
        tag = os.path.join(self.root, f"job{self.jobs}_w{world}")
        store: Optional[str] = tag + "_store" if group else None
        outs = [f"{tag}_rank{r}.pt" for r in range(world)]
        for path in [store] + outs:
            if path and os.path.exists(path):
                os.remove(path)
        for r in range(world):
            self.tasks[r].put((self.jobs, job, payload, world, store,
                               outs[r], self.timeout_s))
        done = set()
        deadline = time.monotonic() + self.timeout_s
        while len(done) < world:
            try:
                n, slot, err = self.results.get(timeout=1.0)
            except queue.Empty:
                dead = [r for r in range(world)
                        if not self.procs[r].is_alive()]
                if dead or time.monotonic() > deadline:
                    raise RuntimeError(
                        f"W={world}: processes {dead} ended, or the ranks "
                        f"ran past {self.timeout_s} s")
                continue
            if n != self.jobs:
                continue        # a rank of an earlier job that failed
            if err:
                raise RuntimeError(f"W={world} rank {slot} failed:\n{err}")
            done.add(slot)
        return [torch.load(p, weights_only=False) for p in outs]

    def __exit__(self, *exc):
        for q in self.tasks:
            q.put(None)
        for p in self.procs:
            p.join(10 if exc[0] is None else 0.1)
        for p in self.procs:
            if p.is_alive():
                p.kill()
                p.join(10)
