"""Multi-device runs over ``torch.distributed``: the mesh, the batch split
and the collectives of the port.

Counterpart of ``ev2hands_tpu/parallel/mesh.py``. The JAX package runs one
program over a device mesh and lets XLA insert the reductions; here each
device is a process (a rank) and the port calls the collectives itself:

* ``Mesh`` holds the ranks of a (data, event) grid: the batch is split over
  the ``data`` ranks, the event axis N of the dense set-abstraction scales
  and of FPS over the ``event`` ranks (``parallel/event_parallel.py``). A
  data-parallel mesh (``create_mesh``) has one event rank;
* BatchNorm statistics, the losses' denominators and the weighted sums of
  ``dense_train`` are reduced over the data ranks, so every rank sees the
  global batch's, as the JAX program does (``parallel/mesh.py:9-13``);
* every random draw is made at the global batch's shape and each rank keeps
  its rows (``global_rand``), so N ranks draw what one device draws.

Every collective is an ``all_reduce`` SUM or a ``broadcast``, which gloo
carries for CUDA tensors as NCCL does: an all-gather is the SUM of a zero
buffer in which each rank fills its own slot (exact: x + 0 = x and
-inf + 0 = -inf), and a MAX the max over that all-gather. ``all_sum_grad`` and ``all_gather_grad`` are the
differentiable forms: the backward of a SUM is the SUM of the cotangents,
and the all-gather's backward gives each rank the sum over ranks of its
slot's cotangent (the transpose JAX gives ``all_gather``).

An exported serving program (``export.export_serving(event_mesh=...)``)
cannot hold a process group or a rank: its mesh is marked ``program``, and
the event route then reaches its all-gather, its shard of the events, its
event rank and its FPS through registered ops (``torch.ops.ev2hands.event_*``),
which the exported graph keeps as nodes. They run over the mesh that
``install_mesh`` gives when the program is loaded, so every rank loads the
same artifact.

``start_ranks`` / ``run_ranks`` start one process per rank on this host and
collect what each returns; the tests and ``chip_smoke.py`` use them.
"""

from __future__ import annotations

import dataclasses
import datetime
import importlib.util
import os
import pickle
import shutil
import subprocess
import sys
import tempfile
import time
from typing import Any, Callable, List, Optional, Sequence

import torch
import torch.distributed as dist

DATA_AXIS = "data"
EVENT_AXIS = "event"
WORLD_AXIS = "world"   # every rank: data and event


def initialize_distributed(coordinator: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None,
                           backend: Optional[str] = None) -> bool:
    """Join the process group of a multi-process run -> whether one is
    joined. From the three flags (``coordinator`` is ``host:port`` of
    process 0), or, where they are not given, from the environment that
    ``torchrun`` sets (``WORLD_SIZE``, ``RANK``, ``MASTER_ADDR``,
    ``MASTER_PORT``). A single process joins nothing. ``backend`` defaults
    to NCCL where there is a card, else gloo."""
    if dist.is_initialized():
        return True
    env = os.environ
    if num_processes is None:
        num_processes = int(env.get("WORLD_SIZE", "1"))
    if num_processes <= 1:
        return False
    if process_id is None:
        process_id = int(env["RANK"])
    backend = backend or ("nccl" if torch.cuda.is_available() else "gloo")
    init = f"tcp://{coordinator}" if coordinator else "env://"
    dist.init_process_group(backend, init_method=init, world_size=num_processes,
                            rank=process_id)
    return True


def local_device(device="cuda") -> torch.device:
    """This process's device: ``cuda:{LOCAL_RANK mod the cards}`` for a
    ``device`` of "cuda" without an index (ranks beyond the card count
    share cards), else ``device`` as given."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        local = int(os.environ.get("LOCAL_RANK", dist.get_rank() if dist.is_initialized()
                                   else 0))
        device = torch.device("cuda", local % max(torch.cuda.device_count(), 1))
    return device


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The ranks of a (data, event) grid: rank ``r`` is data rank
    ``r // event_size`` and event rank ``r % event_size``. A group of None
    is a single rank, where every collective is the identity."""

    world_group: Any
    data_group: Any
    event_group: Any
    data_rank: int
    data_size: int
    event_rank: int
    event_size: int
    device: torch.device
    # traced into an exported program: the event collectives and the event
    # rank are the registered ops, run over the installed mesh
    program: bool = False

    @property
    def rank(self) -> int:
        return self.data_rank * self.event_size + self.event_rank

    @property
    def size(self) -> int:
        return self.data_size * self.event_size

    @property
    def is_main(self) -> bool:
        """Rank 0, the one that writes the logs and checkpoints."""
        return self.rank == 0

    @property
    def shape(self) -> dict:
        return {DATA_AXIS: self.data_size, EVENT_AXIS: self.event_size}


def _world() -> tuple:
    if not dist.is_initialized():
        return 0, 1
    return dist.get_rank(), dist.get_world_size()


def create_mesh(n_devices: Optional[int] = None, device="cuda") -> Mesh:
    """The 1-D data-parallel mesh over every rank of the process group (or
    the single process where none is joined). ``n_devices``, where given,
    must be the world size: a rank cannot sit out of the group's
    collectives. ``device`` as ``local_device`` reads it. Under a process
    group the collectives run even at one rank (a run of one NCCL rank takes
    the route of many)."""
    rank, world = _world()
    if n_devices is not None and n_devices != world:
        raise ValueError(f"create_mesh: {n_devices} data ranks asked, the process group "
                         f"has {world}")
    group = dist.group.WORLD if dist.is_initialized() else None
    return Mesh(group, group, None, rank, world, 0, 1, local_device(device))


def create_event_mesh(n_event: int, n_data: int = 1, device="cuda") -> Mesh:
    """The (data, event) mesh: ``n_data * n_event`` ranks, the batch split
    over ``data``, the event axis over ``event``. Every rank makes every
    group (``new_group`` is collective), in the same order."""
    rank, world = _world()
    if n_data * n_event != world:
        raise ValueError(f"create_event_mesh: {n_data} x {n_event} ranks asked, the "
                         f"process group has {world}")
    data_rank, event_rank = divmod(rank, n_event)
    event_group = data_group = world_group = None
    if dist.is_initialized():
        world_group = dist.group.WORLD
        for d in range(n_data):
            g = dist.new_group([d * n_event + e for e in range(n_event)])
            if d == data_rank:
                event_group = g
        for e in range(n_event):
            g = dist.new_group([d * n_event + e for d in range(n_data)])
            if e == event_rank:
                data_group = g
    return Mesh(world_group, data_group, event_group, data_rank, n_data, event_rank,
                n_event, local_device(device))


# --- the batch --------------------------------------------------------------

def local_rows(x, mesh: Optional[Mesh]):
    """This data rank's rows of a global batch array or tensor (the
    ``data_rank``-th of ``data_size`` equal blocks of axis 0). Raises when
    the batch does not split evenly, as the JAX package's assert does."""
    if mesh is None or mesh.data_size == 1 or x is None:
        return x
    B = x.shape[0]
    if B % mesh.data_size:
        raise ValueError(f"a global batch of {B} does not split over "
                         f"{mesh.data_size} data ranks")
    b = B // mesh.data_size
    return x[mesh.data_rank * b:(mesh.data_rank + 1) * b]


def shard_batch(batch: Any, mesh: Optional[Mesh]) -> Any:
    """This rank's rows of a host batch (nested dicts, tuples and lists of
    arrays or tensors)."""
    if isinstance(batch, dict):
        return {k: shard_batch(v, mesh) for k, v in batch.items()}
    if hasattr(batch, "_fields"):   # a named tuple of arrays
        return type(batch)(*(shard_batch(v, mesh) for v in batch))
    if isinstance(batch, (tuple, list)):
        return type(batch)(shard_batch(v, mesh) for v in batch)
    return local_rows(batch, mesh)


def replicate(tree: Any, mesh: Optional[Mesh]) -> Any:
    """Rank 0's values on every rank: a broadcast from rank 0, in place, of
    a module's parameters and buffers or of each tensor of a sequence."""
    if mesh is None or mesh.world_group is None:
        return tree
    tensors = (list(tree.parameters()) + list(tree.buffers())
               if isinstance(tree, torch.nn.Module) else list(tree))
    with torch.no_grad():
        for t in tensors:
            dist.broadcast(t.data, 0, group=mesh.world_group)
    return tree


def global_rand(shape: Sequence[int], generator: torch.Generator,
                mesh: Optional[Mesh], dtype=None) -> torch.Tensor:
    """``torch.rand`` of a batch whose local shape is ``shape``: drawn at the
    global shape (axis 0 times the data ranks) from ``generator`` on its
    own device, this rank's rows kept."""
    rows = shape[0] * (mesh.data_size if mesh is not None else 1)
    u = torch.rand((rows,) + tuple(shape[1:]), generator=generator,
                   device=generator.device, dtype=dtype)
    return local_rows(u, mesh)


def global_randint(high: int, shape: Sequence[int], generator: torch.Generator,
                   mesh: Optional[Mesh], dtype=torch.int64) -> torch.Tensor:
    """``torch.randint(0, high)`` drawn at the global shape, this rank's
    rows kept (as ``global_rand``)."""
    rows = shape[0] * (mesh.data_size if mesh is not None else 1)
    r = torch.randint(0, high, (rows,) + tuple(shape[1:]), generator=generator,
                      device=generator.device, dtype=dtype)
    return local_rows(r, mesh)


# --- the collectives ----------------------------------------------------------

def _group(mesh: Optional[Mesh], axis: str):
    if mesh is None:
        return None
    return {DATA_AXIS: mesh.data_group, EVENT_AXIS: mesh.event_group,
            WORLD_AXIS: mesh.world_group}[axis]


def _axis_size(mesh: Optional[Mesh], axis: str) -> int:
    if mesh is None:
        return 1
    return {DATA_AXIS: mesh.data_size, EVENT_AXIS: mesh.event_size,
            WORLD_AXIS: mesh.size}[axis]


def _axis_rank(mesh: Mesh, axis: str) -> int:
    return {DATA_AXIS: mesh.data_rank, EVENT_AXIS: mesh.event_rank,
            WORLD_AXIS: mesh.rank}[axis]


def all_sum(x: torch.Tensor, mesh: Optional[Mesh], axis: str = DATA_AXIS) -> torch.Tensor:
    """The SUM of ``x`` over the ranks of ``axis`` (no gradient); ``x``
    itself where the axis has no group."""
    group = _group(mesh, axis)
    if group is None:
        return x
    out = x.detach().clone(memory_format=torch.contiguous_format)
    dist.all_reduce(out, group=group)
    return out


def all_max(x: torch.Tensor, mesh: Optional[Mesh], axis: str = EVENT_AXIS) -> torch.Tensor:
    """The MAX of ``x`` over the ranks of ``axis`` (no gradient): the max
    over the slot-sum all-gather, exact, and a SUM whatever ReduceOps the
    backend carries for the device."""
    if _group(mesh, axis) is None and not (mesh is not None and mesh.program):
        return x
    return all_gather(x, mesh, axis).amax(dim=0)


def all_gather(x: torch.Tensor, mesh: Optional[Mesh], axis: str = EVENT_AXIS) -> torch.Tensor:
    """[size, *x.shape]: every rank's ``x`` of ``axis`` in rank order, the
    SUM of a zero buffer in which each rank fills its own slot (no
    gradient)."""
    if mesh is not None and mesh.program:
        if axis != EVENT_AXIS:
            raise ValueError(f"an exported program gathers over {EVENT_AXIS!r} only")
        return torch.ops.ev2hands.event_all_gather(x, mesh.event_size)
    size = _axis_size(mesh, axis)
    if _group(mesh, axis) is None:
        return x.detach()[None]
    buf = x.new_zeros((size,) + tuple(x.shape))
    buf[_axis_rank(mesh, axis)] = x.detach()
    dist.all_reduce(buf, group=_group(mesh, axis))
    return buf


class _AllReduceSum(torch.autograd.Function):
    """SUM over a group whose backward is the SUM of the cotangents."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return _AllReduceSum.apply(g, ctx.group), None


def all_sum_grad(x: torch.Tensor, mesh: Optional[Mesh], axis: str = DATA_AXIS) -> torch.Tensor:
    """The differentiable SUM of ``x`` over the ranks of ``axis``: the
    gradient of each rank's ``x`` is the sum over ranks of the cotangents
    of the result."""
    group = _group(mesh, axis)
    if group is None:
        return x
    return _AllReduceSum.apply(x, group)


def all_gather_grad(x: torch.Tensor, mesh: Optional[Mesh],
                    axis: str = EVENT_AXIS) -> torch.Tensor:
    """The differentiable ``all_gather``: [size, *x.shape], each rank's
    ``x`` in its slot of a zero buffer, summed over the ranks. The gradient
    of this rank's ``x`` is the sum over ranks of its slot's cotangent."""
    group = _group(mesh, axis)
    if group is None:
        return x[None]
    size, r = _axis_size(mesh, axis), _axis_rank(mesh, axis)
    parts = [x[None] if i == r else x.new_zeros((1,) + tuple(x.shape))
             for i in range(size)]
    return _AllReduceSum.apply(torch.cat(parts, dim=0), group)


def gather_rows(x: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """The global batch of a per-rank [b, ...] result: the data ranks' rows
    in rank order (no gradient)."""
    if mesh is None or mesh.data_group is None:
        return x
    g = all_gather(x, mesh, DATA_AXIS)
    return g.reshape((-1,) + tuple(x.shape[1:]))


def all_sum_grads(params: Sequence[torch.nn.Parameter], mesh: Optional[Mesh],
                  scale: float = 1.0) -> None:
    """Sum each parameter's gradient over every rank of the mesh, in one
    flat buffer and one collective, after multiplying it by ``scale``
    (1 / event ranks: the event ranks' losses are copies of one). A
    parameter without a gradient counts as a zero gradient."""
    if mesh is None or mesh.world_group is None:
        return
    params = [p for p in params if p.requires_grad]
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    flat = torch.cat([p.grad.reshape(-1) for p in params])
    if scale != 1.0:
        flat = flat * scale
    dist.all_reduce(flat, group=mesh.world_group)
    offset = 0
    for p in params:
        n = p.numel()
        p.grad.copy_(flat[offset:offset + n].view_as(p.grad))
        offset += n


# --- an exported program's collectives ------------------------------------------

_installed: Optional[Mesh] = None


def install_mesh(mesh: Optional[Mesh]) -> None:
    """The mesh over which this process's exported programs run their event
    ops (None: none)."""
    global _installed
    _installed = mesh


def installed_mesh(size: int) -> Mesh:
    """The installed mesh, which must have ``size`` event ranks."""
    if _installed is None:
        raise RuntimeError("an event-mesh program runs under the mesh that "
                           "export.load_serving(event_mesh=...) installs")
    if _installed.event_size != size:
        raise RuntimeError(f"the program was exported for {size} event ranks, the "
                           f"installed mesh has {_installed.event_size}")
    return _installed


@torch.library.custom_op("ev2hands::event_all_gather", mutates_args=())
def event_all_gather_op(x: torch.Tensor, size: int) -> torch.Tensor:
    """``all_gather`` over the event ranks of the installed mesh ->
    [size, *x.shape]."""
    mesh = installed_mesh(size)
    if mesh.event_group is None:
        return x[None].clone()
    return all_gather(x, mesh, EVENT_AXIS)


@event_all_gather_op.register_fake
def _event_all_gather_fake(x, size):
    return x.new_empty((size,) + tuple(x.shape))


@torch.library.custom_op("ev2hands::event_shard", mutates_args=())
def event_shard_op(x: torch.Tensor, size: int) -> torch.Tensor:
    """This event rank's block of axis 1 of x, of the installed mesh's
    ``size`` blocks."""
    rank, n = installed_mesh(size).event_rank, x.shape[1] // size
    return x[:, rank * n:(rank + 1) * n].clone()


@event_shard_op.register_fake
def _event_shard_fake(x, size):
    return x.new_empty((x.shape[0], x.shape[1] // size) + tuple(x.shape[2:]))


@torch.library.custom_op("ev2hands::event_rank", mutates_args=())
def event_rank_op(like: torch.Tensor, size: int) -> torch.Tensor:
    """The installed mesh's event rank, an int64 scalar on ``like``'s
    device."""
    return torch.tensor(installed_mesh(size).event_rank, device=like.device)


@event_rank_op.register_fake
def _event_rank_fake(like, size):
    return like.new_empty((), dtype=torch.int64)


# --- processes ----------------------------------------------------------------

class Ranks:
    """Processes started by ``start_ranks``; ``join`` waits for them."""

    def __init__(self, procs, logs, tmp, world_size):
        self.procs, self.logs, self.tmp, self.world_size = procs, logs, tmp, world_size

    def join(self, timeout: float = 600.0) -> List[Any]:
        """Wait for every rank -> what each returned, in rank order. Raises,
        with the tail of every rank's output, if a rank fails or the ranks
        outlast ``timeout`` seconds; every rank is stopped and the files
        removed before this returns."""
        failed = None
        deadline = time.monotonic() + timeout
        try:
            while failed is None:
                rcs = [p.poll() for p in self.procs]
                bad = [(r, rc) for r, rc in enumerate(rcs) if rc not in (None, 0)]
                if bad:
                    failed = bad[0]
                elif all(rc == 0 for rc in rcs):
                    break
                elif time.monotonic() > deadline:
                    failed = (rcs.index(None), f"no exit after {timeout} s")
                else:
                    time.sleep(0.02)
            if failed:
                tails = []
                for rank, log in enumerate(self.logs):
                    log.seek(0)
                    tails.append(f"--- rank {rank} ---\n" + log.read()[-4000:])
                raise RuntimeError(f"rank {failed[0]} of {self.world_size} ended with "
                                   f"{failed[1]}\n" + "\n".join(tails))
            results = []
            for rank in range(self.world_size):
                with open(os.path.join(self.tmp, f"result{rank}.pkl"), "rb") as f:
                    results.append(pickle.load(f))
            return results
        finally:
            for p in self.procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
            for log in self.logs:
                log.close()
            shutil.rmtree(self.tmp, ignore_errors=True)


def start_ranks(target: Callable, world_size: int, *args, backend: str = "gloo",
                env: Optional[dict] = None) -> Ranks:
    """Start ``target(*args)`` in ``world_size`` new processes on this host,
    joined in one process group (``backend``, initialised from a file);
    ``join`` collects what each rank returns. ``target`` is a function at
    the top level of a module file, which each rank imports. Each rank gets
    ``RANK``, ``WORLD_SIZE`` and ``LOCAL_RANK`` (and ``env``) in its
    environment, with ``torch.distributed`` initialised before ``target``
    runs and destroyed after."""
    module = sys.modules[target.__module__]
    spec = dict(file=os.path.abspath(module.__file__), name=target.__name__,
                args=args, backend=backend, world_size=world_size)
    pkg_root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    tmp = tempfile.mkdtemp(prefix="ev2hands_ranks_")
    spec["init"] = f"file://{os.path.join(tmp, 'init')}"
    spec_path = os.path.join(tmp, "spec.pkl")
    with open(spec_path, "wb") as f:
        pickle.dump(spec, f)
    procs, logs = [], []
    for rank in range(world_size):
        e = dict(os.environ, **(env or {}))
        e.update(RANK=str(rank), WORLD_SIZE=str(world_size), LOCAL_RANK=str(rank),
                 PYTHONPATH=os.pathsep.join(
                     [pkg_root, os.path.dirname(spec["file"])]
                     + ([e["PYTHONPATH"]] if e.get("PYTHONPATH") else [])))
        log = open(os.path.join(tmp, f"rank{rank}.log"), "w+")
        logs.append(log)
        procs.append(subprocess.Popen(
            [sys.executable, "-c",
             "from ev2hands_tpu_torch.parallel.mesh import _rank_main; "
             f"_rank_main({spec_path!r})"],
            stdout=log, stderr=subprocess.STDOUT, env=e))
    return Ranks(procs, logs, tmp, world_size)


def run_ranks(target: Callable, world_size: int, *args, backend: str = "gloo",
              timeout: float = 600.0, env: Optional[dict] = None) -> List[Any]:
    """``start_ranks(...).join(timeout)``: the list of what each rank
    returned, in rank order."""
    return start_ranks(target, world_size, *args, backend=backend, env=env).join(timeout)


def _rank_main(spec_path: str) -> None:
    """A rank of ``run_ranks``: join the group, run the target, write its
    result beside the spec."""
    with open(spec_path, "rb") as f:
        spec = pickle.load(f)
    rank = int(os.environ["RANK"])
    mod_spec = importlib.util.spec_from_file_location(
        f"_ranks_{os.path.splitext(os.path.basename(spec['file']))[0]}", spec["file"])
    module = importlib.util.module_from_spec(mod_spec)
    sys.modules[mod_spec.name] = module
    mod_spec.loader.exec_module(module)
    # a collective that waits on a dead rank raises after 5 minutes
    dist.init_process_group(spec["backend"], init_method=spec["init"],
                            world_size=spec["world_size"], rank=rank,
                            timeout=datetime.timedelta(seconds=300))
    try:
        result = getattr(module, spec["name"])(*spec["args"])
    finally:
        dist.destroy_process_group()
    out = os.path.join(os.path.dirname(spec_path), f"result{rank}.pkl")
    with open(out + ".tmp", "wb") as f:
        pickle.dump(result, f)
    os.replace(out + ".tmp", out)
