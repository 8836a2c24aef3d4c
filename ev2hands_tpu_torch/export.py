"""Serving export: the whole inference pipeline as one ``torch.export``
artifact (``.pt2``) with the weights baked in.

Counterpart of ``ev2hands_tpu/export.py``. The serving function is the
real-data ERPC transform -> ``TEHNet`` eval -> MANO, at fixed shapes: the
batch and the padded window size are fixed at export time, as in the JAX
package. Its random input is explicit: the JAX artifact takes a uint32[2]
key, this one ``uniforms`` [B, n_points] float64 in [0, 1), which
``events.erpc.draws_from_uniforms`` turns into the resample indices (so a
caller can hand it ``torch.rand`` draws, and a test the indices of another
implementation).

The kernels stay in the artifact: FPS and the block-sparse grouping are
registered ops (``torch.ops.ev2hands.fps``, ``.msg_scale_sparse``,
``.msg_fused_scales_sparse``), so the exported graph holds one node per
call, and the loaded program launches the CUDA kernels when it runs on the
card, as the JAX artifact bakes in its Pallas kernels when exported on a
TPU. The artifact runs on the device its weights were exported on. Unlike
the JAX package's StableHLO, loading needs this package imported, to
register the ops: ``load_serving`` does that. The JAX package's
``platforms`` do not apply.

Data parallel: the JAX package exports one program sharded over N chips
(``export.py:82-83``, ``:111-126``). ``torch.export`` has no sharded
program, so ``export_serving(..., data_parallel=N)`` exports the one-card
program at batch B / N, and ``load_serving(path, devices)`` loads it once
a device and splits and joins the batch on the host: each shard is the
one-card program's.

Event mesh (``export.py:93-95`` of the JAX package): ``export_serving(net,
..., event_mesh=mesh)`` exports the serving function of a
``TEHNet(event_mesh=mesh)`` with ``cfg.event_parallel``, each event rank's
part of it, at the batch of one data rank. The event route's all-gathers,
its shard of the events, its rank and each sharded FPS draw become
registered ops (``torch.ops.ev2hands.event_all_gather``, ``.event_shard``,
``.event_rank``, ``parallel/mesh.py``; ``.event_fps``,
``parallel/event_parallel.py``), so the graph holds no process group and
no rank, and one artifact serves every rank: ``load_serving(path,
event_mesh=mesh)``, called on every rank of the mesh, installs the mesh for
those ops.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence

import torch
from torch import nn

from ev2hands_tpu_torch.config import Config
from ev2hands_tpu_torch.events.erpc import erpc_real_batch_transform
from ev2hands_tpu_torch.mano.layer import ManoParams
from ev2hands_tpu_torch.model.tehnet import TEHNet, apply_mano
from ev2hands_tpu_torch.parallel.mesh import Mesh, gather_rows, install_mesh, local_rows

HAND_KEYS = ("global_orient", "hand_pose", "betas", "transl", "vertices", "j3d")


def make_serving_fn(net: TEHNet, hands: Dict[str, ManoParams], cfg: Config):
    """The serving function ``fn(events [B, N, 4] raw (x, y, t in ms,
    polarity), valid [B, N] bool, uniforms [B, n_points] float64) ->
    outputs``: per-event segmentation logits (``class_logits``) and their
    argmax (``seg``), the ERPC cloud (``events``), and per hand
    ``{left,right}_{global_orient,hand_pose,betas,transl,vertices,j3d}``
    (meters), the JAX function's keys. ``net`` must be in eval mode."""
    if net.training:
        raise ValueError("make_serving_fn: put the net in eval mode first")
    sensor = cfg.sensor

    def fn(events: torch.Tensor, valid: torch.Tensor,
           uniforms: torch.Tensor) -> Dict[str, torch.Tensor]:
        erpc = erpc_real_batch_transform(
            events, valid, uniforms=uniforms, width=sensor.width,
            height=sensor.height, n_out=cfg.model.n_points)
        outputs = apply_mano(hands, net(erpc.events))
        out = {"class_logits": outputs["class_logits"],
               "seg": torch.argmax(outputs["class_logits"], dim=-1),
               "events": erpc.events}
        for side in ("left", "right"):
            for k in HAND_KEYS:
                out[f"{side}_{k}"] = outputs[side][k]
        return out

    return fn


class _Serving(nn.Module):
    """The serving function as a module: ``net`` is a submodule, so its
    weights are the program's parameters and buffers; the MANO constants
    become the program's constants."""

    def __init__(self, net: TEHNet, fn):
        super().__init__()
        self.net = net
        self.fn = fn

    def forward(self, events, valid, uniforms):
        return self.fn(events, valid, uniforms)


def export_serving(net: TEHNet, hands: Dict[str, ManoParams], cfg: Config,
                   batch_size: int, max_events: int = 8192,
                   path: Optional[str] = None, data_parallel: int = 0,
                   event_mesh: Optional[Mesh] = None) -> torch.export.ExportedProgram:
    """Export the serving function for ``batch_size`` windows of up to
    ``max_events`` events on the device of ``net``'s weights (and of
    ``hands``), optionally saved to ``path`` (``.pt2``). The net is put in
    eval mode. The export runs outside ``torch.inference_mode``, under
    ``no_grad``. ``data_parallel=N`` exports the program of one of N
    devices, batch ``batch_size / N`` (which must divide), for
    ``load_serving(path, devices)``. ``event_mesh``: the program of one rank
    of that (data, event) mesh, batch ``batch_size`` / its data ranks, for
    ``load_serving(path, event_mesh=...)``; ``net`` must be under that mesh
    with ``cfg.event_parallel``. Tracing runs no collective, so one process
    exports it."""
    if event_mesh is not None:
        if net.event_mesh is None:
            raise ValueError("export_serving: an event mesh needs TEHNet(event_mesh=...) "
                             "with cfg.event_parallel")
        data_parallel = event_mesh.data_size
    if data_parallel:
        if batch_size % data_parallel:
            raise ValueError(f"export_serving: a batch of {batch_size} does not "
                             f"split over {data_parallel} devices")
        batch_size //= data_parallel
    net.eval()
    device = next(net.parameters()).device
    n = cfg.model.n_points
    args = (torch.zeros((batch_size, max_events, 4), device=device),
            torch.ones((batch_size, max_events), dtype=torch.bool, device=device),
            torch.zeros((batch_size, n), dtype=torch.float64, device=device))
    live = net.event_mesh
    if event_mesh is not None:
        net.set_mesh(event_mesh=dataclasses.replace(event_mesh, program=True))
    try:
        with torch.no_grad():
            program = torch.export.export(
                _Serving(net, make_serving_fn(net, hands, cfg)), args, strict=False)
    finally:
        if event_mesh is not None:
            net.set_mesh(event_mesh=live)
    if path:
        torch.export.save(program, path)
    return program


def load_serving(path: str, devices: Optional[Sequence] = None,
                 event_mesh: Optional[Mesh] = None):
    """A saved artifact -> callable ``(events, valid, uniforms) -> outputs``,
    run under ``torch.inference_mode`` (the program's weights are
    parameters, so autograd would otherwise keep every activation).
    Imports the port's kernel modules first, which registers the ops.

    ``event_mesh`` (an ``event_mesh`` export), on every rank of the mesh:
    the program loads on the mesh's device, which installs the mesh for its
    event ops; the callable takes the global batch, runs this data rank's
    rows and returns the global batch's outputs, all-gathered over the data
    ranks (every event rank returns them).

    ``devices`` (a ``data_parallel`` export): the program loads once a
    device, and the callable splits the batch into ``len(devices)`` equal
    shards, runs shard i on ``devices[i]`` and joins the outputs on the
    inputs' device. A device other than the artifact's gets the program's
    weights, constants and device arguments moved to it."""
    import ev2hands_tpu_torch.ops.fps  # noqa: F401
    import ev2hands_tpu_torch.ops.grouping  # noqa: F401

    if event_mesh is not None:
        install_mesh(event_mesh)
        module = _on_device(torch.export.load(path).module(), event_mesh.device)

        @torch.inference_mode()
        def serve_ranks(events, valid, uniforms):
            out = module(*(local_rows(t, event_mesh).to(event_mesh.device)
                           for t in (events, valid, uniforms)))
            return {k: gather_rows(v, event_mesh) for k, v in out.items()}

        return serve_ranks

    if devices is None:
        module = torch.export.load(path).module()

        @torch.inference_mode()
        def serve(events, valid, uniforms):
            return module(events, valid, uniforms)

        return serve

    return split_serving([_on_device(torch.export.load(path).module(), torch.device(d))
                          for d in devices], devices)


def split_serving(programs: Sequence, devices: Sequence):
    """Serving callables, program i on ``devices[i]`` -> one callable that
    splits a batch into ``len(programs)`` equal shards, runs shard i on
    program i and joins the outputs, in shard order, on the inputs'
    device."""
    n = len(programs)

    @torch.inference_mode()
    def serve(events, valid, uniforms):
        if events.shape[0] % n:
            raise ValueError(f"a batch of {events.shape[0]} does not split over "
                             f"{n} devices")
        shards = zip(*(t.chunk(n) for t in (events, valid, uniforms)))
        outs = [p(*(t.to(d) for t in shard))
                for p, d, shard in zip(programs, devices, shards)]
        return {k: torch.cat([o[k].to(events.device) for o in outs]) for k in outs[0]}

    return serve


def _on_device(module: nn.Module, device: torch.device) -> nn.Module:
    """A loaded program on ``device``: its parameters, buffers and tensor
    constants moved, and the device arguments of its graph's calls
    rewritten. A program already there is returned as it is."""
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    first = next(iter(module.state_dict().values()))
    if first.device == device:
        return module
    module.to(device)
    for name, value in list(vars(module).items()):
        if torch.is_tensor(value) and value.device != device:
            setattr(module, name, value.to(device))
    for node in module.graph.nodes:
        if isinstance(node.kwargs.get("device"), torch.device):
            node.update_kwarg("device", device)
    module.recompile()
    return module


def op_counts(program: torch.export.ExportedProgram) -> Dict[str, int]:
    """Nodes of each ``ev2hands::`` op in an exported program's graph: the
    kernels' and, in an event-mesh program, the event ops'."""
    counts: Dict[str, int] = {}
    for node in program.graph.nodes:
        name = str(node.target) if node.op == "call_function" else ""
        if name.startswith("ev2hands."):
            key = name.split(".")[1]
            counts[key] = counts.get(key, 0) + 1
    return counts
