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
register the ops: ``load_serving`` does that. One card only: the JAX
package's ``platforms`` and data-parallel mesh do not apply.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from ev2hands_tpu_torch.config import Config
from ev2hands_tpu_torch.events.erpc import erpc_real_batch_transform
from ev2hands_tpu_torch.mano.layer import ManoParams
from ev2hands_tpu_torch.model.tehnet import TEHNet, apply_mano

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
                   path: Optional[str] = None) -> torch.export.ExportedProgram:
    """Export the serving function for ``batch_size`` windows of up to
    ``max_events`` events on the device of ``net``'s weights (and of
    ``hands``), optionally saved to ``path`` (``.pt2``). The net is put in
    eval mode. The export runs outside ``torch.inference_mode``, under
    ``no_grad``."""
    net.eval()
    device = next(net.parameters()).device
    n = cfg.model.n_points
    args = (torch.zeros((batch_size, max_events, 4), device=device),
            torch.ones((batch_size, max_events), dtype=torch.bool, device=device),
            torch.zeros((batch_size, n), dtype=torch.float64, device=device))
    with torch.no_grad():
        program = torch.export.export(_Serving(net, make_serving_fn(net, hands, cfg)),
                                      args, strict=False)
    if path:
        torch.export.save(program, path)
    return program


def load_serving(path: str):
    """A saved artifact -> callable ``(events, valid, uniforms) -> outputs``,
    run under ``torch.inference_mode`` (the program's weights are
    parameters, so autograd would otherwise keep every activation).
    Imports the port's kernel modules first, which registers the ops."""
    import ev2hands_tpu_torch.ops.fps  # noqa: F401
    import ev2hands_tpu_torch.ops.grouping  # noqa: F401

    module = torch.export.load(path).module()

    @torch.inference_mode()
    def serve(events, valid, uniforms):
        return module(events, valid, uniforms)

    return serve


def op_counts(program: torch.export.ExportedProgram) -> Dict[str, int]:
    """Nodes of each ``ev2hands::`` op in an exported program's graph."""
    counts: Dict[str, int] = {}
    for node in program.graph.nodes:
        name = str(node.target) if node.op == "call_function" else ""
        if name.startswith("ev2hands."):
            key = name.split(".")[1]
            counts[key] = counts.get(key, 0) + 1
    return counts
