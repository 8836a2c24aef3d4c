"""TEHNet weights for the port.

``flax_to_torch`` maps the JAX package's variables (nested dicts of numpy
arrays, ``{"params": ..., "batch_stats": ...}``) to a state dict that the
port's ``TEHNet`` loads with ``strict=True``. Names and layouts are the
reference's torch ones, so a released reference ``.pth`` fits the same
modules. This is the port's own copy of the mapping in
``ev2hands_tpu/checkpoint.py`` (``flax_to_torch``).

``load_pth_state_dict`` reads a reference ``.pth`` checkpoint into the same
state dict. ``init_weights`` makes seeded random weights with non-trivial
BatchNorm statistics, for runs without a trained checkpoint.
"""

from __future__ import annotations

import math
import re
from typing import Any, Dict

import numpy as np
import torch

from ev2hands_tpu_torch.config import ModelConfig

# flax module name -> (torch Sequential slot, layer kind) for the fixed heads
_CLASSIFIER = {"classifier_conv_0": ("0", "conv1d1"),
               "classifier_bn": ("2", "bn"),
               "classifier_conv_1": ("4", "conv1d1")}
_QUERY = {"conv_0": ("0", "conv1d3"), "bn_0": ("2", "bn"),
          "conv_1": ("4", "conv1d3"), "bn_1": ("5", "bn")}
_REGRESSOR = {"fc_0": ("0", "linear"), "bn": ("2", "bn"), "fc_1": ("4", "linear")}
_BN_FIELDS = {"scale": "weight", "bias": "bias", "mean": "running_mean",
              "var": "running_var"}


def _flatten(tree: Dict[str, Any], prefix=()) -> Dict[tuple, np.ndarray]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = np.asarray(v)
    return out


def _emit(out: Dict[str, torch.Tensor], torch_key: str, kind: str, leaf: str,
          w: np.ndarray) -> None:
    if kind == "bn":
        field = _BN_FIELDS.get(leaf)
    elif leaf == "bias":
        field = "bias"
    elif leaf == "kernel":
        field = "weight"
        w = {"conv2d1": lambda a: a.T[:, :, None, None],
             "conv1d1": lambda a: a.T[:, :, None],
             "conv1d3": lambda a: a.transpose(2, 1, 0),
             "linear": lambda a: a.T}[kind](w)
    else:
        field = None
    if field is None:
        raise ValueError(f"unexpected leaf {leaf!r} of {torch_key} ({kind})")
    out[f"{torch_key}.{field}"] = torch.from_numpy(np.ascontiguousarray(w))


def flax_to_torch(variables: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX TEHNet variables -> the port's (and the reference's) state dict."""
    flat = _flatten(variables["params"])
    flat.update(_flatten(variables["batch_stats"]))
    out: Dict[str, torch.Tensor] = {}
    for parts, w in flat.items():
        leaf, top = parts[-1], parts[0]
        if top in ("sa1", "sa2", "sa3", "fp1", "fp2", "fp3") or (
            top.endswith("_mano_regressor") and parts[1] in ("sa1", "sa2")
        ):
            name, prefix = parts[-2], ".".join(parts[:-2])
            is_fp = parts[-3].startswith("fp")  # FP blocks are Conv1d in torch
            m2 = re.match(r"(conv|bn)_(\d+)_(\d+)$", name)
            m1 = re.match(r"(conv|bn)_(\d+)$", name)
            if m2:
                kind, i, j = m2.groups()
                blocks = "conv_blocks" if kind == "conv" else "bn_blocks"
                _emit(out, f"{prefix}.{blocks}.{i}.{j}",
                      "conv2d1" if kind == "conv" else "bn", leaf, w)
            elif m1:
                kind, j = m1.groups()
                mlp = "mlp_convs" if kind == "conv" else "mlp_bns"
                conv = "conv1d1" if is_fp else "conv2d1"
                _emit(out, f"{prefix}.{mlp}.{j}",
                      conv if kind == "conv" else "bn", leaf, w)
            else:
                raise ValueError(f"unexpected block leaf {'.'.join(parts)}")
        elif top in _CLASSIFIER:
            slot, kind = _CLASSIFIER[top]
            _emit(out, f"classifier.{slot}", kind, leaf, w)
        elif top in ("left_query_conv", "right_query_conv"):
            slot, kind = _QUERY[parts[1]]
            _emit(out, f"{top}.{slot}", kind, leaf, w)
        elif top.endswith("_mano_regressor"):
            slot, kind = _REGRESSOR[parts[1]]
            _emit(out, f"{top}.mano_regressor.{slot}", kind, leaf, w)
        else:
            raise ValueError(f"unexpected top-level {'.'.join(parts)}")
    return out


def load_pth_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """A reference ``.pth`` -> the state dict that ``TEHNet`` loads with
    ``strict=True`` (CPU tensors). Unwraps the trainer's ``{"state_dict":
    ...}`` blob, strips DataParallel's ``module.`` prefixes and drops
    BatchNorm's ``num_batches_tracked`` counters, which the port does not
    keep. The file is unpickled: load only checkpoints you trust."""
    blob = torch.load(path, map_location="cpu", weights_only=False)
    state = blob.get("state_dict", blob) if isinstance(blob, dict) else blob
    out = {}
    for k, v in state.items():
        if k.startswith("module."):
            k = k[len("module."):]
        if k.endswith("num_batches_tracked"):
            continue
        out[k] = torch.as_tensor(v)
    return out


def init_weights(generator: torch.Generator,
                 cfg: ModelConfig = ModelConfig()) -> Dict[str, torch.Tensor]:
    """Seeded random TEHNet state dict (CPU tensors): conv and linear weights
    ~ N(0, 1/fan_in) (flax's default scale), the regressor heads' output
    layer 100x smaller so MANO parameters stay O(1), biases ~ 0.1 N, and
    BatchNorm with weight ~ 1 + 0.1 N, bias ~ 0.1 N, running_mean ~ 0.1 N
    and running_var ~ U[0.5, 1.5]."""
    from ev2hands_tpu_torch.model.tehnet import TEHNet

    shapes = {k: v.shape for k, v in TEHNet(cfg, device="meta").state_dict().items()}
    out = {}
    for key in sorted(shapes):
        shape = shapes[key]

        def randn(scale):
            return torch.randn(shape, generator=generator) * scale

        if key.endswith("running_var"):
            out[key] = 0.5 + torch.rand(shape, generator=generator)
        elif key.endswith("running_mean"):
            out[key] = randn(0.1)
        elif key.endswith(".weight") and len(shape) == 1:   # BatchNorm
            out[key] = 1.0 + randn(0.1)
        elif key.endswith(".bias"):
            out[key] = randn(0.1)
        else:
            scale = math.sqrt(1.0 / math.prod(shape[1:]))
            if key.endswith("mano_regressor.4.weight"):
                scale *= 0.01
            out[key] = randn(scale)
    return out
