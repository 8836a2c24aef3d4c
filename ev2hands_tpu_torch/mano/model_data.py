"""MANO model data in numpy: constants, the ``ManoModelData`` container,
the loader of the official ``MANO_{LEFT,RIGHT}.pkl`` assets, and the
deterministic synthetic stand-in used where those licensed pickles are
absent.

The port's own copy of ``ev2hands_tpu/mano/model_data.py`` (no import of
the JAX package). ``synthetic_mano_models(seed)`` gives bit-identical arrays
to the JAX package's for the same seed, and ``load_mano_models`` the same
arrays as its loader. The pickles hold chumpy objects and a scipy sparse
joint regressor: the unpickler puts a stub in place of each chumpy class,
so chumpy need not be installed.
"""

from __future__ import annotations

import dataclasses
import io
import os
import pickle
from typing import Any, Dict

import numpy as np

# MANO kinematic tree: joint k's parent is KINTREE_PARENTS[k]. Joint order:
# 0 wrist, 1-3 index, 4-6 middle, 7-9 pinky, 10-12 ring, 13-15 thumb.
KINTREE_PARENTS = np.array([-1, 0, 1, 2, 0, 4, 5, 0, 7, 8, 0, 10, 11, 0, 13, 14])

# Fingertip vertex ids appended as joints 16..20 (thumb, index, middle, ring,
# pinky tips); the middle tip is vertex 444 on the right hand, 445 on the left.
TIP_VERTEX_IDS_RIGHT = np.array([745, 317, 444, 556, 673])
TIP_VERTEX_IDS_LEFT = np.array([745, 317, 445, 556, 673])

# 16 MANO joints + 5 tips -> the 21-joint layout (wrist, thumb1..4,
# index1..4, middle1..4, ring1..4, pinky1..4).
JOINT_REORDER = np.array(
    [0, 13, 14, 15, 16, 1, 2, 3, 17, 4, 5, 6, 18, 10, 11, 12, 19, 7, 8, 9, 20]
)

N_VERTICES = 778
N_FACES = 1538
N_JOINTS_RAW = 16
N_POSE_FULL = 45          # 15 joints * 3 axis-angle dims
N_POSE_BLENDSHAPES = 135  # 15 joints * 9 rotation-matrix entries


@dataclasses.dataclass
class ManoModelData:
    """Raw MANO model arrays for one hand (float32 / int32 numpy)."""

    side: str                       # 'left' | 'right'
    v_template: np.ndarray          # [778, 3]
    shapedirs: np.ndarray           # [778, 3, 10]
    posedirs: np.ndarray            # [778, 3, 135]
    J_regressor: np.ndarray         # [16, 778]
    lbs_weights: np.ndarray         # [778, 16]
    hands_components: np.ndarray    # [45, 45] PCA basis rows
    hands_mean: np.ndarray          # [45]
    faces: np.ndarray               # [1538, 3] int32

    def __post_init__(self):
        if self.side not in ("left", "right"):
            raise ValueError(f"side must be 'left' or 'right', got {self.side!r}")
        self.v_template = np.asarray(self.v_template, np.float32)
        self.shapedirs = np.asarray(self.shapedirs, np.float32)
        self.posedirs = np.asarray(self.posedirs, np.float32)
        self.J_regressor = np.asarray(self.J_regressor, np.float32)
        self.lbs_weights = np.asarray(self.lbs_weights, np.float32)
        self.hands_components = np.asarray(self.hands_components, np.float32)
        self.hands_mean = np.asarray(self.hands_mean, np.float32)
        self.faces = np.asarray(self.faces, np.int32)

    @property
    def tip_vertex_ids(self) -> np.ndarray:
        return TIP_VERTEX_IDS_LEFT if self.side == "left" else TIP_VERTEX_IDS_RIGHT


class _ChumpyStub:
    """Stands in for a chumpy object of a MANO pickle; keeps its state."""

    def __init__(self, *args, **kwargs):
        self.__dict__.update(kwargs)

    def __setstate__(self, state):
        self.__dict__.update(state)


class _ManoUnpickler(pickle.Unpickler):
    """Resolves chumpy classes to ``_ChumpyStub``, and scipy sparse classes
    to scipy's own where scipy has them (else to the stub)."""

    def find_class(self, module: str, name: str):
        if module.startswith("scipy.sparse"):
            try:
                return super().find_class(module, name)
            except (ImportError, AttributeError):
                return _ChumpyStub
        if module.startswith("chumpy"):
            return _ChumpyStub
        return super().find_class(module, name)


def _to_array(v: Any) -> np.ndarray:
    """A dense numpy array from a numpy array, a chumpy stub or a scipy
    sparse matrix."""
    if isinstance(v, np.ndarray):
        return v
    if hasattr(v, "toarray"):  # scipy sparse
        return np.asarray(v.toarray())
    if isinstance(v, _ChumpyStub):
        d = v.__dict__
        for key in ("x", "a", "v", "r"):
            if key in d:
                return _to_array(d[key])
        raise ValueError(f"cannot extract an array from a chumpy object with keys {list(d)}")
    return np.asarray(v)


def load_mano_pkl(path: str, side: str) -> ManoModelData:
    """One hand from an official MANO pickle, without chumpy."""
    with open(path, "rb") as f:
        data: Dict[str, Any] = _ManoUnpickler(io.BytesIO(f.read()),
                                              encoding="latin1").load()
    return ManoModelData(
        side=side,
        v_template=_to_array(data["v_template"]),
        shapedirs=_to_array(data["shapedirs"])[:, :, :10],
        posedirs=_to_array(data["posedirs"]).reshape(N_VERTICES, 3, N_POSE_BLENDSHAPES),
        J_regressor=_to_array(data["J_regressor"]),
        lbs_weights=_to_array(data["weights"]),
        hands_components=_to_array(data["hands_components"]),
        hands_mean=_to_array(data["hands_mean"]),
        faces=_to_array(data["f"]).astype(np.int64),
    )


def apply_shapedirs_fix(left: ManoModelData, right: ManoModelData) -> bool:
    """The released left-hand asset shares the right hand's first shapedirs
    column instead of mirroring it (the reference's ``model/utils.py``
    fix): where the two are that close, negate the left one in place.
    Returns True if the fix was applied."""
    if np.abs(left.shapedirs[:, 0, :] - right.shapedirs[:, 0, :]).sum() < 1:
        left.shapedirs[:, 0, :] = -left.shapedirs[:, 0, :]
        return True
    return False


def load_mano_models(mano_dir: str) -> Dict[str, ManoModelData]:
    """Both hands from ``{mano_dir}/mano/MANO_{LEFT,RIGHT}.pkl`` (the
    reference's layout under its MANO path) or from ``mano_dir`` itself,
    with the shapedirs fix applied."""
    candidates = [os.path.join(mano_dir, "mano"), mano_dir]
    base = next((c for c in candidates
                 if os.path.isfile(os.path.join(c, "MANO_RIGHT.pkl"))), None)
    if base is None:
        raise FileNotFoundError(
            f"MANO_RIGHT.pkl not found under {candidates}; download the MANO "
            "assets or use synthetic_mano_models() for tests")
    left = load_mano_pkl(os.path.join(base, "MANO_LEFT.pkl"), "left")
    right = load_mano_pkl(os.path.join(base, "MANO_RIGHT.pkl"), "right")
    apply_shapedirs_fix(left, right)
    return {"left": left, "right": right}


def synthetic_mano_models(seed: int = 0) -> Dict[str, ManoModelData]:
    """Deterministic MANO-shaped model data: a hand-sized blob of vertices
    around a valid kinematic chain (five 3-segment fingers from a wrist),
    a softmax joint regressor and distance-based skinning weights, in
    meters (~0.2 m extent)."""
    rng = np.random.RandomState(seed)

    joints = np.zeros((N_JOINTS_RAW, 3), np.float64)
    for fi, root in enumerate([1, 4, 7, 10, 13]):
        direction = np.array([0.02 * (fi - 2), 0.09, 0.002 * fi])
        for s in range(3):
            joints[root + s] = direction * (1.0 + 0.35 * s)

    owner = rng.randint(0, N_JOINTS_RAW, size=N_VERTICES)
    v_template = joints[owner] + rng.randn(N_VERTICES, 3) * 0.012

    d2 = ((joints[:, None, :] - v_template[None, :, :]) ** 2).sum(-1)
    logits = -d2 / 1e-4
    logits -= logits.max(axis=1, keepdims=True)
    J_regressor = np.exp(logits)
    J_regressor /= J_regressor.sum(axis=1, keepdims=True)

    w_logits = -d2.T / 2e-3
    w_logits -= w_logits.max(axis=1, keepdims=True)
    lbs_weights = np.exp(w_logits)
    lbs_weights /= lbs_weights.sum(axis=1, keepdims=True)

    shapedirs = rng.randn(N_VERTICES, 3, 10) * 0.004
    posedirs = rng.randn(N_VERTICES, 3, N_POSE_BLENDSHAPES) * 0.0015

    q, _ = np.linalg.qr(rng.randn(N_POSE_FULL, N_POSE_FULL))
    hands_components = q * 2.0
    hands_mean = rng.randn(N_POSE_FULL) * 0.1

    faces = rng.randint(0, N_VERTICES, size=(N_FACES, 3)).astype(np.int64)

    def make(side: str) -> ManoModelData:
        vt = v_template.copy()
        vt[:, 0] *= -1.0 if side == "left" else 1.0
        return ManoModelData(
            side=side, v_template=vt, shapedirs=shapedirs, posedirs=posedirs,
            J_regressor=J_regressor, lbs_weights=lbs_weights,
            hands_components=hands_components, hands_mean=hands_mean,
            faces=faces,
        )

    return {"left": make("left"), "right": make("right")}
