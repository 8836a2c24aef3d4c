"""Synthetic Ev2Hands-S generation: MANO sequences -> rendered frames ->
ESIM events, written as pickle parts.

Counterpart of ``ev2hands_tpu/datagen/generate.py``. For each frame the
device poses both hands (MANO, and the forearms in the realistic scene),
rasterises the scene, turns it into Bayer log intensity and integrates
ESIM; only the compact events and the class map go to the host, which
expands the events, labels them from the class map and writes parts that
``datagen.stitch`` merges into the Ev2Hands-S layout.

The realistic scene's random draws (the sequence's background, each
frame's point lights) come from a ``torch.Generator`` on the CPU seeded
from the sequence's seed (``sequence_draws``), so a run on the card and
one on the CPU take the same draws; ``simulate_sequence`` also takes them
given. The skin colours come from a numpy ``RandomState``, as in the JAX
package. Workers shard the sequences as ``count % n_workers == worker_id``.
The entry points run on the card unless the caller passes a CPU device.
"""

from __future__ import annotations

import os
import pickle
import time
from typing import Dict, Iterator, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ev2hands_tpu_torch.config import DEFAULT_CONFIG, HAND_COLOR, Config
from ev2hands_tpu_torch.datagen.interhand import AxisAngleToPca
from ev2hands_tpu_torch.datagen.meshes import (
    forearm_mesh,
    forearm_vertices,
    random_skin_vertex_colors,
)
from ev2hands_tpu_torch.datagen.rasterizer import (
    random_background,
    rasterize_scene,
    render_two_hands,
    sample_train_lights,
)
from ev2hands_tpu_torch.mano.layer import ManoParams, create_mano_params, mano_forward
from ev2hands_tpu_torch.mano.model_data import ManoModelData
from ev2hands_tpu_torch.ops.esim import (
    CompactEvents,
    EsimState,
    bayer_mask,
    esim_init,
    esim_step,
    expand_compact_events,
    log_intensity,
)
from ev2hands_tpu_torch.train import check_device

# The forearms' material id in the rasteriser. The reference's segmentation
# pass leaves the forearms untextured, so their events are labelled
# background while the forearms still occlude the hands and make events:
# the emitted labels map this id to 0.
FOREARM_MATERIAL = 3
# the plain scene's constant grey background
PLAIN_BACKGROUND = 159.0 / 255.0


def scene_topology(faces: np.ndarray, cfg: Config):
    """The realistic scene's fixed triangles, in the order [left hand, left
    forearm, right hand, right forearm] -> (faces [T, 3] int32, materials
    [T] int32, total vertex count, vertices of one forearm)."""
    faces = np.asarray(faces, np.int32)
    V = 778
    fa_v, fa_f = forearm_mesh(np.zeros(3), np.array([1.0, 0, 0]))
    nfa = len(fa_v)

    all_f, all_m = [], []
    offset = 0
    for mat in (1, 2):  # left, right
        all_f.append(faces + offset)
        all_m.append(np.full(len(faces), mat, np.int32))
        offset += V
        if cfg.datagen.add_forearms:
            all_f.append(fa_f + offset)
            all_m.append(np.full(len(fa_f), FOREARM_MATERIAL, np.int32))
            offset += nfa
    return np.concatenate(all_f), np.concatenate(all_m), offset, nfa


class FrameSimulator:
    """One frame of the generator on the hands' device, in stages:
    ``meshes`` (MANO and the forearms), ``render``, ``log_frame`` (the
    composite over the background and the Bayer log intensity) and
    ``integrate`` (``esim_step``). Calling it runs all four.

    With ``cfg.datagen.realistic_scene``: Gouraud-shaded vertex colours
    (``vertex_colors`` [V_total, 3], HAND_COLOR where not given), forearms
    following the wrists, the frame's point lights and the sequence's
    background. Otherwise flat-shaded hands on a constant grey."""

    def __init__(self, hands: Dict[str, ManoParams], faces: np.ndarray, cfg: Config,
                 vertex_colors: Optional[np.ndarray] = None):
        self.hands, self.cfg = hands, cfg
        self.width, self.height = W, H = cfg.sensor.width, cfg.sensor.height
        dev = hands["left"].v_template.device
        self.projection = torch.as_tensor(cfg.camera.projection_matrix(W, H),
                                          dtype=torch.float32, device=dev)
        self.mask = torch.as_tensor(bayer_mask(H, W), device=dev)
        self.realistic = cfg.datagen.realistic_scene
        if self.realistic:
            all_faces, materials, n_total, _ = scene_topology(faces, cfg)
            self.faces = torch.as_tensor(all_faces, dtype=torch.long, device=dev)
            self.materials = torch.as_tensor(materials, device=dev)
            if vertex_colors is None:
                vertex_colors = np.tile(np.asarray(HAND_COLOR, np.float32), (n_total, 1))
            if vertex_colors.shape != (n_total, 3):
                raise ValueError(f"vertex_colors has shape {vertex_colors.shape}, "
                                 f"want {(n_total, 3)}")
            self.vertex_colors = torch.as_tensor(vertex_colors, dtype=torch.float32,
                                                 device=dev)
        else:
            self.faces = np.asarray(faces, np.int32)
            self.color = torch.tensor(HAND_COLOR, dtype=torch.float32, device=dev)

    def meshes(self, params: Dict[str, Dict[str, torch.Tensor]]) -> List[torch.Tensor]:
        """Both hands' vertices [778, 3] (each followed by its forearm's in
        the realistic scene), in the scene's order."""
        verts = []
        forearms = self.realistic and self.cfg.datagen.add_forearms
        for side in ("left", "right"):
            p = params[side]
            out = mano_forward(self.hands[side], p["global_orient"], p["hand_pose"],
                               p["betas"], p["transl"])
            verts.append(out.vertices)
            if forearms:
                j = out.joints
                # down the arm: the wrist minus the middle finger's MCP
                verts.append(forearm_vertices(j[0], j[0] - j[9]))
        return verts

    def render(self, verts: List[torch.Tensor], light_pos: Optional[torch.Tensor] = None,
               light_int: Optional[torch.Tensor] = None):
        """-> ``ShadedRasterOutput`` (realistic) or ``RasterOutput``."""
        W, H = self.width, self.height
        if self.realistic:
            return rasterize_scene(torch.cat(verts, dim=0), self.faces, self.materials,
                                   self.vertex_colors, light_pos, light_int,
                                   self.projection, W, H, self.cfg.datagen.ambient)
        return render_two_hands(verts[0], verts[1], self.faces, self.projection, W, H)

    def log_frame(self, raster, background: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The render over the background, in [0, 255] -> log intensity [H, W]."""
        hit = raster.class_id[..., None] > 0
        if self.realistic:
            rgb = torch.where(hit, raster.rgb, background) * 255.0
        else:
            shaded = raster.intensity[..., None] * self.color[None, None, :]
            rgb = torch.where(hit, shaded, PLAIN_BACKGROUND) * 255.0
        return log_intensity(rgb, self.mask)

    def integrate(self, state: EsimState, log_frame: torch.Tensor, t_ns
                  ) -> Tuple[EsimState, CompactEvents]:
        e = self.cfg.esim
        return esim_step(state, log_frame, t_ns, e.positive_threshold,
                         e.negative_threshold, e.max_events_per_pixel,
                         e.refractory_period_ns)

    def __call__(self, state: EsimState, params, t_ns,
                 light_pos: Optional[torch.Tensor] = None,
                 light_int: Optional[torch.Tensor] = None,
                 background: Optional[torch.Tensor] = None,
                 ) -> Tuple[EsimState, CompactEvents, torch.Tensor]:
        """-> (new state, the frame's compact events, class map [H, W])."""
        raster = self.render(self.meshes(params), light_pos, light_int)
        state, events = self.integrate(state, self.log_frame(raster, background), t_ns)
        return state, events, raster.class_id


def make_frame_simulator(hands: Dict[str, ManoParams], faces: np.ndarray, cfg: Config,
                         vertex_colors: Optional[np.ndarray] = None) -> FrameSimulator:
    """The frame function ``(state, params, t_ns, light_pos, light_int,
    background) -> (state, compact events, class map)`` on the hands'
    device."""
    return FrameSimulator(hands, faces, cfg, vertex_colors)


class SequenceDraws(NamedTuple):
    """The realistic scene's random inputs of one sequence."""

    background: torch.Tensor                          # [H, W, 3] in [0, 1]
    lights: List[Tuple[torch.Tensor, torch.Tensor]]   # a frame: ([5, 3], [5])


def sequence_draws(seed: int, n_frames: int, cfg: Config) -> SequenceDraws:
    """The background, then each frame's lights, from a CPU generator
    seeded ``seed``."""
    gen = torch.Generator().manual_seed(seed)
    background = random_background(gen, cfg.sensor.height, cfg.sensor.width,
                                   cfg.datagen.background_cells)
    return SequenceDraws(background, [sample_train_lights(gen) for _ in range(n_frames)])


def events_and_labels(compact: CompactEvents, seg: np.ndarray
                      ) -> Tuple[np.ndarray, np.ndarray]:
    """A frame's compact events (tensors or numpy) and its class map [H, W]
    on the host -> (events [N, 4] float64, labels [N] int64 read from the
    class map at each event's pixel, forearm pixels labelled background)."""
    events = expand_compact_events(compact)
    labels = (seg[events[:, 1].astype(int), events[:, 0].astype(int)]
              if len(events) else np.zeros(0))
    return events, np.where(labels == FOREARM_MATERIAL, 0, labels).astype(np.int64)


def pca_from_aa(pose_aa: np.ndarray, model: ManoModelData, n_comps: int) -> np.ndarray:
    """45-dim axis-angle -> n_comps PCA coefficients through the inverse basis."""
    return AxisAngleToPca(model)(pose_aa)[..., :n_comps]


def hand_params(hand_list: List[Dict], to_pca: Dict[str, AxisAngleToPca], n_comps: int,
                device) -> Tuple[Dict[str, Dict[str, torch.Tensor]], Dict]:
    """One frame's hands (dicts with ``hand_type, pose (48), shape, trans``)
    -> (both hands' MANO inputs on ``device``, a hand absent from the frame
    10 m away; the frame's annotation entry: the global orientation, all 45
    PCA components, shape and translation of each present hand)."""
    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    far = {"global_orient": t(np.zeros(3)), "hand_pose": t(np.zeros(n_comps)),
           "betas": t(np.zeros(10)), "transl": t(np.full(3, 10.0))}
    params = {"left": far, "right": far}
    info = {}
    for hand in hand_list:
        side = hand["hand_type"]
        pose = np.asarray(hand["pose"], np.float32).reshape(-1)
        go, finger_aa = pose[:3], pose[3:48]
        pca = to_pca[side](finger_aa[None])[0]       # all 45 components
        params[side] = {"global_orient": t(go), "hand_pose": t(pca[:n_comps]),
                        "betas": t(hand["shape"][:10]), "transl": t(hand["trans"])}
        info[side] = {
            "global_orient": go,
            "hand_pose": pca,
            "shape": np.asarray(hand["shape"][:10], np.float32),
            "trans": np.asarray(hand["trans"], np.float32),
        }
    return params, info


def simulate_sequence(
    frames: List[List[Dict]],
    hands_data: Dict[str, ManoModelData],
    cfg: Config = DEFAULT_CONFIG,
    n_pose_comps: Optional[int] = None,
    seed: int = 0,
    device="cuda",
    draws: Optional[SequenceDraws] = None,
) -> Iterator[Dict]:
    """One interpolated sequence through the simulator on ``device``.

    ``frames``: a list (one per output frame) of hand dicts with keys
    ``hand_type, pose (48 = 3 global + 45 axis-angle), shape, trans``.
    Yields a dict a frame: ``events`` [N, 4] (x, y, t_ns, p), ``event_labels``
    [N] (forearms folded into background) and ``camera_hand_info`` (the
    annotation entry).

    The appearance is drawn a sequence (``seed``): skin colours from a
    numpy ``RandomState``, the background and each frame's lights from
    ``sequence_draws`` unless ``draws`` gives them."""
    device = check_device(device, "simulate_sequence")
    n_comps = n_pose_comps or cfg.mano.n_pose_comps
    hands = {s: create_mano_params(hands_data[s], n_comps, device=device)
             for s in ("left", "right")}
    to_pca = {s: AxisAngleToPca(hands_data[s]) for s in ("left", "right")}
    faces = np.asarray(hands_data["left"].faces, np.int32)

    W, H = cfg.sensor.width, cfg.sensor.height
    rng = np.random.RandomState(seed)
    if cfg.datagen.realistic_scene:
        _, _, n_total, _ = scene_topology(faces, cfg)
        vertex_colors = random_skin_vertex_colors(n_total, rng)
        draws = draws or sequence_draws(seed, len(frames), cfg)
        background = draws.background.to(device)
    else:
        vertex_colors, background = None, None
    sim = make_frame_simulator(hands, faces, cfg, vertex_colors)

    state = esim_init(H, W, device=device)
    dt_ns = 1e9 / cfg.esim.simulator_fps

    for fi, hand_list in enumerate(frames):
        frame_params, info = hand_params(hand_list, to_pca, n_comps, device)
        lights = ((draws.lights[fi][0].to(device), draws.lights[fi][1].to(device))
                  if cfg.datagen.realistic_scene else (None, None))
        state, compact, class_id = sim(state, frame_params, np.float32(fi * dt_ns),
                                       *lights, background)
        events, labels = events_and_labels(compact, class_id.cpu().numpy())
        yield {
            "events": events.astype(np.float64),
            "event_labels": labels,
            "camera_hand_info": info,
        }


def generate(
    sequences: Iterator,
    hands_data: Dict[str, ManoModelData],
    out_dir: str,
    mode: str = "train",
    cfg: Config = DEFAULT_CONFIG,
    n_workers: int = 1,
    worker_id: int = 0,
    frames_per_part: int = 1000,
    verbose: bool = True,
    device="cuda",
) -> List[str]:
    """Pickle parts ``{mode}_w{worker_id:02d}_part{k:06d}.pickle`` under
    ``out_dir`` for this worker's share of ``sequences`` (a sequence's seed
    is its index, so augmented copies of one capture differ) -> their
    paths."""
    device = check_device(device, "generate")
    os.makedirs(out_dir, exist_ok=True)
    parts: List[str] = []
    part_frames: List[Dict] = []
    part_idx = 0
    st = time.time()
    n_frames = 0

    def flush():
        nonlocal part_idx, part_frames
        if not part_frames:
            return
        path = os.path.join(out_dir, f"{mode}_w{worker_id:02d}_part{part_idx:06d}.pickle")
        with open(path, "wb") as f:
            pickle.dump(part_frames, f)
        parts.append(path)
        part_idx += 1
        part_frames = []

    for count, frames in enumerate(sequences):
        if count % n_workers != worker_id:
            continue
        for frame in simulate_sequence(frames, hands_data, cfg, seed=count, device=device):
            part_frames.append(frame)
            n_frames += 1
            if len(part_frames) >= frames_per_part:
                flush()
                if verbose:
                    fps = n_frames / (time.time() - st)
                    print(f"[gen w{worker_id}] {n_frames} frames, {fps:.1f} fps")
    flush()
    return parts
