"""The port's training step against the JAX package on the CPU: the whole
slice (TEHNet in training mode -> MANO -> losses with collision ->
gradients) in float64 on the three gather routes (index, one-hot and
``uv_split_gather``), the finetuning step on Ev2Hands-R
(``finetune.make_finetune_step``, the same net with ``real_losses``) in
float64, and the slice's parts: ERPC with augmentation, the collision loss,
Adam, and the step itself.

Float64 for the slice: in float32 the gradient cosines of a 20-layer chain
drift to about 0.99 from rounding alone, so tolerances loose enough for
float32 would hide a semantic difference. JAX's side runs in a process of
its own while this one runs the port's: one compile of TEHNet's forward
and its vector-Jacobian product serves both steps, each loss's gradient
with respect to the net's outputs is compiled apart, and the chain rule
joins them.
"""

import concurrent.futures
import functools
import multiprocessing

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ev2hands_tpu import checkpoint as jckpt
from ev2hands_tpu.config import DEFAULT_CONFIG as JCFG
from ev2hands_tpu.config import ModelConfig as JModelConfig
from ev2hands_tpu.events import erpc as je
from ev2hands_tpu.events import real_streams as jrs
from ev2hands_tpu.losses import CollisionContext as JCollisionContext
from ev2hands_tpu.losses import mano_losses as j_mano_losses
from ev2hands_tpu.losses import real_losses as j_real_losses
from ev2hands_tpu.losses import total_loss as j_total_loss
from ev2hands_tpu.mano import create_mano_hands, synthetic_mano_models
from ev2hands_tpu.model import tehnet as jt
from ev2hands_tpu.ops import collision as jc
from ev2hands_tpu.ops import pointnet as jp
from ev2hands_tpu_torch import finetune as tft
from ev2hands_tpu_torch import train as ttr
from ev2hands_tpu_torch import weights as tw
from ev2hands_tpu_torch.config import DEFAULT_CONFIG, ModelConfig, TrainConfig
from ev2hands_tpu_torch.events import erpc as te
from ev2hands_tpu_torch.events import real_streams as trs
from ev2hands_tpu_torch.mano.layer import ManoParams
from ev2hands_tpu_torch.model import layers as tl
from ev2hands_tpu_torch.model import tehnet as tt
from ev2hands_tpu_torch.ops import collision as tc
from ev2hands_tpu_torch.ops import fps as tf
from ev2hands_tpu_torch.ops import pointnet as tp
from test_torch_erpc_mano import assert_erpc_equal, raw_windows

B, N = 2, 256
W, H = 346, 260
NO_DROPOUT = dict(dropout_classifier=0.0, dropout_query=0.0, dropout_regressor=0.0)


def _t(a):
    return torch.from_numpy(np.array(a))


def fake_batch(rng, B, N):
    """Raw windows and MANO ground truth made like the JAX package's
    synthetic training batches. Row 1 has only a left hand, so the masked
    reductions see an invalid sample and a non-interacting one."""
    raw, labels = raw_windows(rng, B, N)

    def hand(valid):
        return {"global_orient": (rng.randn(B, 3) * 0.1).astype(np.float32),
                "hand_pose": (rng.randn(B, 45) * 0.1).astype(np.float32),
                "shape": (rng.randn(B, 10) * 0.1).astype(np.float32),
                "trans": (rng.randn(B, 3) * 0.1).astype(np.float32),
                "valid": np.asarray(valid, np.float32)}

    return {"events": raw, "labels": labels, "left": hand([1] * B),
            "right": hand([1] + [0] * (B - 1)),
            "handedness": np.array([[1, 1]] + [[1, 0]] * (B - 1), np.int32)}


def _masks(events, fps, index, sqd):
    """Every ball-query mask of the training path with deterministic FPS
    starts (the eval selection), against the radii in the events' dtype."""
    l0 = events[..., :3]
    l1 = index(l0, fps(l0, 512))
    l2 = index(l1, fps(l1, 128))
    reg = index(l0, fps(l0, tt.REGRESSOR_NPOINT))
    out = []
    for c, x, radii in ((l1, l0, (0.1, 0.2, 0.4)), (l2, l1, (0.4, 0.8)),
                        (reg, l0, (0.4, 0.8))):
        d = sqd(c, x)
        out += [d <= r ** 2 for r in radii]
    return out


# Cheaper LLVM passes for the one large XLA compile of this file (about a
# quarter off its compile and run time on the CPU); the arithmetic is the
# same.
FAST_COMPILE = {"xla_llvm_disable_expensive_passes": True}


# --- the whole slice, float64 ---------------------------------------------

# the port's routes of the slice: index_points, the one-hot gather (K8/K9's
# plain versions), the u/v-split gather
ROUTES = {"index": {}, "onehot": dict(pallas_gather=True, pallas_gather_bwd=True),
          "uv": dict(uv_split_gather=True)}


@pytest.fixture(scope="module")
def slice_case(tmp_path_factory):
    """JAX's float64 slice and finetuning step, in another process, and the
    port's meanwhile: the slice on each route (the same weights, synthetic
    MANO, batch and ERPC cloud), then the finetuning step on a synthetic
    Ev2Hands-R batch; deterministic FPS and no dropout."""
    rng = np.random.RandomState(0)
    batch = fake_batch(rng, B, N)
    erpc = te.erpc_batch_transform(
        _t(batch["events"]), _t(batch["labels"]),
        generator=torch.Generator().manual_seed(0), n_out=N)
    # seeded numpy weights with BatchNorm variances in [0.5, 1.5], in the
    # JAX package's layout
    variables = jckpt.torch_to_flax({k: v.numpy() for k, v in tw.init_weights(
        torch.Generator().manual_seed(2), ModelConfig(n_points=N)).items()})
    case = dict(batch=batch, events=erpc.events.double().numpy(),
                labels=erpc.labels.numpy(), variables=variables)
    with concurrent.futures.ProcessPoolExecutor(
            1, mp_context=multiprocessing.get_context("spawn")) as pool:
        ref = pool.submit(jax_slice, case)
        threads = torch.get_num_threads()
        torch.set_num_threads(max(1, threads // 2))   # the other half is JAX's
        try:
            case["finetune"] = run_port_finetune(tmp_path_factory.mktemp("finetune"))
            ft_ref = pool.submit(jax_finetune, case["finetune"]["jax_case"])
            case["port"] = {route: run_port_slice(case, **model)
                            for route, model in ROUTES.items()}
        finally:
            torch.set_num_threads(threads)
        case["masks"], case["ref"] = ref.result()
        case["finetune"]["ref"] = ft_ref.result()
    return case


@functools.lru_cache(maxsize=None)
def jax_net_vjp():
    """TEHNet in training, float64, deterministic FPS, no dropout: one
    compiled function (params, batch_stats, events, cotangent of the
    outputs) -> (outputs, new batch statistics, the parameters'
    gradient). Both steps call it: once with a zero cotangent for the
    outputs, once with the loss's gradient with respect to them."""
    net = jt.TEHNet(cfg=JModelConfig(n_points=N, fps_deterministic=True, **NO_DROPOUT))

    def fwd_vjp(params, batch_stats, events, ct):
        def forward(p):
            outputs, upd = net.apply({"params": p, "batch_stats": batch_stats}, events,
                                     train=True, mutable=["batch_stats"])
            return outputs, upd["batch_stats"]

        outputs, vjp, stats = jax.vjp(forward, params, has_aux=True)
        return outputs, stats, vjp(ct)[0]

    compiled = {}

    def run(variables, events):
        """-> (outputs, stats, a function of the outputs' cotangent that
        gives the parameters' gradient)."""
        args = (variables["params"], variables["batch_stats"], events)
        shapes = jax.eval_shape(lambda p, bs, ev: net.apply(
            {"params": p, "batch_stats": bs}, ev, train=True, mutable=["batch_stats"])[0],
            *args)
        zeros = jax.tree.map(lambda t: jnp.zeros(t.shape, t.dtype), shapes)
        if "fn" not in compiled:
            compiled["fn"] = jax.jit(fwd_vjp).lower(*args, zeros).compile(FAST_COMPILE)
        outputs, stats, _ = compiled["fn"](*args, zeros)
        return outputs, stats, lambda ct: compiled["fn"](*args, ct)[2]

    return run


def jax_step(variables, events, loss_of_outputs):
    """JAX's float64 loss, loss terms, gradient and BatchNorm statistics of
    one training step of TEHNet whose loss is ``loss_of_outputs(outputs)``
    -> (total, terms): TEHNet's compiled vector-Jacobian product fed the
    loss's gradient with respect to the outputs."""
    outputs, stats, vjp = jax_net_vjp()(variables, events)
    (loss, losses), ct = jax.jit(jax.value_and_grad(loss_of_outputs, has_aux=True))(
        outputs)
    return jax.tree.map(np.array, dict(losses=dict(losses, loss=loss), grads=vjp(ct),
                                       stats=stats))


def jax_slice(case):
    """JAX's float64 slice on ``case`` -> (the selection masks, the loss
    terms, gradients and BatchNorm statistics)."""
    batch, events, labels = case["batch"], case["events"], case["labels"]
    variables = case["variables"]
    models = synthetic_mano_models(0)
    with jax.enable_x64(True):
        f64 = lambda t: jax.tree.map(  # noqa: E731
            lambda a: jnp.asarray(a, jnp.float64)
            if jnp.issubdtype(jnp.asarray(a).dtype, jnp.floating) else a, t)
        v64 = f64(variables)
        hands = f64({s: h.params for s, h in create_mano_hands(models).items()})
        faces = jc.build_two_hand_faces(models["left"].faces, models["right"].faces)
        ctx = JCollisionContext(faces=jnp.asarray(faces),
                                adjacency=jnp.asarray(jc.build_adjacency_mask(faces)))
        targets = {"left": f64(batch["left"]), "right": f64(batch["right"]),
                   "handedness": jnp.asarray(batch["handedness"]),
                   "class_logits": jnp.asarray(labels)}

        def loss_of_outputs(outputs):
            losses = j_mano_losses(jt.apply_mano(hands, outputs), targets, hands, ctx)
            return j_total_loss(losses), losses

        ref = jax_step(v64, jnp.asarray(events), loss_of_outputs)
        masks = jax.jit(lambda ev: _masks(ev, jp.farthest_point_sample, jp.index_points,
                                          jp.square_distance))(jnp.asarray(events))
    return [np.asarray(m) for m in masks], ref


def run_port_finetune(tmp):
    """The port's finetuning step in float64 on the CPU: one step on a
    synthetic Ev2Hands-R batch (written by the JAX package) with seeded
    weights, on its own ERPC cloud made float64 for the net -> (losses,
    gradients, BatchNorm buffers, the BatchNorm-cancelled biases, and what
    JAX's side needs: weights, batch targets, cloud, projection)."""
    rec = jrs.write_synthetic_ev2hands_r(str(tmp / "rec.pickle"), n_events=20000,
                                         n_frames=10, seed=5)
    batch = next(trs.Ev2HandRReader(rec, seed=0, capacity=4096).batches(B))
    weights = tw.init_weights(torch.Generator().manual_seed(3), ModelConfig(n_points=N))
    cfg = DEFAULT_CONFIG.replace(model=ModelConfig(n_points=N, fps_deterministic=True,
                                                   **NO_DROPOUT))
    net = tt.TEHNet(cfg.model, device="cpu")
    net.load_state_dict(weights, strict=True)
    net.double()
    hands = {s: ManoParams(*(t.double() if t.is_floating_point() else t for t in p))
             for s, p in ttr.build_hands(cfg, synthetic=True, device="cpu").items()}
    proj = cfg.camera.projection_matrix(W, H)
    step = tft.make_finetune_step(net, hands, ttr.build_collision_context(hands), cfg,
                                  ttr.make_optimizer(net.parameters(), cfg.train), proj,
                                  device="cpu")
    clouds = []
    real = tft.erpc_real_batch_transform

    def float64_cloud(*a, **k):
        out = real(*a, **k)
        clouds.append(out.events.double())
        return out._replace(events=clouds[-1])

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tft, "erpc_real_batch_transform", float64_cloud)
        losses = step(batch, torch.Generator().manual_seed(0))
    return dict(losses=losses, grads={k: p.grad.numpy() for k, p in net.named_parameters()},
                buffers={k: b.numpy() for k, b in net.named_buffers()},
                cancelled=tt.batchnorm_cancelled_biases(net),
                jax_case=dict(weights={k: v.numpy() for k, v in weights.items()},
                              targets={k: batch[k] for k in ("left", "right", "handedness")},
                              events=clouds[0].numpy(), proj=np.asarray(proj)))


def jax_finetune(case):
    """JAX's float64 finetuning step (``finetune.py:53-64``: TEHNet in
    training -> MANO -> ``real_losses``) on the port's cloud -> (the loss
    terms, gradients and BatchNorm statistics)."""
    variables = jckpt.torch_to_flax(case["weights"])
    models = synthetic_mano_models(0)
    faces = jc.build_two_hand_faces(models["left"].faces, models["right"].faces)
    with jax.enable_x64(True):
        f64 = lambda t: jax.tree.map(  # noqa: E731
            lambda a: jnp.asarray(a, jnp.float64)
            if jnp.issubdtype(jnp.asarray(a).dtype, jnp.floating) else a, t)
        hands = f64({s: h.params for s, h in create_mano_hands(models).items()})
        ctx = JCollisionContext(faces=jnp.asarray(faces),
                                adjacency=jnp.asarray(jc.build_adjacency_mask(faces)))
        proj = jnp.asarray(case["proj"], jnp.float32)   # as the JAX step holds it

        def loss_of_outputs(outputs):
            losses = j_real_losses(jt.apply_mano(hands, outputs), case["targets"], ctx, proj,
                                   W, H, JCFG.loss)
            return j_total_loss(losses), losses

        return jax_step(f64(variables), jnp.asarray(case["events"]), loss_of_outputs)


def run_port_slice(case, **model):
    """The port's forward_losses and backward in float64 on the CPU, with
    the ``ModelConfig`` switches ``model`` -> (losses, gradients, BatchNorm
    buffers, grouped_gather calls, the BatchNorm-cancelled biases)."""
    cfg = DEFAULT_CONFIG.replace(model=ModelConfig(
        n_points=N, fps_deterministic=True, **NO_DROPOUT, **model))
    net = tt.TEHNet(cfg.model, device="cpu")
    net.load_state_dict(tw.flax_to_torch(case["variables"]), strict=True)
    net.double().train()
    hands = {s: ManoParams(*(t.double() if t.is_floating_point() else t for t in p))
             for s, p in ttr.build_hands(cfg, synthetic=True, device="cpu").items()}
    ctx = ttr.build_collision_context(hands)
    b = case["batch"]
    targets = {"left": {k: _t(v).double() for k, v in b["left"].items()},
               "right": {k: _t(v).double() for k, v in b["right"].items()},
               "handedness": _t(b["handedness"]), "class_logits": _t(case["labels"])}
    calls = []
    real = tl.grouped_gather
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tl, "grouped_gather", lambda *a, **k: calls.append(1) or real(*a, **k))
        loss, losses = ttr.forward_losses(net, hands, ctx, cfg, _t(case["events"]),
                                          targets)
        loss.backward()
    losses = {k: float(v.detach()) for k, v in dict(losses, loss=loss).items()}
    grads = {k: p.grad.numpy() for k, p in net.named_parameters()}
    buffers = {k: v.numpy() for k, v in net.named_buffers()}
    return losses, grads, buffers, len(calls), tt.batchnorm_cancelled_biases(net)


def test_slice_selection_masks_agree(slice_case):
    """Precondition of the slice check: in float64 both sides select the
    same centroids and neighbor sets."""
    got = _masks(torch.from_numpy(slice_case["events"]), tf.fps, tp.index_points,
                 tp.square_distance)
    for a, b in zip(got, slice_case["masks"]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("route", ["index", "onehot", "uv"])
def test_train_slice_matches_jax_f64(slice_case, route):
    """The port on the three gather routes (the one-hot route through
    K8/K9's plain versions) against JAX's index route (its one-hot gate is
    off on the CPU; its u/v-split route equals its index route within 1e-9,
    ``tests/test_model.py:465``): loss terms within rtol 1e-7; per-tensor
    gradient cosine >= 1 - 1e-9 and norm ratio within 1e-6; BatchNorm
    running statistics within rtol 1e-7. The biases whose shift a later
    train-mode BatchNorm removes (``batchnorm_cancelled_biases``) have a
    zero gradient, rounding noise on both sides, and are left out. The u/v
    route is also held at ``tests/test_model.py:465``'s bounds between
    JAX's two routes: loss terms and BatchNorm statistics within rtol =
    atol = 1e-9, the whole gradient's relative distance below 1e-8."""
    ref = slice_case["ref"]
    losses, grads, buffers, gathers, cancelled = slice_case["port"][route]
    assert gathers == (4 if route == "onehot" else 0)
    assert set(losses) == set(ref["losses"])
    assert ref["losses"]["loss_interpen"] > 0
    for k, v in ref["losses"].items():
        np.testing.assert_allclose(losses[k], v, rtol=1e-7, atol=1e-12, err_msg=k)

    rgrads = tw.flax_to_torch({"params": ref["grads"],
                               "batch_stats": ref["stats"]})
    bad = []
    for k in sorted(set(grads) - cancelled):
        a, b = grads[k].ravel(), rgrads[k].numpy().ravel()
        na, nb = np.linalg.norm(a), np.linalg.norm(b)
        cos = float(a @ b / (na * nb + 1e-300))
        if cos < 1 - 1e-9 or not abs(na / nb - 1) <= 1e-6:
            bad.append((k, cos, na / nb))
    assert not bad, bad

    for k, v in buffers.items():
        np.testing.assert_allclose(v, rgrads[k].numpy(), rtol=1e-7, atol=1e-12,
                                   err_msg=k)
    if route == "uv":
        for k, v in ref["losses"].items():
            np.testing.assert_allclose(losses[k], v, rtol=1e-9, atol=1e-9, err_msg=k)
        for k, v in buffers.items():
            np.testing.assert_allclose(v, rgrads[k].numpy(), rtol=1e-9, atol=1e-9,
                                       err_msg=k)
        keys = sorted(set(grads) - cancelled)
        a = np.concatenate([grads[k].ravel() for k in keys])
        b = np.concatenate([rgrads[k].numpy().ravel() for k in keys])
        assert np.linalg.norm(a - b) / np.linalg.norm(b) < 1e-8


def test_finetune_step_matches_jax_f64(slice_case):
    """``finetune.make_finetune_step`` against JAX's finetuning step in
    float64, on the port's cloud: loss terms within rtol 1e-7; per-tensor
    gradient cosine >= 1 - 1e-9 and norm ratio within 1e-6, the
    BatchNorm-cancelled biases left out; BatchNorm running statistics within
    rtol 1e-7."""
    port = slice_case["finetune"]
    ref = port["ref"]
    losses, grads = port["losses"], port["grads"]
    assert set(losses) == set(ref["losses"])
    assert ref["losses"]["loss_interpen"] > 0
    for k, v in ref["losses"].items():
        np.testing.assert_allclose(losses[k], v, rtol=1e-7, atol=1e-12, err_msg=k)
    rtree = tw.flax_to_torch({"params": ref["grads"], "batch_stats": ref["stats"]})
    bad = []
    for k in sorted(set(grads) - port["cancelled"]):
        a, b = grads[k].ravel(), rtree[k].numpy().ravel()
        na, nb = np.linalg.norm(a), np.linalg.norm(b)
        cos = float(a @ b / (na * nb + 1e-300))
        if cos < 1 - 1e-9 or not abs(na / nb - 1) <= 1e-6:
            bad.append((k, cos, na / nb))
    assert not bad, bad
    for k, v in port["buffers"].items():
        np.testing.assert_allclose(v, rtree[k].numpy(), rtol=1e-7, atol=1e-12, err_msg=k)


# --- the parts --------------------------------------------------------------

def jax_augment_draws(raw, labels, key, n_out, width=346, height=260):
    """JAX's erpc_batch_transform(augment=True) and the draws it makes
    inside, per window: gate, noise rows and the resample over valid +
    noise rows (one compile for both)."""
    n_noise = n_out // 32

    def window(k, e, l):
        _, _, nv = je.rasterize_erpc(e, l, width, height)
        k_gate, k_noise, k_sample = jax.random.split(k, 3)
        active = jax.random.bernoulli(k_gate, 0.5)
        kx, ky, kt, kr, kp, kpe, kne = jax.random.split(k_noise, 7)
        total = nv + jnp.where(active, n_noise, 0)
        return dict(
            gate=active,
            xs=jax.random.randint(kx, (n_noise,), 0, width),
            ys=jax.random.randint(ky, (n_noise,), 0, height),
            src=jax.random.randint(kr, (n_noise,), 0, jnp.maximum(nv, 1)),
            t=jax.random.uniform(kt, (n_noise,)),
            ps=jax.random.bernoulli(kp, 0.5, (n_noise,)),
            n_pe=jax.random.randint(kpe, (n_noise,), 0, 8),
            n_ne=jax.random.randint(kne, (n_noise,), 0, 8),
            r=jax.random.randint(k_sample, (n_out,), 0, jnp.maximum(total, 1)))

    def both(raw, labels):
        out = je.erpc_batch_transform(raw, labels, key, width=width,
                                      height=height, n_out=n_out, augment=True)
        return out, jax.vmap(window)(jax.random.split(key, raw.shape[0]), raw,
                                     labels)

    out, d = jax.jit(both)(raw, labels)
    return out, {k: _t(v) for k, v in d.items()}


def test_erpc_augment_matches_jax():
    """ERPC with augmentation, the port fed the draws JAX's keys give:
    labels exact, events as in the unaugmented check (t column rtol 1e-6,
    x and y within one ulp of the jitted division)."""
    rng = np.random.RandomState(3)
    Bq, Nq = 4, 256
    raw, labels = raw_windows(rng, Bq, Nq)
    key = jax.random.PRNGKey(2)
    ref, d = jax_augment_draws(raw, labels, key, Nq)
    assert d["gate"].any() and not d["gate"].all()   # both kinds of window
    noise = te.NoiseDraws(*(d[f] for f in te.NoiseDraws._fields))
    got = te.erpc_batch_transform(_t(raw), _t(labels), draws=d["r"], n_out=Nq,
                                  augment=True, noise=noise)
    np.testing.assert_array_equal(got.labels.numpy(), np.asarray(ref.labels))
    assert (got.labels.numpy() == 3).any()
    assert_erpc_equal(got.events, ref.events, jitted=True)

    # draws from a generator fall in their ranges
    g = torch.Generator().manual_seed(0)
    n_valid = torch.tensor([5, 200, 1, 0], dtype=torch.int32)
    nd = te.noise_draws(n_valid, 64, 346, 260, g)
    assert ((nd.src >= 0) & (nd.src < torch.clamp(n_valid, min=1)[:, None])).all()
    assert (nd.xs < 346).all() and (nd.ys < 260).all() and (nd.n_pe < 8).all()


def test_collision_loss_matches_jax():
    """Synthetic-MANO topology (T = 3076), B = 2, the hands overlapping so
    that pairs intersect: the same pairs and intersection flags, the loss
    within rtol 1e-5 and its vertex gradients within 1e-5 of the largest
    (float32 sums in another order)."""
    models = synthetic_mano_models(0)
    faces = jc.build_two_hand_faces(models["left"].faces, models["right"].faces)
    adjacency = jc.build_adjacency_mask(faces)
    np.testing.assert_array_equal(
        tc.build_two_hand_faces(models["left"].faces, models["right"].faces), faces)
    np.testing.assert_array_equal(tc.build_adjacency_mask(faces), adjacency)
    rng = np.random.RandomState(9)
    vl = (models["left"].v_template[None] + 0.004 * rng.randn(2, 778, 3)).astype(np.float32)
    vr = (models["right"].v_template[None] + 0.004 * rng.randn(2, 778, 3)).astype(np.float32)
    vr[1] += np.float32([0.06, 0.0, 0.0])

    tris = np.concatenate([vl, vr], 1)[:, faces]

    @jax.jit
    def ref(vl, vr, tris, adj):
        return (jax.value_and_grad(jc.collision_loss, argnums=(0, 1))(
            vl, vr, jnp.asarray(faces), adj),
            jax.vmap(lambda t: jc.find_collision_pairs(t, adj, 128))(tris))

    (loss, grads), ref_pairs = ref(vl, vr, tris, jnp.asarray(adjacency))

    adj_t = _t(adjacency)
    got_pairs = tc.find_collision_pairs(_t(tris), adj_t, 128)
    np.testing.assert_array_equal(got_pairs.pairs.numpy(), np.asarray(ref_pairs.pairs))
    np.testing.assert_array_equal(got_pairs.intersecting.numpy(),
                                  np.asarray(ref_pairs.intersecting))
    assert got_pairs.intersecting.any()
    tl_, tr_ = _t(vl).requires_grad_(True), _t(vr).requires_grad_(True)
    got = tc.collision_loss(tl_, tr_, _t(faces), adj_t)
    got.backward()
    assert float(loss) > 0
    np.testing.assert_allclose(got.item(), float(loss), rtol=1e-5)
    for g, r in ((tl_.grad, grads[0]), (tr_.grad, grads[1])):
        r = np.asarray(r)
        assert np.abs(g.numpy() - r).max() <= 1e-5 * np.abs(r).max()


@pytest.mark.parametrize("wd", [0.0, 1e-2])
def test_adam_matches_optax(wd):
    """The port's optimizer against optax.chain(add_decayed_weights(wd),
    adam(lr)) over three given gradient sets: parameters within 1e-6."""
    rng = np.random.RandomState(4)
    params = {"a": rng.randn(5, 3).astype(np.float32),
              "b": rng.randn(7).astype(np.float32)}
    grad_sets = [{k: rng.randn(*v.shape).astype(np.float32) for k, v in params.items()}
                 for _ in range(3)]
    lr = 1e-3
    opt = optax.chain(optax.add_decayed_weights(wd), optax.adam(lr))

    @jax.jit
    def run(p):
        state = opt.init(p)
        for g in grad_sets:
            upd, state = opt.update(g, state, p)
            p = optax.apply_updates(p, upd)
        return p

    p = run(params)

    tparams = {k: torch.nn.Parameter(_t(v)) for k, v in params.items()}
    topt = ttr.make_optimizer(list(tparams.values()),
                              TrainConfig(learning_rate=lr, weight_decay=wd))
    for g in grad_sets:
        for k, t in tparams.items():
            t.grad = _t(g[k])
        topt.step()
    for k, t in tparams.items():
        np.testing.assert_allclose(t.detach().numpy(), np.asarray(p[k]),
                                   rtol=0, atol=1e-6, err_msg=k)


def test_train_step_on_cpu():
    """make_train_step on the CPU (device="cpu") at B=2, N=256 with
    augmentation, random FPS starts and dropout from one generator: finite
    losses, a computed collision term, and every parameter and BatchNorm
    statistic moved by the step. Without a device argument it asks for the
    card and raises on a host without one."""
    cfg = DEFAULT_CONFIG.replace(model=ModelConfig(
        n_points=N, pallas_gather=True, pallas_gather_bwd=True))
    net = tt.TEHNet(cfg.model, device="cpu")
    net.load_state_dict(tw.init_weights(torch.Generator().manual_seed(1), cfg.model))
    hands = ttr.build_hands(cfg, synthetic=True, device="cpu")
    ctx = ttr.build_collision_context(hands)
    opt = ttr.make_optimizer(net.parameters(), cfg.train)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ttr.make_train_step(net, hands, ctx, cfg, opt)
    step = ttr.make_train_step(net, hands, ctx, cfg, opt, device="cpu")
    before = {k: v.clone() for k, v in net.state_dict().items()}
    losses = step(fake_batch(np.random.RandomState(5), B, N),
                  torch.Generator().manual_seed(0))
    assert np.isfinite(list(losses.values())).all()
    assert losses["loss_interpen"] > 0
    assert losses["loss"] == pytest.approx(
        sum(v for k, v in losses.items() if k != "loss"), rel=1e-6)
    unchanged = [k for k, v in net.state_dict().items() if torch.equal(v, before[k])]
    assert not unchanged, unchanged
