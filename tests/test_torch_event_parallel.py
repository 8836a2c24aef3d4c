"""The port's event-axis sharding (``parallel/event_parallel.py``) over a
(data 2, event 2) mesh of four gloo ranks on the CPU, each function against
its JAX counterpart under ``create_event_mesh(n_event=2, n_data=2)``, as
``tests/test_event_parallel.py`` holds them to one device: the sharded
dense scale (:42), the rank cut across shards (:62), ``fold_bn_dense``
(:90), the MSG scale of a set-abstraction layer (:108), the empty-ball
fallback (:184), FPS exactly (:202) and the training scale (:226). Then the
``dense_train`` route of one process against JAX's in float64
(``tests/test_model.py:262``).

The ranks start once, in a module fixture; the JAX references run in this
process meanwhile. The ranks import this module, so its top level imports
no JAX.
"""

import numpy as np
import pytest
import torch

from ev2hands_tpu_torch.model.layers import SetAbstractionMsg, set_mesh
from ev2hands_tpu_torch.parallel import event_parallel as ep
from ev2hands_tpu_torch.parallel import mesh as pm

N_DATA, N_EVENT = 2, 2
RANKS_ENV = {"OMP_NUM_THREADS": "1"}
SA = dict(npoint=32, radius_list=(0.2, 0.4), nsample_list=(8, 16),
          mlps=((16, 16, 32), (16, 24, 32)))


def inputs():
    """Every case's inputs, numpy, from one seed."""
    rng = np.random.RandomState(1234)
    f32 = np.float32
    c = {}
    B, N, S, C1, C2, C3 = 2, 256, 16, 8, 16, 32
    xyz = rng.rand(B, N, 3).astype(f32)
    c["dense"] = dict(
        xyz=xyz, u=(rng.randn(B, N, C1) * 0.3).astype(f32), new_xyz=xyz[:, :S],
        v=(rng.randn(B, S, C1) * 0.3).astype(f32),
        W2=(rng.randn(C1, C2) * 0.3).astype(f32), b2=(rng.randn(C2) * 0.1).astype(f32),
        W3=(rng.randn(C2, C3) * 0.3).astype(f32), b3=(rng.randn(C3) * 0.1).astype(f32),
        radius=0.4, nsample=8)
    # every point in radius: the cut is by rank alone, in shard 0 (5) and in
    # shard 1 (100 of 2 x 64 points)
    C = 8
    eye, zero = np.eye(C, dtype=f32), np.zeros(C, f32)
    cross = dict(xyz=np.zeros((1, 128, 3), f32), u=rng.randn(1, 128, C).astype(f32),
                 new_xyz=np.zeros((1, 4, 3), f32), v=rng.randn(1, 4, C).astype(f32),
                 W2=eye, b2=zero, W3=eye, b3=zero, radius=1.0)
    c["cross5"], c["cross100"] = dict(cross, nsample=5), dict(cross, nsample=100)
    # centroids far from every point
    c["empty"] = dict(xyz=rng.rand(1, 64, 3).astype(f32), u=rng.randn(1, 64, 4).astype(f32),
                      new_xyz=np.full((1, 2, 3), 100.0, f32), v=np.zeros((1, 2, 4), f32),
                      W2=np.eye(4, dtype=f32), b2=np.zeros(4, f32),
                      W3=np.eye(4, dtype=f32), b3=np.zeros(4, f32), radius=0.1, nsample=4)
    c["fps_xyz"] = rng.randn(2, 256, 3).astype(f32)
    c["fps_start"] = rng.randint(0, 256, 2).astype(np.int32)
    c["sa_xyz"] = rng.rand(2, 256, 3).astype(f32)
    c["sa_points"] = (rng.randn(2, 256, 5) * 0.3).astype(f32)
    c["sa_vars"] = sa_variables(rng)
    return c


def sa_variables(rng):
    """Flax variables of a SetAbstractionMsg(**SA) on 5 input channels, with
    non-trivial BatchNorm statistics."""
    params, stats = {}, {}
    for i, mlp in enumerate(SA["mlps"]):
        last = 5 + 3
        for j, w in enumerate(mlp):
            params[f"conv_{i}_{j}"] = {
                "kernel": (rng.randn(last, w) / np.sqrt(last)).astype(np.float32),
                "bias": (rng.randn(w) * 0.1).astype(np.float32)}
            params[f"bn_{i}_{j}"] = {"scale": (1 + 0.1 * rng.randn(w)).astype(np.float32),
                                     "bias": (0.1 * rng.randn(w)).astype(np.float32)}
            stats[f"bn_{i}_{j}"] = {"mean": (0.1 * rng.randn(w)).astype(np.float32),
                                    "var": (0.5 + rng.rand(w)).astype(np.float32)}
            last = w
    return {"params": params, "batch_stats": stats}


def port_sa(variables, dense_train=False, dtype=torch.float32):
    """The port's SetAbstractionMsg(**SA) with the flax ``variables``."""
    sa = SetAbstractionMsg(in_channel=5, grouping="dense", pallas_grouping=False,
                           dense_train=dense_train, device="cpu", **SA)
    state = {}
    for i, mlp in enumerate(SA["mlps"]):
        for j in range(len(mlp)):
            conv = variables["params"][f"conv_{i}_{j}"]
            bn = variables["params"][f"bn_{i}_{j}"]
            st = variables["batch_stats"][f"bn_{i}_{j}"]
            state[f"conv_blocks.{i}.{j}.weight"] = np.asarray(conv["kernel"]).T[:, :, None, None]
            state[f"conv_blocks.{i}.{j}.bias"] = conv["bias"]
            state.update({f"bn_blocks.{i}.{j}.weight": bn["scale"],
                          f"bn_blocks.{i}.{j}.bias": bn["bias"],
                          f"bn_blocks.{i}.{j}.running_mean": st["mean"],
                          f"bn_blocks.{i}.{j}.running_var": st["var"]})
    sa.load_state_dict({k: torch.as_tensor(np.asarray(v)) for k, v in state.items()})
    return sa.to(dtype)


def sa_train(sa, xyz, points, mesh=None):
    """A training forward of ``sa`` on this rank's rows, the gradient of
    sum(out^2) over the global batch -> (out, running stats, gradients)."""
    sa.train()
    _, out = sa(xyz, points)
    (out ** 2).sum().backward()
    if mesh is not None:
        pm.all_sum_grads(list(sa.parameters()), mesh, 1.0 / mesh.event_size)
    return (out.detach().numpy(),
            {k: v.numpy().copy() for k, v in sa.named_buffers()},
            {k: p.grad.numpy().copy() for k, p in sa.named_parameters()})


def rank_cases(c):
    """Every sharded case on one rank of the (2, 2) mesh; the dense-scale
    cases take the whole batch on every rank (their JAX function shards no
    batch), the others this data rank's rows."""
    torch.set_num_threads(1)
    mesh = pm.create_event_mesh(N_EVENT, N_DATA, device="cpu")
    t = lambda a: torch.as_tensor(np.asarray(a))   # noqa: E731
    out = {"mesh": (mesh.data_rank, mesh.event_rank, mesh.shape)}
    for name in ("dense", "cross5", "cross100", "empty"):
        d = c[name]
        out[name] = ep.event_sharded_dense_scale(
            mesh, *(t(d[k]) for k in ("xyz", "u", "new_xyz", "v", "W2", "b2", "W3", "b3")),
            d["radius"], d["nsample"]).numpy()
    rows = lambda a: pm.local_rows(t(a), mesh)     # noqa: E731
    out["fps0"] = ep.event_sharded_fps(mesh, rows(c["fps_xyz"]), 48).numpy()
    out["fps_key"] = ep.event_sharded_fps(mesh, rows(c["fps_xyz"]), 48,
                                          rows(c["fps_start"])).numpy()
    sa = port_sa(c["sa_vars"])
    set_mesh(sa, mesh, mesh)
    sa.eval()
    with torch.no_grad():
        out["sa_eval"] = [x.numpy() for x in sa(rows(c["sa_xyz"]), rows(c["sa_points"]))]
    sa = port_sa(c["sa_vars"], dense_train=True)
    set_mesh(sa, mesh, mesh)
    out["sa_train"] = sa_train(sa, rows(c["sa_xyz"]), rows(c["sa_points"]), mesh)
    return out


def jax_references(c):
    """JAX's event-sharded functions over create_event_mesh(2, 2) on the
    same inputs, each jitted (eager shard_map dispatch takes seconds a
    call)."""
    from functools import partial

    import jax
    import jax.numpy as jnp

    from ev2hands_tpu.model.layers import SetAbstractionMsg as JSA
    from ev2hands_tpu.parallel import event_parallel as jep

    mesh = jep.create_event_mesh(n_event=N_EVENT, n_data=N_DATA)
    ref = {}
    for name in ("dense", "cross5", "cross100", "empty"):
        d = c[name]
        fn = jax.jit(partial(jep.event_sharded_dense_scale, mesh, radius=d["radius"],
                             nsample=d["nsample"]))
        ref[name] = np.asarray(fn(*(jnp.asarray(d[k]) for k in (
            "xyz", "u", "new_xyz", "v", "W2", "b2", "W3", "b3"))))
    xyz = jnp.asarray(c["fps_xyz"])
    key = jax.random.PRNGKey(5)
    fps = jax.jit(lambda x, k: (jep.event_sharded_fps(mesh, x, 48),
                                jep.event_sharded_fps(mesh, x, 48, key=k)))
    ref["fps0"], ref["fps_key"] = map(np.asarray, fps(xyz, key))
    ref["fps_key_start"] = np.asarray(jax.random.randint(key, (2,), 0, 256))
    variables = jax.tree.map(jnp.asarray, c["sa_vars"])
    sx, sp = jnp.asarray(c["sa_xyz"]), jnp.asarray(c["sa_points"])
    ref["sa_eval"] = [np.asarray(a) for a in jax.jit(
        lambda v: JSA(**SA, grouping="dense", event_mesh=mesh).apply(v, sx, sp, False))(
            variables)]
    jsa = JSA(**SA, grouping="dense", dense_train=True, pallas_grouping=False,
              event_mesh=mesh)

    def fwd(params):
        (_, out), upd = jsa.apply({"params": params,
                                   "batch_stats": variables["batch_stats"]},
                                  sx, sp, True, mutable=["batch_stats"])
        return jnp.sum(out ** 2), (out, upd["batch_stats"])

    (_, (out, st)), g = jax.jit(jax.value_and_grad(fwd, has_aux=True))(
        variables["params"])
    ref["sa_train"] = (np.asarray(out), jax.tree.map(np.asarray, st),
                       jax.tree.map(np.asarray, g))
    return ref


@pytest.fixture(scope="module")
def four_ranks():
    """(inputs, the four ranks' results in rank order, JAX's)."""
    c = inputs()
    ranks = pm.start_ranks(rank_cases, N_DATA * N_EVENT, c, env=RANKS_ENV)
    try:
        ref = jax_references(c)
    finally:
        results = ranks.join(timeout=300)
    return c, results, ref


def data_rows(results, key, d):
    return results[d * N_EVENT][key]


def test_mesh_layout(four_ranks):
    _, results, _ = four_ranks
    for r, res in enumerate(results):
        assert res["mesh"] == (r // N_EVENT, r % N_EVENT, {"data": 2, "event": 2})


@pytest.mark.parametrize("case", ["dense", "cross5", "cross100", "empty"])
def test_sharded_dense_scale_matches_jax(four_ranks, case):
    """event_sharded_dense_scale on every rank against JAX's: atol 1e-5
    (``tests/test_event_parallel.py:42``); the first-K cut inside shard 0
    and inside shard 1 (:62); centroids with no point in radius anywhere
    take point 0's features (:184)."""
    _, results, ref = four_ranks
    for res in results:
        np.testing.assert_allclose(res[case], ref[case], atol=1e-5)
        assert np.isfinite(res[case]).all()


def test_fold_bn_dense_matches_jax():
    """fold_bn_dense against JAX's and against the BatchNorm it folds
    (``tests/test_event_parallel.py:90``)."""
    from ev2hands_tpu.parallel.event_parallel import fold_bn_dense as jfold

    rng = np.random.RandomState(1234)
    args = [(rng.randn(8, 16) * 0.3), rng.randn(16) * 0.1, rng.rand(16) + 0.5,
            rng.randn(16) * 0.1, rng.randn(16) * 0.1, rng.rand(16) + 0.1]
    args = [a.astype(np.float32) for a in args]
    W, b, scale, bias, mean, var = args
    x = rng.randn(4, 8).astype(np.float32)
    Wf, bf = ep.fold_bn_dense(*(torch.as_tensor(a) for a in args))
    jW, jb = jfold(*args)
    np.testing.assert_allclose(Wf.numpy(), np.asarray(jW), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(bf.numpy(), np.asarray(jb), rtol=1e-6, atol=1e-7)
    y_ref = (x @ W + b - mean) * scale / np.sqrt(var + 1e-5) + bias
    np.testing.assert_allclose(x @ Wf.numpy() + bf.numpy(), y_ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("start", ["index 0", "random"])
def test_sharded_fps_exact(four_ranks, start):
    """event_sharded_fps: the same indices as JAX's over the (2, 2) mesh and
    as the port's one-device FPS, from index 0 and from random starts
    (``tests/test_event_parallel.py:202``)."""
    from ev2hands_tpu_torch.ops.pointnet import farthest_point_sample

    c, results, ref = four_ranks
    key = "fps0" if start == "index 0" else "fps_key"
    if start == "random":
        # the port's ranks took the starts drawn here; JAX drew its own
        np.testing.assert_array_equal(
            ep.event_sharded_fps(pm.create_mesh(None, device="cpu"),
                                 torch.as_tensor(c["fps_xyz"]), 48,
                                 torch.tensor(ref["fps_key_start"])).numpy(),
            ref["fps_key"])
    s = None if start == "index 0" else torch.as_tensor(c["fps_start"])
    one = farthest_point_sample(torch.as_tensor(c["fps_xyz"]), 48, s).numpy()
    got = np.concatenate([data_rows(results, key, d) for d in range(N_DATA)])
    np.testing.assert_array_equal(got, one)
    for r, res in enumerate(results):
        np.testing.assert_array_equal(res[key], data_rows(results, key, r // N_EVENT))
    if start == "index 0":
        np.testing.assert_array_equal(got, ref["fps0"])


def test_sharded_msg_scale_matches_jax(four_ranks):
    """A SetAbstractionMsg in eval with the event mesh: centroids equal and
    pooled features within 1e-4 of JAX's with the same variables
    (``tests/test_event_parallel.py:108``)."""
    _, results, ref = four_ranks
    for d in range(N_DATA):
        new_xyz, feats = data_rows(results, "sa_eval", d)
        np.testing.assert_array_equal(new_xyz, ref["sa_eval"][0][d:d + 1])
        np.testing.assert_allclose(feats, ref["sa_eval"][1][d:d + 1], rtol=1e-4, atol=1e-4)


def test_sharded_train_scale_matches_jax(four_ranks):
    """The training scale with the event mesh (weighted BatchNorm sums over
    every rank, the max and min all-gathered): outputs, running statistics
    and gradients against JAX's sharded dense_train layer, with the JAX
    test's tolerances (``tests/test_event_parallel.py:226``)."""
    _, results, ref = four_ranks
    out_ref, st_ref, g_ref = ref["sa_train"]
    got_out = np.concatenate([data_rows(results, "sa_train", d)[0] for d in range(N_DATA)])
    np.testing.assert_allclose(got_out, out_ref, atol=1e-4)
    for res in results:
        _, buffers, grads = res["sa_train"]
        for name, st in st_ref.items():
            i, j = name.split("_")[1:]
            for field, key in (("mean", "running_mean"), ("var", "running_var")):
                np.testing.assert_allclose(buffers[f"bn_blocks.{i}.{j}.{key}"], st[field],
                                           rtol=1e-4, atol=1e-5, err_msg=name)
        f1 = np.concatenate([grads[k].ravel() for k in sorted(grads)])
        f2 = np.concatenate([ref_grad(g_ref, k).ravel() for k in sorted(grads)])
        assert np.linalg.norm(f1 - f2) / np.linalg.norm(f2) < 1e-3


def ref_grad(g, torch_name):
    """JAX's gradient of a port parameter, in the port's layout."""
    _, i, j, field = torch_name.split(".")
    if torch_name.startswith("conv_blocks"):
        leaf = g[f"conv_{i}_{j}"]
        return leaf["kernel"].T[:, :, None, None] if field == "weight" else leaf["bias"]
    leaf = g[f"bn_{i}_{j}"]
    return leaf["scale"] if field == "weight" else leaf["bias"]


def test_dense_train_matches_jax_f64():
    """The dense_train route of one process (multiplicity-weighted
    BatchNorm sums over centroid chunks) against JAX's in float64, with
    JAX's gather route as the second witness (``tests/test_model.py:262``):
    outputs within 1e-12, running statistics within 1e-12 and gradients
    within rel 1e-10. JAX sums the 48 centroids in one chunk, the port in
    three: chunking sets the memory, not the values."""
    import jax
    import jax.numpy as jnp

    from ev2hands_tpu.model.layers import SetAbstractionMsg as JSA

    rng = np.random.RandomState(3)
    xyz, pts = rng.randn(2, 192, 3) * 0.5, rng.randn(2, 192, 5)
    variables = sa_variables(rng)
    with jax.enable_x64(True):
        v64 = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), variables)
        ref = {}
        for name, kw in (("dense", dict(grouping="dense", dense_train=True)),
                         ("gather", dict(grouping="gather"))):
            jsa = JSA(**{**SA, "npoint": 48}, dense_chunk=48, pallas_grouping=False, **kw)

            def fwd(params):
                (_, out), upd = jsa.apply({"params": params,
                                           "batch_stats": v64["batch_stats"]},
                                          jnp.asarray(xyz), jnp.asarray(pts), True,
                                          mutable=["batch_stats"])
                return jnp.sum(out ** 2), (out, upd["batch_stats"])

            (_, (out, st)), g = jax.jit(jax.value_and_grad(fwd, has_aux=True))(
                v64["params"])
            ref[name] = (np.asarray(out), jax.tree.map(np.asarray, st),
                         jax.tree.map(np.asarray, g))
    sa = port_sa(variables, dense_train=True, dtype=torch.float64)
    sa.npoint, sa.dense_chunk = 48, 16
    out, buffers, grads = sa_train(sa, torch.as_tensor(xyz), torch.as_tensor(pts))
    for name, (out_ref, st_ref, g_ref) in ref.items():
        np.testing.assert_allclose(out, out_ref, rtol=0, atol=1e-12, err_msg=name)
        for bn, st in st_ref.items():
            i, j = bn.split("_")[1:]
            np.testing.assert_allclose(buffers[f"bn_blocks.{i}.{j}.running_mean"],
                                       st["mean"], rtol=0, atol=1e-12, err_msg=name)
            np.testing.assert_allclose(buffers[f"bn_blocks.{i}.{j}.running_var"],
                                       st["var"], rtol=0, atol=1e-12, err_msg=name)
        f1 = np.concatenate([grads[k].ravel() for k in sorted(grads)])
        f2 = np.concatenate([ref_grad(g_ref, k).ravel() for k in sorted(grads)])
        assert np.linalg.norm(f1 - f2) / np.linalg.norm(f2) < 1e-10, name
