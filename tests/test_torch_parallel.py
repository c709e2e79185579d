"""The port's parallel layer (``modal_examples_tpu_torch/parallel/``) against
the JAX package's, the counterparts of ``tests/test_parallel.py``.

Two CPU rank processes over gloo (``torch_rank_cases.gang_fixture``) run the
port; the JAX side runs in this process on the 8-device CPU mesh, its
collectives under ``shard_map`` over 2 devices. Each case holds:

- the mesh: the fill axis, canonical axis order, a size mismatch and a card
  spec that does not match the world size (``TestMesh``), ``resolve_axes``
  against the JAX function;
- the collectives: ``psum``, ``axis_index``, ``pmean``/``pmax``/``pmin``,
  ``ring_shift``, ``all_gather`` (tiled and not), ``reduce_scatter``,
  ``all_to_all`` and ``barrier`` against the JAX ones, exactly (f32 sums of
  two values);
- ``ppermute``'s gradient: the reverse permutation;
- ``fsdp_specs`` leaf for leaf against the JAX placements, and
  ``shard_pytree``'s blocks.
"""

import numpy as np
import pytest

from test_torch_time_limit import share_cores, time_limits
import torch_rank_cases as cases

share_cores()

_limit_module, _limit_test = time_limits(test_s=60, module_s=120)
gang = cases.gang_fixture(2)


@pytest.fixture(scope="module")
def jax(jax_cpu):
    return jax_cpu


def _jax_mesh(jax, axes, n: int = 2):
    from modal_examples_tpu.parallel import make_mesh

    return make_mesh(axes, devices=jax.devices()[:n])


def _shard_map(jax, mesh, fn, in_specs, out_specs):
    from modal_examples_tpu.parallel.mesh import shard_map_compat

    return shard_map_compat(fn, mesh=mesh, in_specs=in_specs, out_specs=out_specs, check_vma=False)


@pytest.mark.parametrize("axes,n,want", [
    (None, 8, {"data": 8}),
    ({"data": -1, "tensor": 4}, 8, {"data": 2, "tensor": 4}),
    ({"tensor": 2, "data": -1}, 2, {"tensor": 2, "data": 1}),
])
def test_resolve_axes_matches_jax(jax, axes, n, want):
    from modal_examples_tpu.parallel.mesh import resolve_axes as jresolve
    from modal_examples_tpu_torch.parallel.mesh import resolve_axes

    assert resolve_axes(axes, n) == jresolve(axes, n) == want


@pytest.mark.parametrize("axes", [{"data": 3, "tensor": 4}, {"data": -1, "tensor": -1}, {"data": 3, "tensor": -1}])
def test_resolve_axes_refuses_as_jax_does(jax, axes):
    from modal_examples_tpu.parallel.mesh import resolve_axes as jresolve
    from modal_examples_tpu_torch.parallel.mesh import resolve_axes

    with pytest.raises(ValueError):
        jresolve(axes, 8)
    with pytest.raises(ValueError):
        resolve_axes(axes, 8)


class TestMesh:
    def test_default_data_mesh(self, gang):
        for names, sizes, coord in gang.run(cases.mesh_layout, None):
            assert names == ["data"] and sizes == {"data": 2}
        assert [c["data"] for _, _, c in gang.run(cases.mesh_layout, None)] == [0, 1]

    def test_fill_and_canonical_order(self, gang, jax):
        jmesh = _jax_mesh(jax, {"tensor": 1, "data": -1})
        out = gang.run(cases.mesh_layout, {"tensor": 1, "data": -1})
        for names, sizes, _ in out:
            assert tuple(names) == jmesh.axis_names == ("data", "tensor")
            assert sizes == dict(zip(jmesh.axis_names, jmesh.devices.shape))

    def test_axis_mismatch_raises(self, gang):
        assert all("multiply to 3" in m for m in gang.run(cases.mesh_refused, {"data": 3}, None))

    def test_spec_validation(self, gang):
        assert all("wants 4 cards" in m for m in gang.run(cases.mesh_refused, {"data": 2}, "H100:4"))
        assert gang.run(cases.mesh_refused, {"data": 2}, "H100:2") == ["", ""]


@pytest.fixture(scope="module")
def collective_out(gang):
    x = np.arange(16, dtype=np.float32).reshape(4, 4) * 0.5 - 3.0
    return x, gang.run(cases.collectives, x)


class TestCollectives:
    def test_psum_and_axis_index(self, jax, collective_out):
        import jax.numpy as jnp
        from jax.sharding import PartitionSpec as P
        from modal_examples_tpu.parallel import collectives as col

        x, out = collective_out
        mesh = _jax_mesh(jax, {"data": 2})
        want = _shard_map(jax, mesh, lambda s: col.psum(s, "data") + 0 * col.axis_index("data"), P("data"),
                          P("data"))(jnp.ones(x.shape, jnp.float32))
        for r, o in enumerate(out):
            assert o["axis_index"] == r and o["axis_size"] == 2
            np.testing.assert_array_equal(o["psum"], np.asarray(want).reshape(2, 2, 4)[r])
            assert o["input_kept"]

    @pytest.mark.parametrize("op", ["pmean", "pmax", "pmin"])
    def test_reductions(self, jax, collective_out, op):
        import jax.numpy as jnp
        from jax.sharding import PartitionSpec as P
        from modal_examples_tpu.parallel import collectives as col

        x, out = collective_out
        mesh = _jax_mesh(jax, {"data": 2})
        want = np.asarray(_shard_map(jax, mesh, lambda s: getattr(col, op)(s, "data"), P("data"), P("data"))(
            jnp.asarray(x))).reshape(2, 2, 4)
        for r, o in enumerate(out):
            np.testing.assert_array_equal(o[op], want[r])

    def test_ring_shift(self, jax, collective_out):
        import jax.numpy as jnp
        from jax.sharding import PartitionSpec as P
        from modal_examples_tpu.parallel import collectives as col

        x, out = collective_out
        mesh = _jax_mesh(jax, {"data": 2})
        want = np.asarray(_shard_map(jax, mesh, lambda s: col.ring_shift(s, "data", 1), P("data"), P("data"))(
            jnp.asarray(x))).reshape(2, 2, 4)
        for r, o in enumerate(out):
            np.testing.assert_array_equal(o["ring_shift"], want[r])

    def test_all_gather_and_reduce_scatter(self, jax, collective_out):
        import jax.numpy as jnp
        from jax.sharding import PartitionSpec as P
        from modal_examples_tpu.parallel import collectives as col

        x, out = collective_out
        mesh = _jax_mesh(jax, {"data": 2})
        gathered = _shard_map(jax, mesh, lambda s: col.all_gather(s, "data"), P("data"), P(None))(jnp.asarray(x))
        scattered = np.asarray(_shard_map(jax, mesh, lambda s: col.reduce_scatter(s, "data"), P(None), P("data"))(
            jnp.asarray(x))).reshape(2, 2, 4)
        untiled = _shard_map(jax, mesh, lambda s: col.all_gather(s, "data", tiled=False), P("data"), P(None))(
            jnp.asarray(x))
        for r, o in enumerate(out):
            np.testing.assert_array_equal(o["all_gather"], np.asarray(gathered))
            np.testing.assert_array_equal(o["all_gather_untiled"], np.asarray(untiled))
            np.testing.assert_array_equal(o["reduce_scatter"], scattered[r])

    def test_all_to_all_and_barrier(self, jax, collective_out):
        import jax.numpy as jnp
        from jax.sharding import PartitionSpec as P
        from modal_examples_tpu.parallel import collectives as col

        x, out = collective_out
        mesh = _jax_mesh(jax, {"data": 2})
        want = np.asarray(_shard_map(
            jax, mesh, lambda s: col.all_to_all(s, "data", split_dim=0, concat_dim=0), P("data"), P("data"),
        )(jnp.asarray(x))).reshape(2, 2, 4)
        bar = _shard_map(jax, mesh, lambda s: col.barrier("data") + 0 * s[0, 0].astype(jnp.int32), P("data"), P())(
            jnp.asarray(x))
        for r, o in enumerate(out):
            np.testing.assert_array_equal(o["all_to_all"], want[r])
            assert int(o["barrier"]) == int(bar) == 2

    def test_ppermute_one_way(self, jax, collective_out):
        import jax.numpy as jnp
        from jax.sharding import PartitionSpec as P
        from modal_examples_tpu.parallel import collectives as col

        x, out = collective_out
        mesh = _jax_mesh(jax, {"data": 2})
        want = np.asarray(_shard_map(jax, mesh, lambda s: col.ppermute(s, "data", [(0, 1)]), P("data"), P("data"))(
            jnp.asarray(x))).reshape(2, 2, 4)
        for r, o in enumerate(out):
            np.testing.assert_array_equal(o["ppermute_one_way"], want[r])
        assert not want[0].any()  # a rank that receives nothing gets zeros

    def test_psum_tree_is_one_all_reduce_a_dtype(self, collective_out):
        x, out = collective_out
        total = x.reshape(2, 2, 4).sum(axis=0)
        for o in out:
            tree = o["psum_tree"]
            np.testing.assert_array_equal(tree["f32"], total)
            np.testing.assert_array_equal(tree["f32_row"], total[0])
            np.testing.assert_array_equal(tree["bf16"], total)  # halves and small integers: exact in bf16
            assert o["psum_tree_calls"] - o["psum_calls_before_tree"] == 2


def test_ppermute_gradient_is_the_reverse_permutation(jax, gang):
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P
    from modal_examples_tpu.parallel import collectives as col

    rng = np.random.default_rng(0)
    x = rng.standard_normal((4, 3)).astype(np.float32)
    w = rng.standard_normal((4, 3)).astype(np.float32)
    mesh = _jax_mesh(jax, {"data": 2})
    shift = _shard_map(jax, mesh, lambda s: col.ring_shift(s, "data", 1), P("data"), P("data"))
    y_want = np.asarray(shift(jnp.asarray(x))).reshape(2, 2, 3)
    g_want = np.asarray(jax.grad(lambda a: jnp.sum(shift(a) * jnp.asarray(w)))(jnp.asarray(x))).reshape(2, 2, 3)
    for r, (y, g) in enumerate(gang.run(cases.ppermute_grad, x, w)):
        np.testing.assert_array_equal(y, y_want[r])
        np.testing.assert_array_equal(g, g_want[r])


def test_fsdp_specs_match_jax_leaf_for_leaf(jax, gang):
    import jax.numpy as jnp
    from modal_examples_tpu.parallel.mesh import fsdp_specs as jfsdp

    shapes = {"embed": (512, 64), "wq": (64, 96), "odd": (63, 65), "norm": (64,), "small": (8, 8),
              "stack": (3, 64, 128)}
    mesh = _jax_mesh(jax, {"fsdp": 2})
    want = jfsdp({k: jnp.zeros(s) for k, s in shapes.items()}, mesh, min_size=2**10)
    for got in gang.run(cases.fsdp_specs_of, shapes, 2**10):
        assert got == {k: tuple(v) for k, v in want.items()}


def test_shard_pytree_places_leaves(jax, gang):
    x = np.arange(32, dtype=np.float32).reshape(16, 2)
    for r, (w, b) in enumerate(gang.run(cases.shard_pytree_blocks, x)):
        np.testing.assert_array_equal(w, x[8 * r : 8 * (r + 1)])
        np.testing.assert_array_equal(b, np.ones(3, np.float32))


@pytest.fixture(scope="module")
def gang4(tmp_path_factory):
    from modal_examples_tpu_torch.parallel.cluster import RankGang

    store = tmp_path_factory.mktemp("rendezvous4") / "store"
    with RankGang(4, backend="gloo", device="cpu", init_method=f"file://{store}", env=cases.RANK_ENV) as g:
        yield g


@pytest.fixture(scope="module")
def moe_setup(jax):
    from modal_examples_tpu.models import moe as jmoe

    cfg_kw = dict(n_experts=8, top_k=2, capacity_factor=1.5, d_model=32, d_ff=64)
    params = jmoe.init_params(jax.random.PRNGKey(0), jmoe.MoEConfig(**cfg_kw))
    x = jax.random.normal(jax.random.PRNGKey(1), (64, 32))
    return cfg_kw, params, x


@pytest.mark.parametrize("n", [2, 4])
def test_moe_mlp_ep_equals_moe_mlp_groups_and_the_jax_ep(jax, moe_setup, gang, gang4, n):
    """The counterpart of ``tests/test_moe.py:76-90``: expert parallelism
    over ``n`` ranks equals the one-device layer with ``groups=n`` (the same
    per-group capacities) at 1e-4, and the JAX ``moe_mlp_ep`` on an
    ``expert`` mesh of ``n``."""
    import torch

    from modal_examples_tpu.models import moe as jmoe
    from modal_examples_tpu_torch.models import moe as tmoe

    cfg_kw, params, x = moe_setup
    np_params = {k: np.array(v) for k, v in params.items()}
    dense, dense_aux = tmoe.moe_mlp({k: torch.from_numpy(v) for k, v in np_params.items()},
                                    torch.from_numpy(np.array(x)), tmoe.MoEConfig(**cfg_kw), groups=n)
    want, want_aux = jmoe.moe_mlp_ep(params, x, jmoe.MoEConfig(**cfg_kw), _jax_mesh(jax, {"expert": n}, n))
    out = (gang if n == 2 else gang4).run(cases.moe_ep, np_params, np.asarray(x), cfg_kw)
    got = np.concatenate([o for o, _ in out])
    np.testing.assert_allclose(got, dense.numpy(), atol=1e-4)
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-4)
    for _, aux in out:
        assert aux == pytest.approx(float(dense_aux), abs=1e-5)
        assert aux == pytest.approx(float(want_aux), abs=1e-5)


def test_a_failing_rank_fails_the_call_and_no_rank_outlives_it(tmp_path):
    import time

    from modal_examples_tpu_torch.parallel.cluster import RankFailed, RankGang

    gang = RankGang(2, device="cpu", init_method=f"file://{tmp_path / 'store'}", env=cases.RANK_ENV)
    procs = list(gang._procs)
    with pytest.raises(RankFailed, match="rank 1 fails on purpose"):
        gang.run(cases.fail_on_rank, 1)
    deadline = time.monotonic() + 10
    while any(p.is_alive() for p in procs) and time.monotonic() < deadline:
        time.sleep(0.05)
    assert not any(p.is_alive() for p in procs)
    with pytest.raises(RuntimeError, match="closed"):
        gang.run(cases.fail_on_rank, 0)


def test_a_rank_without_a_card_raises_unless_it_asks_for_the_cpu():
    import torch

    from modal_examples_tpu_torch.parallel.cluster import init_distributed

    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_distributed(rank=0, world_size=1, init_method="file:///nonexistent")
