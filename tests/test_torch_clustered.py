"""``@clustered`` in the port's serverless layer, the counterpart of
``tests/test_parallel.py:133-171``.

An app file written under the module's temporary directory (module-level
functions travel to containers by reference) declares gang functions:

- ``@clustered(size=2, chips_per_host=2)``: one ``.remote()`` boots 2
  containers, each runs the function in 2 rank processes
  (``spawn_ranks``), and the 4 ranks join one gloo group over the
  ``tcp://`` coordinator of container 0: a ``psum`` over the ``data`` mesh
  of every rank's block (container ``r``'s ranks hold ``r + 1``) is 24.0,
  as in the JAX test, and the call resolves with rank 0's value;
- a rank that raises fails the call;
- ``@clustered(size=1)`` joins a group of one;
- ``get_cluster_info()`` outside a cluster raises, ``@clustered`` over
  ``@app.function`` raises, and the options no longer wait.
"""

import pytest

from test_torch_time_limit import share_cores, time_limits

share_cores()

_limit_module, _limit_test = time_limits(test_s=120, module_s=180)

APP = '''
import modal_examples_tpu_torch as mtpu

app = mtpu.App("cluster-test")


@app.function(timeout=150)
@mtpu.experimental.clustered(size=2, chips_per_host=2)
def allreduce_job():
    import os

    import torch

    from modal_examples_tpu_torch.parallel import cluster, collectives, make_mesh

    torch.set_num_threads(1)
    info = cluster.get_cluster_info()
    cluster.init_distributed(device="cpu")
    mesh = make_mesh({"data": 4})
    block = torch.full((2, 2), float(info.rank + 1))
    total = collectives.psum(block.sum(), "data", mesh)
    return (float(total), info.rank, info.size, info.chips_per_host, torch.distributed.get_rank(),
            torch.distributed.get_world_size(), int(os.environ[cluster.LOCAL_RANK_ENV]))


@app.function(timeout=120)
@mtpu.experimental.clustered(size=2)
def failing_rank():
    info = mtpu.experimental.get_cluster_info()
    if info.rank == 1:
        raise RuntimeError("rank 1 of the gang fails")
    return "rank 0 finished"


@app.function(timeout=120)
@mtpu.experimental.clustered(size=1)
def one_rank():
    import torch

    from modal_examples_tpu_torch.parallel import cluster, collectives, make_mesh

    cluster.init_distributed(device="cpu")
    mesh = make_mesh({"tensor": 1})
    return float(collectives.psum(torch.ones(3), "tensor", mesh).sum()), torch.distributed.get_world_size()
'''


@pytest.fixture(scope="module")
def gang_app(tmp_path_factory):
    from modal_examples_tpu_torch.core import app as papp

    path = tmp_path_factory.mktemp("cluster-app") / "cluster_app.py"
    path.write_text(APP)
    mod = papp.load_module_from_path(str(path))
    with mod.app.run():
        yield mod


def test_gang_psum_over_two_containers_of_two_ranks(gang_app):
    total, rank, size, chips, grank, world, local = gang_app.allreduce_job.remote()
    assert total == pytest.approx(24.0)
    assert (rank, size, chips, grank, world, local) == (0, 2, 2, 0, 4, 0)


def test_a_failing_rank_fails_the_call(gang_app):
    with pytest.raises(Exception, match="rank 1 of the gang fails"):
        gang_app.failing_rank.remote()


def test_a_gang_of_one(gang_app):
    assert gang_app.one_rank.remote() == (3.0, 1)


def test_cluster_info_outside_raises():
    import modal_examples_tpu_torch as mtpu

    with pytest.raises(RuntimeError, match="outside a @clustered container"):
        mtpu.experimental.get_cluster_info()


def test_clustered_over_app_function_raises():
    import modal_examples_tpu_torch as mtpu

    app = mtpu.App("cluster-order")
    with pytest.raises(TypeError, match="UNDER @app.function"):
        mtpu.experimental.clustered(size=2)(app.function()(lambda: 1))


def test_cluster_options_reach_the_spec():
    import modal_examples_tpu_torch as mtpu
    from modal_examples_tpu_torch.core.app import WAITING_OPTIONS

    assert "cluster_size" not in WAITING_OPTIONS and "cluster_chips_per_host" not in WAITING_OPTIONS
    app = mtpu.App("cluster-spec")
    f = app.function()(mtpu.experimental.clustered(size=3, chips_per_host=2)(lambda: 1))
    assert (f.spec.cluster_size, f.spec.cluster_chips_per_host) == (3, 2)
