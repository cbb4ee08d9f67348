"""The port's parallel layer: mesh construction and its rank layout,
``shard_rows_pad``, ``distributed_init``, the hand-written collectives and
their gradients, the cross-shard embedding lookup (equal to a plain gather,
its gradient only on the owning shard), and sharded checkpoints.

The multi-rank checks run in one spawn of four gloo ranks on the CPU
(``parallel/spawn.run_ranks``, a ``file://`` rendezvous in a temporary
directory) whose results the tests read.
"""
import os

import numpy as np
import pytest
import torch

from laplace_gnn_recommendation_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    build_mesh,
    distributed_init,
    round_up,
    shard_rows_pad,
)

TABLE = np.random.default_rng(0).normal(size=(64, 16)).astype(np.float32)
IDS = np.random.default_rng(1).integers(0, 64, 33)


def _rank_checks(ckpt_dir):
    """Every multi-rank check on one rank of a 4-rank world; returns what the
    tests assert on."""
    import torch.distributed as dist

    from laplace_gnn_recommendation_tpu_torch.ops.embedding import (
        shard_table,
        sharded_embedding_lookup,
    )
    from laplace_gnn_recommendation_tpu_torch.parallel.collectives import (
        all_gather_rows,
        psum,
        sync_grads,
    )
    from laplace_gnn_recommendation_tpu_torch.train.checkpoint import load_latest, save_state

    out = {"rank": dist.get_rank()}
    shapes = {}
    for spec in [(2, 2), (-1, 2), (1, -1), (-1, -1), (4, 1)]:
        m = build_mesh(*spec, device="cpu")
        shapes[spec] = (m.size(DATA_AXIS), m.size(MODEL_AXIS), m.rank(DATA_AXIS),
                        m.rank(MODEL_AXIS), m.row_range(8), m.batch_slice(10))
    out["shapes"] = shapes
    try:
        build_mesh(3, 1, device="cpu")
    except ValueError as e:
        out["bad_shape"] = str(e)

    mesh = build_mesh(2, 2, device="cpu")
    # the cross-shard lookup and its gradient
    table = shard_table(mesh, torch.from_numpy(TABLE)).requires_grad_()
    got = sharded_embedding_lookup(mesh, table, torch.from_numpy(IDS))
    (got ** 2).sum().backward()
    out["lookup"] = got.detach().numpy()
    out["lookup_grad"] = table.grad.numpy()
    ones = shard_table(mesh, torch.ones(64, 8)).requires_grad_()
    (sharded_embedding_lookup(mesh, ones, torch.tensor([3, 50])) ** 2).sum().backward()
    out["touched_grad"] = ones.grad.numpy()

    # collectives: all_gather_rows (backward reduce-scatter), psum (backward
    # identity), sync_grads (backward all-reduce over data)
    r = mesh.rank(MODEL_AXIS)
    x = torch.full((2, 3), float(r + 1), requires_grad=True)
    full = all_gather_rows(x, mesh)
    (full * torch.arange(4.0)[:, None]).sum().backward()
    out["gathered"] = full.detach().numpy()
    out["gather_grad"] = x.grad.numpy()
    y = torch.full((3,), float(r + 1), requires_grad=True)
    s = psum(y, mesh)
    s.sum().backward()
    out["psum"], out["psum_grad"] = s.detach().numpy(), y.grad.numpy()
    z = torch.ones(2, requires_grad=True)
    (sync_grads(z, mesh) * float(mesh.rank(DATA_AXIS) + 1)).sum().backward()
    out["sync_grad"] = z.grad.numpy()

    # a sharded checkpoint: row blocks of a table, a replicated tensor and an
    # int, written by every rank and read back into zeros
    state = {"table": table.detach().clone(), "rep": torch.arange(5.0), "count": 7}
    sharded = lambda key: key.startswith("['table']")  # noqa: E731
    out["ckpt_path"] = save_state(os.path.join(ckpt_dir, "model_4"), state, sharded=True,
                                  mesh=mesh, row_sharded=sharded)
    template = {"table": torch.zeros_like(table), "rep": torch.zeros(5), "count": 0}
    back, ver = load_latest(ckpt_dir, template, mesh=mesh, row_sharded=sharded)
    out["ckpt_ver"] = ver
    out["ckpt_ok"] = (torch.equal(back["table"], state["table"])
                      and torch.equal(back["rep"], state["rep"]) and back["count"] == 7)
    return out


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    from laplace_gnn_recommendation_tpu_torch.parallel.spawn import run_ranks

    ckpt = str(tmp_path_factory.mktemp("dcp"))
    return run_ranks(_rank_checks, 4, (ckpt,), timeout=300)


class TestMesh:
    def test_round_up(self):
        assert round_up(5, 4) == 8 and round_up(8, 4) == 8

    def test_one_rank_mesh_needs_no_process_group(self):
        m = build_mesh(device="cpu")
        assert m.shape == {DATA_AXIS: 1, MODEL_AXIS: 1} and m.device_mesh is None
        assert m.row_range(8) == (0, 8) and m.batch_slice(5) == slice(0, 5)
        assert shard_rows_pad(9, m) == 9
        with pytest.raises(ValueError, match="2x1 != 1"):
            build_mesh(2, 1, device="cpu")

    def test_shapes_and_layout(self, ranks):
        for r, out in enumerate(ranks):
            s = out["shapes"]
            # rank r sits at (data r // M, model r % M)
            assert s[(2, 2)] == (2, 2, r // 2, r % 2, ((r % 2) * 4, (r % 2) * 4 + 4),
                                 slice(5 * (r // 2), 5 * (r // 2) + 5))
            assert s[(-1, 2)][:2] == (2, 2)
            assert s[(1, -1)][:4] == (1, 4, 0, r)
            assert s[(-1, -1)][:2] == (4, 1)
            # 10 rows over 4 data ranks: 3, 3, 2, 2
            assert s[(4, 1)][5] == [slice(0, 3), slice(3, 6), slice(6, 8), slice(8, 10)][r]
            assert "3x1 != 4" in out["bad_shape"]

    def test_shard_rows_pad(self, ranks):
        from types import SimpleNamespace

        m = SimpleNamespace(shape={DATA_AXIS: 2, MODEL_AXIS: 4})
        assert shard_rows_pad(9, m) == 12 and shard_rows_pad(0, m) == 4


class TestDistributedInit:
    def test_noop_without_launcher(self, monkeypatch):
        for var in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
            monkeypatch.delenv(var, raising=False)
        assert distributed_init() is False
        monkeypatch.setenv("WORLD_SIZE", "1")
        monkeypatch.setenv("RANK", "0")
        assert distributed_init() is False

    def test_strict_raises_on_init_failure(self, monkeypatch):
        """A launched rank that cannot join raises, with no flag to ask for
        it: one process per card must not carry on as a run of its own."""
        import torch.distributed as dist

        monkeypatch.setenv("WORLD_SIZE", "2")
        monkeypatch.setenv("RANK", "1")

        def boom(*a, **kw):
            raise RuntimeError("rendezvous unreachable")

        with monkeypatch.context() as m:
            m.setattr(dist, "init_process_group", boom)
            with pytest.raises(RuntimeError, match="unreachable"):
                distributed_init(device="cpu")
        # a real failing rendezvous: a scheme no handler serves
        with pytest.raises((RuntimeError, ValueError), match="bogus"):
            distributed_init(init_method="bogus://nowhere", device="cpu")
        assert not dist.is_initialized()

    def test_default_device_is_the_card(self, monkeypatch):
        monkeypatch.setenv("WORLD_SIZE", "2")
        monkeypatch.setenv("RANK", "0")
        if torch.cuda.is_available():
            pytest.skip("a card is present")
        with pytest.raises(RuntimeError, match="no CUDA device"):
            distributed_init()


class TestCollectives:
    def test_all_gather_rows_and_reduce_scatter_backward(self, ranks):
        want = np.repeat([1.0, 2.0], 2)[:, None] * np.ones((4, 3))
        for r, out in enumerate(ranks):
            np.testing.assert_array_equal(out["gathered"], want)
            # d/dx of Σ_rows row_index·full, summed over the 2 model ranks
            m = r % 2
            np.testing.assert_array_equal(out["gather_grad"][:, 0], 2 * np.array([2 * m, 2 * m + 1]))

    def test_psum_backward_is_identity(self, ranks):
        for out in ranks:
            np.testing.assert_array_equal(out["psum"], np.full(3, 3.0))
            np.testing.assert_array_equal(out["psum_grad"], np.ones(3))

    def test_sync_grads_sums_over_data(self, ranks):
        for out in ranks:
            np.testing.assert_array_equal(out["sync_grad"], np.full(2, 3.0))


class TestShardedEmbedding:
    def test_matches_plain_gather(self, ranks):
        for out in ranks:
            np.testing.assert_array_equal(out["lookup"], TABLE[IDS])

    def test_gradient_lands_on_the_owning_shard(self, ranks):
        want = np.zeros_like(TABLE)
        np.add.at(want, IDS, 2 * TABLE[IDS])
        for r, out in enumerate(ranks):
            lo = (r % 2) * 32
            np.testing.assert_allclose(out["lookup_grad"], want[lo:lo + 32], rtol=1e-6)
            touched = np.flatnonzero(np.abs(out["touched_grad"]).sum(axis=1)) + lo
            assert touched.tolist() == [i for i in (3, 50) if lo <= i < lo + 32]

    def test_single_rank_mesh_is_a_plain_gather(self):
        from laplace_gnn_recommendation_tpu_torch.ops.embedding import sharded_embedding_lookup

        m = build_mesh(device="cpu")
        table = torch.arange(32.0).reshape(8, 4)
        got = sharded_embedding_lookup(m, table, torch.tensor([1, 7]))
        np.testing.assert_array_equal(got.numpy(), table[[1, 7]].numpy())


class TestShardedCheckpoint:
    def test_round_trip(self, ranks):
        for out in ranks:
            assert out["ckpt_path"].endswith("model_4.dcp")
            assert out["ckpt_ver"] == 4 and out["ckpt_ok"]

    def test_refuses_a_jax_orbax_directory(self, tmp_path):
        from laplace_gnn_recommendation_tpu_torch.train.checkpoint import load_latest

        os.makedirs(tmp_path / "model_9.orbax")
        with pytest.raises(ValueError, match="model_9.orbax is an orbax checkpoint"):
            load_latest(str(tmp_path), {"x": torch.zeros(1)})
