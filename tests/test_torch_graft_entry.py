"""The port's graft entry points (``laplace_gnn_recommendation_tpu_torch/
graft_entry.py``): ``entry()``'s loss against the JAX
``__graft_entry__.entry()`` on the same arguments (rtol 1e-5: f32 sums in
another order), and ``dryrun_multichip(4)`` — the public pipelines on a 2×2
mesh of four spawned gloo ranks on the CPU, the store-backed ranking stack
among them (its sampler's queries answered by an ``InMemoryGraphStore``)."""
import numpy as np
import pytest

from laplace_gnn_recommendation_tpu_torch.graft_entry import dryrun_multichip, entry


def test_entry_loss_matches_jax():
    import jax
    import jax.numpy as jnp

    import __graft_entry__ as jentry

    fn, args = entry(device="cpu")
    jfn, jargs = jentry.entry()
    for a, b in zip(args, jargs):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    got = float(fn(*args))
    want = float(jax.jit(jfn)(*(jnp.asarray(a.numpy()) for a in args)))
    assert np.isfinite(got)
    assert got == pytest.approx(want, rel=1e-5)


def test_dryrun_multichip_4():
    ranks = dryrun_multichip(4, device="cpu", timeout=600)
    assert len(ranks) == 4
    first = ranks[0]
    assert first["mesh"] == (2, 2)
    for r in ranks:
        for key in ("lightgcn_loss", "encdec_loss", "pinsage_loss"):
            assert np.isfinite(r[key]) and r[key] == first[key], key
        # every rank samples the whole batch from the one seed, so each
        # rank's store answers the same queries
        assert r["graph_store"]["queries_served"] > 0
        assert r["graph_store"] == first["graph_store"]
        assert np.isfinite(r["graph_store"]["loss"])
        np.testing.assert_array_equal(r["retrieval"], first["retrieval"])
        assert (r["retrieval"] < 301).all() and r["submission_rows"] > 0
