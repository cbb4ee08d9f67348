"""Each cell's correctness check against the faults its timed path can
have: a run with the program broken underneath (everything else as a run
does it, at a CPU test's size) must come out not correct, and a sound run
correct. The controls (the reference one precision below in the program's
place) run where that precision exists: TF32 only on the card."""
import pytest

from conftest import run_tiny


def test_sound_runs_are_correct(spec):
    for wl in spec["workloads"]:
        out = run_tiny(spec, wl["name"])
        assert out["correct"], (wl["name"], out["checks"])


# ---- training: a step that leaves its state unchanged; half the batch ----

def test_lightgcn_step_that_changes_nothing(spec, monkeypatch):
    from laplace_gnn_recommendation_tpu_torch.train import lightgcn_pipeline as lp

    real = lp.make_train_step

    def frozen(*a, **kw):
        step, tx = real(*a, **kw)

        def still(params, opt_state, gen):
            p2 = type(params)(params.user_emb.clone(), params.item_emb.clone())
            _, opt2, loss = step(p2, opt_state, gen)
            return params, opt2, loss

        return still, tx

    monkeypatch.setattr(lp, "make_train_step", frozen)
    out = run_tiny(spec, "lightgcn-hm.train")
    assert not out["correct"] and out["checks"]["change_norm_gap"]["value"] > 0.9


def test_lightgcn_half_the_batch(spec, monkeypatch):
    from laplace_gnn_recommendation_tpu_torch.train import lightgcn_pipeline as lp

    real = lp.sample_bpr_batch

    def half(*a, **kw):
        u, pos, neg = real(*a, **kw)
        n = u.shape[0] // 2
        return u[:n], pos[:n], neg[:n]

    monkeypatch.setattr(lp, "sample_bpr_batch", half)
    out = run_tiny(spec, "lightgcn-hm.train")
    assert not out["correct"], out["checks"]


def test_sage_step_that_changes_nothing(spec, monkeypatch):
    from laplace_gnn_recommendation_tpu_torch.train import encdec_pipeline as ep

    def no_update(self, grads, state, params):
        return state

    monkeypatch.setattr(ep.Adam, "update_", no_update)
    out = run_tiny(spec, "sage-hm.train")
    assert not out["correct"] and out["checks"]["change_norm_gap"]["value"] > 0.9


def test_sage_half_the_batch(spec, monkeypatch):
    from laplace_gnn_recommendation_tpu_torch.models import sage

    real = sage.bce_loss

    def half(logits, batch, rows=None):
        n = logits.shape[0] // 2
        return real(logits[:n], batch, slice(0, n)) * 2.0

    monkeypatch.setattr(sage, "bce_loss", half)
    out = run_tiny(spec, "sage-hm.train")
    assert not out["correct"], out["checks"]


# ---- serving: an answer altered where it is produced ----

def test_retrieval_answer_altered(spec, monkeypatch):
    from laplace_gnn_recommendation_tpu_torch import serving

    real = serving.RetrievalServer.recommend

    def altered(self, users, k=None):
        ids, vals = real(self, users, k)
        ids = ids.copy()
        ids[::7, -1] = (ids[::7, -1] + 1) % self.num_items
        return ids, vals

    monkeypatch.setattr(serving.RetrievalServer, "recommend", altered)
    out = run_tiny(spec, "lightgcn-hm.retrieve")
    assert not out["correct"], out["checks"]


def test_lightgcn_train_control_fails(spec):
    """fp8 gathers in the propagation (one precision below the configured
    bf16) fail the training check; it needs no card."""
    out = run_tiny(spec, "lightgcn-hm.train", control=True)
    assert not out["correct"], out["checks"]


@pytest.mark.requires_cuda
@pytest.mark.parametrize("workload", ["lightgcn-hm.retrieve", "sage-hm.train"])
def test_tf32_controls_fail_on_the_card(spec, cuda_device, workload):
    """The TF32 controls, at a test's size, on the card (TF32 exists only
    there)."""
    out = run_tiny(spec, workload, control=True, device=cuda_device, seconds=1.0)
    assert not out["correct"], out["checks"]
