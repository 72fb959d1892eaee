"""Checkpoint and resume in nfmc_torch (``nfmc_torch/checkpoint.py`` and
``sample()``'s ``checkpoint_*`` arguments), modelled on
``tests/test_checkpoint.py``: the npz round trip and its refusals, the
nested sampler state, and runs cut into segments that resume after a
simulated crash bit for bit (draws, counters, moments, kernel state, flow
weights) on a fresh sampler, on the CPU at small sizes."""
import os

import numpy as np
import pytest
import torch

import nfmc_torch
from nfmc_torch.checkpoint import (
    CHECKPOINT_FORMAT_VERSION,
    _tree_signature,
    discard_resumable_checkpoint,
    load_checkpoint,
    restore_sampler_state,
    sample_resumable,
    sampler_state,
    save_checkpoint,
    segment_seed,
)
from nfmc_torch.core.tuning import DualAveragingState
from nfmc_torch.potentials import StandardGaussian
from nfmc_torch.samplers.mcmc.base import MetropolisState
from nfmc_torch.utils import tree_leaves

D, C = 3, 6
FLOW = 'realnvp%{"n_layers": 2, "hidden_size": 8}'


def _sampler(strategy, **kw):
    extra = {"negative_log_likelihood": StandardGaussian((D,))} if strategy == "ess" else {}
    if strategy == "jump_mala":
        kw.setdefault("inner_param_kwargs", {"n_iterations": 2, "n_warmup_iterations": 4})
        kw.setdefault("param_kwargs", {"flow_fit_kwargs": {"n_epochs": 2}})
    sampler = nfmc_torch.create_sampler(StandardGaussian((D,)), strategy=strategy, flow=FLOW,
                                        device="cpu", flow_kwargs={"seed": 1}, **extra, **kw)
    sampler.params.n_iterations = 10
    sampler.params.n_warmup_iterations = 6
    return sampler


def _x0(n=C, seed=0):
    return torch.randn((n, D), generator=torch.Generator().manual_seed(seed))


def _crash_after(sampler, n_segments):
    """Make the sampler raise when its ``n_segments + 1``-th segment starts
    (an entry through ``sample`` or ``sample_continue``; inner calls pass)."""
    calls = {"n": 0, "inside": False}

    def wrap(fn):
        def run(*a, **k):
            if calls["inside"]:
                return fn(*a, **k)
            if calls["n"] == n_segments:
                raise RuntimeError("simulated preemption")
            calls["n"] += 1
            calls["inside"] = True
            try:
                return fn(*a, **k)
            finally:
                calls["inside"] = False
        return run

    sampler.sample = wrap(sampler.sample)
    sampler.sample_continue = wrap(sampler.sample_continue)


def _kernel_leaves(sampler):
    state = sampler_state(sampler, torch.zeros(1), 0)
    state.pop("x"), state.pop("seed")
    from nfmc_torch.checkpoint import _flatten

    return [leaf for _, leaf in _flatten(state)]


def _equal(a, b):
    if isinstance(a, torch.Tensor):
        return torch.equal(a.cpu(), b.cpu())
    return np.array_equal(np.asarray(a), np.asarray(b))


def test_npz_round_trip_keeps_each_leaf_kind(tmp_path):
    state = {"a": torch.arange(4.0), "b": [torch.ones((2, 3)), 7, 0.1 + 1e-17, True],
             "c": np.arange(3, dtype=np.int16), "none": None,
             "da": DualAveragingState(*(torch.tensor(v) for v in (1.0, 2.0, 3.0, 4.0)))}
    path = str(tmp_path / "ckpt")
    save_checkpoint(path, state, metadata={"step": 12})
    restored, meta = load_checkpoint(path, state)
    assert meta == {"step": 12}
    assert torch.equal(restored["a"], state["a"]) and restored["a"].dtype == torch.float32
    assert restored["b"][1] == 7 and type(restored["b"][1]) is int
    # a Python float keeps its float64 bits (float32 would lose them)
    assert restored["b"][2] == state["b"][2] != float(np.float32(state["b"][2]))
    assert type(restored["b"][2]) is float
    assert restored["b"][3] is True and restored["none"] is None
    assert restored["c"].dtype == np.int16 and isinstance(restored["da"], DualAveragingState)
    assert float(restored["da"].mu) == 4.0


def test_tree_signature_is_structural():
    """Key paths, not leaf counts: same-sized trees of another layout, or
    another field name, differ."""
    t = torch.zeros(2)
    assert _tree_signature({"a": t, "b": [t, t]}) == _tree_signature({"b": [t, t], "a": t})
    assert _tree_signature({"a": t, "b": [t, t]}) != _tree_signature({"a": [t, t], "b": t})
    da = DualAveragingState(t, t, t, t)
    sig = _tree_signature(MetropolisState(step_size=t, inv_mass_diag=t, da=da))
    assert '["a","da"],["a","mu"]' in sig


def test_load_refuses_a_mismatched_structure_or_version(tmp_path):
    path = str(tmp_path / "s.npz")
    save_checkpoint(path, {"a": torch.zeros(3), "b": torch.ones(3)})
    with pytest.raises(ValueError, match="does not match"):
        load_checkpoint(path, {"a": torch.zeros(3), "c": torch.ones(3)})
    data = dict(np.load(path))
    import json

    meta = json.loads(bytes(data["__meta__"].tobytes()).decode())
    meta["format_version"] = CHECKPOINT_FORMAT_VERSION + 1
    data["__meta__"] = np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8)
    np.savez(path, **data)
    with pytest.raises(ValueError, match="format_version"):
        load_checkpoint(path, {"a": torch.zeros(3), "b": torch.ones(3)})
    meta["format_version"] = CHECKPOINT_FORMAT_VERSION
    del meta["tree_signature"], data["__tree_signature__"]
    data["__meta__"] = np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8)
    np.savez(path, **data)
    with pytest.raises(ValueError, match="no key-path tree signature"):
        load_checkpoint(path, {"a": torch.zeros(3), "b": torch.ones(3)})


def test_sampler_state_restores_the_nested_tuned_kernel_and_flow(tmp_path):
    src = _sampler("jump_mala")
    src.inner_sampler.warmup(_x0(), show_progress=False, seed=3)
    src.kernel.flow.params = [{k: [t + 0.5 for t in v] for k, v in p.items()}
                              for p in src.kernel.flow.params]
    tuned = src.inner_sampler.kernel.step_size
    path = str(tmp_path / "jump.npz")
    save_checkpoint(path, sampler_state(src, _x0(), 11))
    dst = _sampler("jump_mala")
    assert dst.inner_sampler.kernel.step_size != tuned
    loaded, _ = load_checkpoint(path, sampler_state(dst, _x0(), 0))
    x, seed = restore_sampler_state(dst, loaded)
    assert torch.equal(x, _x0()) and seed == 11
    assert dst.inner_sampler.kernel.step_size == tuned
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(dst.kernel.flow.params),
                                                 tree_leaves(src.kernel.flow.params)))
    out = dst.sample(x, show_progress=False, seed=seed)
    assert torch.isfinite(out.samples).all()


@pytest.mark.parametrize("strategy", ["chees_hmc", "aies", "pt_mala", "dense_hmc"])
def test_tuned_kernel_states_round_trip(tmp_path, strategy):
    """Each kernel's ``make_state`` after a warmup comes back leaf for leaf
    on a fresh sampler."""
    src = _sampler(strategy)
    src.warmup(_x0(8), show_progress=False, seed=2)
    path = str(tmp_path / f"{strategy}.npz")
    save_checkpoint(path, sampler_state(src, _x0(8), 1))
    dst = _sampler(strategy)
    loaded, _ = load_checkpoint(path, sampler_state(dst, _x0(8), 1))
    restore_sampler_state(dst, loaded)
    want, got = _kernel_leaves(src), _kernel_leaves(dst)
    assert len(want) == len(got) and all(_equal(a, b) for a, b in zip(want, got))


def test_restore_recurses_to_any_depth():
    class Shell:
        def __init__(self, kernel, inner=None):
            self.kernel = kernel
            if inner is not None:
                self.inner_sampler = inner

    deep = _sampler("mala")
    deep.kernel.step_size = 0.777
    nested = Shell(_sampler("jump_mala").kernel, Shell(_sampler("jump_mala").kernel, deep))
    state = sampler_state(nested, torch.zeros((4, D)), 2)
    assert "inner" in state and "inner" in state["inner"]
    fresh_deep = _sampler("mala")
    restore_sampler_state(Shell(_sampler("jump_mala").kernel,
                                Shell(_sampler("jump_mala").kernel, fresh_deep)), state)
    assert abs(fresh_deep.kernel.step_size - 0.777) < 1e-6


@pytest.mark.parametrize("strategy", ["mala", "jump_mala", "adaptive_imh", "ess", "pt_mala"])
def test_resume_after_a_crash_is_bit_exact(tmp_path, strategy):
    """10 iterations in 5 segments: a run that dies after 2 segments and
    resumes on a fresh, untuned sampler equals the uninterrupted segmented
    run bit for bit: every stored draw, the counters, the moments, the
    kernel state and the flow weights. The warmup (MALA's tuning, the jump
    sampler's flow fit, ESS's ellipse, PT's ladder) runs before the first
    call only; AdaptiveIMH refits its flow during the run."""
    def fresh(warm):
        s = _sampler(strategy)
        if warm and strategy != "adaptive_imh":
            s.warmup(_x0(), show_progress=False, seed=4)
        return s

    kw = dict(segment_iterations=2, seed=5, show_progress=False, save_samples=True)
    ref = fresh(True)
    out_a = sample_resumable(ref, _x0(), str(tmp_path / "a"), **kw)
    crash = fresh(True)
    _crash_after(crash, 2)
    with pytest.raises(RuntimeError, match="preemption"):
        sample_resumable(crash, _x0(), str(tmp_path / "b"), **kw)
    assert os.path.exists(tmp_path / "b.npz")
    resumed = fresh(False)
    out_c = sample_resumable(resumed, _x0(), str(tmp_path / "b"), **kw)
    n_draws = 10 * (3 if strategy == "jump_mala" else 1)
    assert out_c.samples.shape == (n_draws, C, D) and torch.equal(out_a.samples, out_c.samples)
    assert torch.equal(out_a.running_samples.last_sample, out_c.running_samples.last_sample)
    sa, sc = out_a.statistics, out_c.statistics
    assert type(sa) is type(sc)
    for name, value in vars(sa).items():
        if isinstance(value, int) or name == "n_accepted_jumps":
            assert getattr(sc, name) == value, name
    assert np.array_equal(sa.running_first_moment, sc.running_first_moment)
    assert np.array_equal(sa.running_second_moment, sc.running_second_moment)
    assert all(_equal(a, b) for a, b in zip(_kernel_leaves(ref), _kernel_leaves(resumed)))
    for a, b in ((ref, resumed), *(((ref.inner_sampler, resumed.inner_sampler),)
                                   if strategy == "jump_mala" else ())):
        if hasattr(a, "extra_resumable_state"):
            ea, eb = a.extra_resumable_state(), b.extra_resumable_state()
            assert ea.keys() == eb.keys() and all(_equal(ea[k], eb[k]) for k in ea)


def test_merged_counters_equal_the_jax_packages(tmp_path):
    """The same run shape (MALA, 6 chains, 10 iterations in segments of 3,
    the last of 1) in both packages: every counter of the merged statistics
    and the draws the moments saw are equal."""
    import jax.numpy as jnp

    from nfmc_tpu.checkpoint import sample_resumable as jax_resumable
    from nfmc_tpu.samplers.mcmc import MALA as JMALA

    jsampler = JMALA((D,), lambda x: 0.5 * jnp.sum(x ** 2, -1))
    jsampler.params.n_iterations = 10
    jout = jax_resumable(jsampler, np.asarray(_x0()), str(tmp_path / "j"),
                         segment_iterations=3, seed=0)
    out = sample_resumable(_sampler("mala"), _x0(), str(tmp_path / "t"), segment_iterations=3,
                           seed=0)
    for name in ("n_attempted_trajectories", "n_target_calls", "n_target_gradient_calls",
                 "n_divergences"):
        assert getattr(out.statistics, name) == getattr(jout.statistics, name), name
    assert (out.statistics.expectations["first_moment"].n_seen
            == jout.statistics.expectations["first_moment"].n_seen == 10 * C)
    assert out.samples.shape[0] == np.shape(jout.samples)[0] == 1  # the last segment's


def test_front_door_resumes_skips_warmup_and_discards(tmp_path, monkeypatch):
    """``sample(checkpoint_path=...)``: a crash mid-sampling leaves the file;
    the same call again resumes without the warmup and equals the
    uninterrupted call; the file is gone after success."""
    from nfmc_torch.samplers.mcmc.langevin import MALA

    path = str(tmp_path / "fd")
    cfg = dict(target=StandardGaussian((D,)), flow=None, strategy="mala", n_chains=C,
               n_iterations=10, n_warmup_iterations=6, warmup=True, show_progress=False, seed=9,
               device="cpu", checkpoint_path=path, checkpoint_segment_iterations=2)
    out_a = nfmc_torch.sample(**cfg)
    assert not os.path.exists(path + ".npz") and out_a.samples.shape == (10, C, D)
    orig_sample, orig_warmup = MALA.sample, MALA.warmup
    calls = {"n": 0}

    def crashing(self, *a, **k):
        calls["n"] += 1
        if calls["n"] == 3:
            raise RuntimeError("boom")
        return orig_sample(self, *a, **k)

    monkeypatch.setattr(MALA, "sample", crashing)
    with pytest.raises(RuntimeError, match="boom"):
        nfmc_torch.sample(**cfg)
    assert os.path.exists(path + ".npz") and os.path.exists(path + ".npz.seg1.npy")
    monkeypatch.setattr(MALA, "sample", orig_sample)

    def no_warmup(self, *a, **k):
        raise AssertionError("a resume must skip the warmup")

    monkeypatch.setattr(MALA, "warmup", no_warmup)
    out_c = nfmc_torch.sample(**cfg)
    assert not os.path.exists(path + ".npz") and not list(tmp_path.glob("fd.npz*"))
    assert torch.equal(out_a.samples, out_c.samples)
    assert out_a.statistics.n_accepted_trajectories == out_c.statistics.n_accepted_trajectories
    monkeypatch.setattr(MALA, "warmup", orig_warmup)
    with pytest.raises(ValueError, match="sampling_time_limit_seconds"):
        nfmc_torch.sample(**cfg, sampling_time_limit_seconds=1.0)


def test_front_door_resume_keeps_the_ess_ellipse(tmp_path, monkeypatch):
    """ESS's warmup-adapted ellipse lives outside the kernel state: the
    extra-state hook carries it, so the resumed front-door run is bit-exact
    although its warmup is skipped."""
    from nfmc_torch.samplers.mcmc.ess import ESS

    path = str(tmp_path / "ess")
    cfg = dict(target=StandardGaussian((D,)), negative_log_likelihood=StandardGaussian((D,)),
               flow=None, strategy="ess", n_chains=C, n_iterations=8, n_warmup_iterations=6,
               warmup=True, show_progress=False, seed=3, device="cpu", checkpoint_path=path,
               checkpoint_segment_iterations=2)
    out_a = nfmc_torch.sample(**cfg)
    orig = ESS.sample_continue
    calls = {"n": 0}

    def crashing(self, *a, **k):
        calls["n"] += 1
        if calls["n"] == 2:
            raise RuntimeError("boom")
        return orig(self, *a, **k)

    monkeypatch.setattr(ESS, "sample_continue", crashing)
    with pytest.raises(RuntimeError, match="boom"):
        nfmc_torch.sample(**cfg)
    monkeypatch.setattr(ESS, "sample_continue", orig)
    out_c = nfmc_torch.sample(**cfg)
    assert torch.equal(out_a.samples, out_c.samples)


def test_resume_refuses_another_configuration(tmp_path):
    path = str(tmp_path / "cfg")
    crash = _sampler("mala")
    _crash_after(crash, 1)
    with pytest.raises(RuntimeError):
        sample_resumable(crash, _x0(), path, segment_iterations=2, seed=1)
    with pytest.raises(ValueError, match="segment_iterations"):
        sample_resumable(_sampler("mala"), _x0(), path, segment_iterations=5, seed=1)
    with pytest.raises(ValueError, match="shape"):
        sample_resumable(_sampler("mala"), _x0(4), path, segment_iterations=2, seed=1)
    flipped = _sampler("mala")
    flipped.params.store_samples = False
    with pytest.raises(ValueError, match="store_samples"):
        sample_resumable(flipped, _x0(), path, segment_iterations=2, seed=1)
    other = _sampler("jump_mala")
    with pytest.raises(ValueError, match="state structure"):
        sample_resumable(other, _x0(), path, segment_iterations=2, seed=1)


def test_save_samples_is_recorded_and_a_contradiction_raises(tmp_path):
    """The sidecars and the ``save_samples`` rules: a fresh run writes one
    ``.seg<i>.npy`` a segment; a resume adopts the checkpoint's setting
    (None) and refuses the other; a fresh ``save_samples=True`` with
    ``store_samples=False`` raises."""
    path = str(tmp_path / "ss")
    crash = _sampler("mala")
    _crash_after(crash, 2)
    with pytest.raises(RuntimeError):
        sample_resumable(crash, _x0(), path, segment_iterations=2, seed=1, save_samples=True)
    assert sorted(p.name for p in tmp_path.glob("ss.npz.seg*.npy")) == [
        "ss.npz.seg0.npy", "ss.npz.seg1.npy"]
    with pytest.raises(ValueError, match="save_samples"):
        sample_resumable(_sampler("mala"), _x0(), path, segment_iterations=2, seed=1,
                         save_samples=False)
    out = sample_resumable(_sampler("mala"), _x0(), path, segment_iterations=2, seed=1)
    assert out.samples.shape == (10, C, D)
    no_store = _sampler("mala")
    no_store.params.store_samples = False
    with pytest.raises(ValueError, match="store_samples=False"):
        sample_resumable(no_store, _x0(), str(tmp_path / "fresh"), segment_iterations=2,
                         save_samples=True)


def test_a_completed_checkpoint_rebuilds_the_output(tmp_path):
    """A re-call that finds the checkpoint complete (the caller died before
    discarding it) rebuilds the finished output: with sidecars every draw,
    without them the last segment's; the statistics of the whole run."""
    for save in (True, False):
        path = str(tmp_path / f"done{save}")
        out = sample_resumable(_sampler("mala"), _x0(), path, segment_iterations=3, seed=2,
                               save_samples=save)
        again = sample_resumable(_sampler("mala"), _x0(), path, segment_iterations=3, seed=2)
        assert torch.equal(again.samples, out.samples)
        assert again.statistics.n_accepted_trajectories == out.statistics.n_accepted_trajectories
        assert np.array_equal(again.statistics.running_first_moment,
                              out.statistics.running_first_moment)


def test_discard_removes_the_file_its_sidecars_and_a_crash_window_tmp(tmp_path):
    path = str(tmp_path / "d")
    sample_resumable(_sampler("mala"), _x0(), path, segment_iterations=5, seed=0,
                     save_samples=True)
    (tmp_path / "d.npz.tmp.npz").write_bytes(b"partial")
    (tmp_path / "d.npz.seg7.npy").write_bytes(b"orphan")
    discard_resumable_checkpoint(path)
    assert not list(tmp_path.iterdir())


def test_missing_sidecar_degrades_to_a_warning(tmp_path):
    path = str(tmp_path / "m")
    sample_resumable(_sampler("mala"), _x0(), path, segment_iterations=5, seed=0,
                     save_samples=True)
    os.remove(tmp_path / "m.npz.seg0.npy")
    with pytest.warns(UserWarning, match="sidecar"):
        out = sample_resumable(_sampler("mala"), _x0(), path, segment_iterations=5, seed=0)
    assert out.samples.shape == (5, C, D) and out.statistics.n_attempted_trajectories == 10 * C


def test_segment_seeds_are_a_fixed_function_of_the_base(tmp_path):
    """Segment i's seed depends on the base and i alone, and a run without
    a seed draws its base from the generator it is given."""
    assert segment_seed(5, 0) == segment_seed(5, 0) != segment_seed(5, 1) != segment_seed(6, 1)
    assert 0 <= segment_seed(2**62, 3) < 2**62
    outs = [sample_resumable(_sampler("mala"), _x0(), str(tmp_path / f"g{i}"),
                             segment_iterations=5, generator=torch.Generator().manual_seed(4))
            for i in range(2)]
    assert torch.equal(outs[0].samples, outs[1].samples)
