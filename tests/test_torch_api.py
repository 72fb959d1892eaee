"""The port's front door and its hygiene: it runs on the CPU when asked,
raises without a card otherwise, names the ROADMAP item of what it does
not run yet, and imports nothing of JAX or of nfmc_tpu. The sweep over
the strategies of ROADMAP 1.5 (ess, nuts, chees_hmc, dense_hmc,
dense_mala, pt_mala, pt_mh, pt_hmc, aies, and the jump and NeuTra
variants) runs each at a tiny size."""
import ast
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import nfmc_torch
from nfmc_torch.potentials import StandardGaussian

REPO = Path(__file__).resolve().parents[1]


def _run(**kw):
    args = dict(strategy="jump_mala", flow="realnvp", n_chains=6, n_iterations=4,
                inner_param_kwargs={"n_iterations": 2}, device="cpu", seed=0, show_progress=False)
    args.update(kw)
    return nfmc_torch.sample(StandardGaussian((3,)), **args)


def test_front_door_runs_on_cpu_and_is_seeded():
    out = _run()
    assert out.samples.shape == (4 * 3, 6, 3) and out.samples.device.type == "cpu"
    assert torch.isfinite(out.samples).all()
    assert torch.equal(out.samples, _run().samples)
    assert not torch.equal(out.samples, _run(seed=1).samples)
    assert np.isfinite(out.statistics.jump_acceptance_rate)


def test_flow_dsl_and_ula():
    out = _run(strategy="jump_ula", flow='realnvp%{"n_layers": 3, "hidden_size": 8}')
    flow = out.kernel.flow
    assert len(flow.params) == 3 and flow.params[0]["w"][1].shape == (8, 8)
    assert out.statistics.n_target_gradient_calls == 4 * 2 * 6  # ULA: one per chain


@pytest.mark.parametrize("name,cls", [("c-rqnsf", "CouplingRQNSF"), ("c-lrsnsf", "CouplingLRS"),
                                      ("c-rqsnsf", "CouplingRQNSF"), ("c-lrnsf", "CouplingLRS")])
def test_spline_flows_through_the_front_door(name, cls):
    """The coupling spline flows by name and alias, with DSL kwargs (the
    aliases with the JAX package's ``use_pallas``, accepted and ignored), at
    d=6: the shape law and the flow built."""
    extra = ', "use_pallas": true' if name in ("c-rqsnsf", "c-lrnsf") else ""
    flow = f'{name}%{{"n_layers": 3, "hidden_size": 8, "n_bins": 4{extra}}}'
    out = nfmc_torch.sample(StandardGaussian((6,)), strategy="jump_mala", flow=flow, n_chains=6,
                            n_iterations=4, inner_param_kwargs={"n_iterations": 2}, device="cpu",
                            seed=0, show_progress=False)
    bij = out.kernel.flow.bijection
    assert type(bij).__name__ == cls and bij.n_bins == 4 and bij.tail_bound == 5.0
    n_par = (3 if cls == "CouplingRQNSF" else 4) * 4 - 1
    assert out.kernel.flow.params[0]["w"][2].shape == (8, 3 * n_par)
    assert out.samples.shape == (4 * 3, 6, 6) and torch.isfinite(out.samples).all()
    assert out.statistics.jump_acceptance_rate > 0.9  # an identity-init flow on N(0, I)


def test_package_data_ships_every_kernel_header():
    """An installed nfmc_torch builds its kernels from the packaged sources:
    every file a .cu source includes must match a package-data glob."""
    import fnmatch
    import re
    import tomllib

    globs = tomllib.loads((REPO / "pyproject.toml").read_text())["tool"]["setuptools"][
        "package-data"]["nfmc_torch"]
    csrc = REPO / "nfmc_torch" / "csrc"
    sources = sorted(csrc.glob("*.cu"))
    assert len(sources) >= 4
    for src in sources + sorted(csrc.glob("*.cuh")):
        rel = src.relative_to(REPO / "nfmc_torch").as_posix()
        assert any(fnmatch.fnmatch(rel, g) for g in globs), rel
        for inc in re.findall(r'^#include "([^"]+)"', src.read_text(), re.M):
            assert (csrc / inc).exists(), (src.name, inc)
            assert any(fnmatch.fnmatch(f"csrc/{inc}", g) for g in globs), (src.name, inc)


def test_without_a_card_the_default_device_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        nfmc_torch.sample(StandardGaussian((3,)), strategy="jump_mala", show_progress=False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        _run(device="cuda")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        nfmc_torch.sample(StandardGaussian((3,)), strategy="jump_mala", flow="c-lrsnsf",
                          show_progress=False)


@pytest.mark.parametrize("strategy,item", [
    *((s, "1.5") for s in ("ess", "nuts", "pt_mala", "pt_mh", "pt_hmc", "aies", "chees_hmc",
                           "dense_hmc", "dense_mala", "jump_ess", "jump_nuts", "jump_aies",
                           "jump_chees", "neutra_chees"))])
def test_unported_strategies_name_their_roadmap_item(strategy, item):
    """The strategies of ROADMAP 1.5 are all ported now: each runs on the
    CPU through the front door and none is listed as unported."""
    assert strategy in nfmc_torch.api.registry.PORTED_STRATEGIES
    assert strategy not in nfmc_torch.api.registry.UNPORTED_STRATEGIES
    kw = {"negative_log_likelihood": StandardGaussian((3,))} if "ess" in strategy else {}
    out = _run(strategy=strategy, **kw)
    assert out.samples.device.type == "cpu" and torch.isfinite(out.samples).all()


def test_the_unported_strategies_are_exactly_the_rest_of_roadmap_1_5():
    """No strategy of the JAX package's registry is left to port: the port's
    list is the JAX package's MCMC and NFMC lists."""
    registry = nfmc_torch.api.registry
    assert registry.UNPORTED_STRATEGIES == {}
    assert registry.PORTED_STRATEGIES == (
        "hmc", "uhmc", "ula", "mala", "mh", "ess", "nuts", "pt_mala", "pt_mh", "pt_hmc", "aies",
        "chees_hmc", "dense_hmc", "dense_mala", "imh", "fixed_imh", "adaptive_imh", "jump_mala",
        "jump_ula", "jump_hmc", "jump_uhmc", "jump_ess", "jump_mh", "jump_nuts", "jump_aies",
        "jump_chees", "neutra_mh", "neutra_hmc", "neutra_chees", "tess", "dlmc")


@pytest.mark.parametrize("strategy", ["ess", "nuts", "chees_hmc", "jump_ess", "jump_nuts",
                                      "jump_chees", "neutra_chees", "dense_hmc", "dense_mala",
                                      "pt_mala", "pt_mh", "pt_hmc", "aies", "jump_aies"])
def test_the_new_strategies_default_to_the_card(monkeypatch, strategy):
    """Without a card the default device raises for each new strategy, and
    an explicit ``device="cuda"`` does too: nothing falls back to the
    CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    kw = {"negative_log_likelihood": StandardGaussian((3,))} if "ess" in strategy else {}
    with pytest.raises(RuntimeError, match="device='cpu'"):
        nfmc_torch.sample(StandardGaussian((3,)), strategy=strategy, show_progress=False, **kw)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        nfmc_torch.create_sampler(StandardGaussian((3,)), strategy=strategy, device="cuda", **kw)


@pytest.mark.parametrize("strategy", list(nfmc_torch.api.registry.PORTED_STRATEGIES))
def test_every_ported_strategy_runs_on_the_cpu(strategy):
    """Each ported strategy through the front door with ``device="cpu"``:
    finite draws on the CPU and a counted run."""
    kw = ({"negative_log_likelihood": StandardGaussian((3,))}
          if strategy in ("tess", "dlmc", "ess", "jump_ess") else {})
    if strategy == "dlmc":
        kw["param_kwargs"] = {"flow_fit_kwargs": {"n_epochs": 1}}
    out = nfmc_torch.sample(StandardGaussian((3,)), strategy=strategy,
                            flow='realnvp%{"n_layers": 2, "hidden_size": 8}', n_chains=6,
                            n_iterations=3, device="cpu", seed=0, show_progress=False,
                            inner_param_kwargs={"n_iterations": 2}, **kw)
    assert out.samples.device.type == "cpu" and torch.isfinite(out.samples).all()
    assert out.samples.shape[1:] == (6, 3) and out.statistics.n_attempted_trajectories > 0


def test_unported_options_raise():
    # a mesh must be a torch.distributed DeviceMesh (nfmc_torch.parallel)
    with pytest.raises(TypeError, match="DeviceMesh"):
        nfmc_torch.Flow(nfmc_torch.RealNVP((3,)), seed=0).fit(np.zeros((4, 3), np.float32),
                                                              mesh=object())
    with pytest.raises(ValueError, match="Unsupported sampling strategy"):
        _run(strategy="no_such_sampler")


@pytest.mark.parametrize("strategy,calls", [("mala", 2), ("ula", 1)])
def test_front_door_standalone_langevin(strategy, calls):
    """Standalone MALA/ULA through the front door, with and without warmup:
    the draws' shape, the counters and the seeded stream."""
    def run(**kw):
        return nfmc_torch.sample(StandardGaussian((3,)), strategy=strategy, n_chains=6,
                                 n_iterations=5, n_warmup_iterations=4, device="cpu", seed=0,
                                 show_progress=False, **kw)

    out = run()
    assert out.samples.shape == (5, 6, 3) and torch.isfinite(out.samples).all()
    assert out.statistics.n_target_gradient_calls == 5 * calls * 6
    assert torch.equal(out.samples, run().samples)
    warm = run(warmup=True)
    assert warm.samples.shape == (5, 6, 3)
    assert not np.allclose(warm.kernel.inv_mass_diag, 1.0)  # tuned by the warmup


def test_import_pulls_in_no_jax():
    check = ("import sys, nfmc_torch, nfmc_torch.api, nfmc_torch.ops.coupling, "
             "nfmc_torch.ops.spline, nfmc_torch.transport, nfmc_torch.flow_training; "
             "bad = [m for m in sys.modules "
             "if m.split('.')[0] in ('jax', 'jaxlib', 'optax', 'nfmc_tpu')]; "
             "assert not bad, bad; print('CLEAN')")
    r = subprocess.run([sys.executable, "-c", check], capture_output=True, text=True,
                       cwd=str(REPO), timeout=120)
    assert r.returncode == 0, r.stderr
    assert "CLEAN" in r.stdout


def test_no_source_imports_jax_or_the_jax_package():
    files = sorted((REPO / "nfmc_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 20
    for path in files:
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""] if node.level == 0 else []
            else:
                continue
            for name in names:
                assert name.split(".")[0] not in ("jax", "jaxlib", "optax", "nfmc_tpu"), (
                    path, name)


def test_nothing_in_the_port_enables_tf32():
    """ESS's whitening products (``precision="highest"`` in the JAX package)
    and every other float32 product run in full float32: no module of the
    port turns TF32 on or lowers the matmul precision."""
    files = sorted((REPO / "nfmc_torch").rglob("*.py"))
    for path in files:
        text = path.read_text()
        for word in ("allow_tf32", "set_float32_matmul_precision"):
            assert word not in text, (path, word)
