"""``nfmc_torch.profiling`` on the CPU (counterpart of
``tests/test_profiling.py``): ``trace`` writes a Chrome/Perfetto JSON trace
holding ``annotate``'s span without disturbing the run, and the two JAX
options this package cannot serve raise."""
import json

import numpy as np
import pytest
import torch

import nfmc_torch
from nfmc_torch.potentials import StandardGaussian
from nfmc_torch.samplers.mcmc import MALA


def _run(seed=1):
    s = MALA((4,), StandardGaussian((4,)), device="cpu")
    s.params.n_iterations = 5
    x0 = torch.randn((8, 4), generator=torch.Generator().manual_seed(0))
    return s.sample(x0, show_progress=False, seed=seed)


def test_trace_writes_the_span(tmp_path):
    """One ``*.pt.trace.json`` in the (created) directory, holding the span
    and the run's operations; the draws equal an untraced run's."""
    with nfmc_torch.profiling.trace(tmp_path / "run" / "nested") as p:
        with nfmc_torch.profiling.annotate("mala-smoke"):
            out = _run()
    assert p == tmp_path / "run" / "nested"
    files = list(p.glob("*.pt.trace.json"))
    assert len(files) == 1
    events = json.loads(files[0].read_text())["traceEvents"]
    spans = [e for e in events if e.get("name") == "mala-smoke"]
    assert spans and spans[0]["cat"] == "user_annotation" and spans[0]["dur"] > 0
    assert any(e.get("cat") == "cpu_op" for e in events)
    assert torch.equal(out.samples, _run().samples)
    assert np.isfinite(out.samples.numpy()).all()


def test_perfetto_trace_option_and_unserved_options(tmp_path):
    """``create_perfetto_trace=True`` writes the same file (it is already
    what Perfetto opens); a Perfetto link and the live profiling server
    raise ``NotImplementedError`` and say why, and create nothing."""
    with nfmc_torch.profiling.trace(tmp_path / "pf", create_perfetto_trace=True) as p:
        _run()
    assert len(list(p.glob("*.pt.trace.json"))) == 1
    with pytest.raises(NotImplementedError, match="perfetto"):
        with nfmc_torch.profiling.trace(tmp_path / "link", create_perfetto_link=True):
            pass
    assert not (tmp_path / "link").exists()
    with pytest.raises(NotImplementedError, match="profiling server"):
        nfmc_torch.profiling.start_server(9999)


def test_annotate_is_a_span_only_inside_with():
    """``annotate`` opens its span on entry and closes it on exit (JAX's
    ``TraceAnnotation``): making the object records nothing."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        span = nfmc_torch.profiling.annotate("made-not-entered")
        with nfmc_torch.profiling.annotate("entered"):
            torch.ones(3).sum()
    names = {e.name for e in prof.events()}
    assert "entered" in names and "made-not-entered" not in names
    del span
