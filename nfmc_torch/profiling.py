"""Profiler integration (counterpart of ``nfmc_tpu/profiling.py``).

Counters (``MCMCStatistics``) remain the always-on observability layer; for
op-level timelines wrap any region in :func:`trace` and open the Chrome /
Perfetto JSON it writes (``*.pt.trace.json``) at ui.perfetto.dev, in
``chrome://tracing`` or in TensorBoard's PyTorch profiler plugin:

    import nfmc_torch
    with nfmc_torch.profiling.trace("/tmp/nfmc-trace") as log_dir:
        out = sampler.sample(x0, show_progress=False)

Label host-side phases (warmup / flow refits / jumps) with :func:`annotate`
so they show up as named spans inside the trace, and as NVTX ranges for
``nsys`` on a CUDA machine:

    with nfmc_torch.profiling.annotate("flow-refit"):
        flow.fit(x_train, ...)
"""
from __future__ import annotations

import contextlib
import os
import socket
import time
from contextlib import contextmanager
from pathlib import Path


@contextmanager
def trace(log_dir, create_perfetto_link: bool = False, create_perfetto_trace: bool = False):
    """Capture a ``torch.profiler`` trace of the enclosed region to
    ``log_dir``; yields the directory's ``Path``.

    Records CPU activity, and CUDA activity too when a card is present, and
    writes one Chrome/Perfetto JSON trace ``<host>.<pid>.<ns>.pt.trace.json``
    there on exit. That file is already what Perfetto opens, so
    ``create_perfetto_trace`` adds nothing; ``create_perfetto_link=True``
    (the JAX profiler serves the trace to a browser link) raises
    ``NotImplementedError``: this package serves nothing."""
    if create_perfetto_link:
        raise NotImplementedError(
            "create_perfetto_link: torch.profiler has no trace server; open the written "
            "*.pt.trace.json at ui.perfetto.dev instead")
    import torch
    from torch.profiler import ProfilerActivity, profile

    path = Path(log_dir)
    path.mkdir(parents=True, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    with prof:
        yield path
    name = f"{socket.gethostname()}.{os.getpid()}.{time.time_ns()}.pt.trace.json"
    prof.export_chrome_trace(str(path / name))


@contextmanager
def annotate(name: str):
    """Named span visible in profiler traces (``record_function``), and an
    NVTX range of the same name when CUDA is available."""
    import torch

    with contextlib.ExitStack() as stack:
        stack.enter_context(torch.profiler.record_function(name))
        if torch.cuda.is_available():
            stack.enter_context(torch.cuda.nvtx.range(name))
        yield


def start_server(port: int = 9999):
    """The JAX package's on-demand profiling server (TensorBoard connects to
    it live). PyTorch has no counterpart, so this raises
    ``NotImplementedError``; capture with :func:`trace` instead."""
    raise NotImplementedError(
        f"start_server(port={port}): torch.profiler has no on-demand profiling server "
        "(ROADMAP 1.8c); wrap the region in nfmc_torch.profiling.trace(log_dir)")
