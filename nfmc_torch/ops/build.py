"""Build and load the hand-written CUDA kernels, and count their launches.

Each source of ``SOURCES`` (the flows' kernels) and ``HELPERS`` (the CUDA
graph conditional nodes) is compiled with ``nvcc`` for ``sm_90a`` at first
use into its own shared library under ``nfmc_torch/_build/`` (git-ignored),
keyed by the hash of the source, the shared headers and the flags. All
``nvcc`` processes run at once. The libraries have a plain C interface and
are loaded with ``ctypes``.

Every kernel wrapper of :mod:`nfmc_torch.ops` registers itself in
``WRAPPERS`` and adds one to its ``.launches`` where it launches its kernel,
through ``count_launch``, which also tells the ``LISTENERS`` the launch's
shape; ``reset_launch_counts()`` sets the counts to 0. While a CUDA graph
captures (``recording``) a launch is recorded instead of counted, and each
replay of the graph counts what was recorded (``count_replays``), and a
conditional scope's launches (``scope``) once for each run of its body,
which a device tally of the scope counts. ``tally`` counts other work the
same way (a flow fit's Adam steps and epochs).
"""
from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Callable, List, Optional

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
SOURCES = {name: CSRC / f"{name}.cu"
           for name in ("coupling", "coupling_bwd", "spline", "spline_bwd")}
# the CUDA graph conditional nodes of core/graphs.py (no kernel of a flow)
HELPERS = {"graph_cond": CSRC / "graph_cond.cu"}
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# (library, symbol) -> (argument types, return type)
SIGNATURES = {
    ("coupling", "nfmc_coupling_stack"): ([_P] * 4 + [_I] * 4 + [_F, _I, _P], _I),
    ("coupling_bwd", "nfmc_coupling_stack_vjp"): ([_P] * 7 + [_I] * 4 + [_F, _I, _P], _I),
    ("coupling_bwd", "nfmc_coupling_vjp_scratch_floats"): ([_I] * 4, ctypes.c_longlong),
    # d, H: shared bytes of a row tile of 8 rows
    ("coupling", "nfmc_coupling_tile_bytes"): ([_I] * 2, ctypes.c_longlong),
    ("coupling_bwd", "nfmc_coupling_vjp_tile_bytes"): ([_I] * 2, ctypes.c_longlong),
    # x, weights, y, ld, B, d, H, L, n_bins, tail_bound, inverse, lrs, stream
    ("spline", "nfmc_spline_stack"): ([_P] * 4 + [_I] * 5 + [_F, _I, _I, _P], _I),
    # x, gy, gld, weights, gx, grads, scratch, B, d, H, L, n_bins, tail_bound,
    # inverse, lrs, stream
    ("spline_bwd", "nfmc_spline_stack_vjp"): ([_P] * 7 + [_I] * 5 + [_F, _I, _I, _P], _I),
    ("spline_bwd", "nfmc_spline_vjp_scratch_floats"): ([_I] * 5, ctypes.c_longlong),
    ("spline", "nfmc_spline_tile_bytes"): ([_I] * 2, ctypes.c_longlong),
    ("spline_bwd", "nfmc_spline_vjp_tile_bytes"): ([_I] * 2, ctypes.c_longlong),
    # parent stream, predicate, child stream, loop, handle out / child
    # stream, handle, next predicate
    ("graph_cond", "nfmc_cond_begin"): ([_P] * 3 + [_I, ctypes.POINTER(ctypes.c_ulonglong)], _I),
    ("graph_cond", "nfmc_cond_end"): ([_P, ctypes.c_ulonglong, _P], _I),
    ("graph_cond", "nfmc_cond_warm"): ([], _I),
    ("graph_cond", "nfmc_cond_status"): ([_P], _I),
    ("graph_cond", "nfmc_cond_stream"): ([], _P),
}

_libs = None
build_log = ""
build_seconds: Optional[float] = None

WRAPPERS: List = []
# callables (wrapper, key, n): a launch's shape key is (kernel, direction, d,
# H, L, rows), the kernel "stack" or "vjp" (RealNVP), "rqs" or "lrs" (the
# spline stack) or "rqs vjp" / "lrs vjp"
LISTENERS: List[Callable] = []
# the counts of the iteration a graph is capturing, as (count function,
# first argument, second argument) or a Scope, None outside a capture
_recording: Optional[List] = None


class Scope:
    """A conditional scope of a capture (``core.graphs.when`` or ``loop``):
    the counts recorded inside it (``events``, as ``recording`` gives them)
    happen once for each run of its body in the replays. ``tally``, a 0-d
    int64 tensor on the device that the body advances, counts those runs;
    it is None where the scope recorded no count of its own (its nested
    scopes keep their own tallies)."""

    def __init__(self):
        self.events: List = []
        self.tally = None

    def counts_own(self) -> bool:
        return any(not isinstance(e, Scope) for e in self.events)


def _scopes(events):
    """Every scope of ``events``, nested ones included, in order."""
    for e in events:
        if isinstance(e, Scope):
            yield e
            yield from _scopes(e.events)


def register(*wrappers) -> None:
    """Give each wrapper a launch count of 0 and list it in ``WRAPPERS``."""
    for w in wrappers:
        w.launches = 0
        WRAPPERS.append(w)


def reset_launch_counts() -> None:
    for w in WRAPPERS:
        w.launches = 0


def count_launch(wrapper, key: tuple, n: int = 1) -> None:
    """Count ``n`` launches of ``wrapper``'s kernel at shape ``key`` (see
    ``LISTENERS``); inside a capture, record one for the graph's replays."""
    if _recording is not None:
        _recording.append((count_launch, wrapper, key))
        return
    wrapper.launches += n
    for listener in LISTENERS:
        listener(wrapper, key, n)


def tally(counts: dict, name: str, n: int = 1) -> None:
    """Add ``n`` to ``counts[name]``, a count of work that launches no
    kernel of its own (a flow fit's Adam steps); inside a capture, record
    one for the graph's replays, as ``count_launch`` does."""
    if _recording is not None:
        _recording.append((tally, counts, name))
        return
    counts[name] += n


@contextlib.contextmanager
def recording():
    """For the ``with`` block, launches are recorded in the list it gives,
    not counted: a capture enqueues them for its replays and runs nothing."""
    global _recording
    if _recording is not None:
        raise RuntimeError("a capture is already recording launches")
    _recording = events = []
    try:
        yield events
    finally:
        _recording = None


@contextlib.contextmanager
def scope():
    """For the ``with`` block, inside a ``recording``, counts are recorded
    in a new :class:`Scope` (given, else None) nested where the block
    opens."""
    global _recording
    if _recording is None:
        yield None
        return
    outer, sc = _recording, Scope()
    outer.append(sc)
    _recording = sc.events
    try:
        yield sc
    finally:
        _recording = outer


def arm(events) -> None:
    """Set the tallies of ``events``' scopes to 0: once after the capture
    that recorded them (a capture runs nothing, and each replay adds to
    them)."""
    for sc in _scopes(events):
        if sc.tally is not None:
            sc.tally.zero_()


def count_replays(events, n: int) -> None:
    """Count the launches and tallies ``events`` (a capture's
    ``recording``) once for each of ``n`` replays, and those of each scope
    once for each run the replays made of its body: its tally, read on the
    host (one read for all of them, only where a scope counts something)
    and set to 0 again."""
    if n <= 0:
        return
    for e in events:
        if not isinstance(e, Scope):
            count, a, b = e
            count(a, b, n)
    counted = [sc for sc in _scopes(events) if sc.tally is not None]
    if not counted:
        return
    import torch

    tallies = [sc.tally for sc in counted]
    taken = torch.stack(tallies).tolist()
    torch._foreach_zero_(tallies)
    for sc, k in zip(counted, taken):
        if k > 0:
            for e in sc.events:
                if not isinstance(e, Scope):
                    count, a, b = e
                    count(a, b, k)


def find_nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
                 "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the kernels are built with the CUDA toolkit")


def build_sources(sources: dict, build_dir: Path = BUILD_DIR) -> dict:
    """Compile each ``{name: path of a .cu}`` of ``sources`` into a shared
    library in ``build_dir`` (once per hash of the source, the ``.cuh``
    headers beside it and the flags), all ``nvcc`` processes at once, and
    return ``{name: path}``. Records the compilers' output in ``build_log``
    and the time taken in ``build_seconds``."""
    global build_log, build_seconds
    flags = " ".join(NVCC_FLAGS).encode()
    outs, jobs = {}, {}
    t0 = time.perf_counter()
    for name, src in sources.items():
        src = Path(src)
        headers = b"".join(h.read_bytes() for h in sorted(src.parent.glob("*.cuh")))
        tag = hashlib.sha256(src.read_bytes() + headers + flags).hexdigest()[:16]
        outs[name] = build_dir / f"{name}-{tag}.so"
        if outs[name].exists():
            continue
        build_dir.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=build_dir)
        os.close(fd)
        proc = subprocess.Popen([find_nvcc(), *NVCC_FLAGS, "-o", tmp, str(src)],
                                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        jobs[name] = (proc, tmp)
    logs, failed = [], []
    try:
        for name, (proc, tmp) in jobs.items():
            log = proc.communicate()[0]
            logs.append(f"== {Path(sources[name]).name}\n{log}")
            if proc.returncode != 0:
                failed.append(Path(sources[name]).name)
            else:
                os.replace(tmp, outs[name])  # atomic: a concurrent build sees a whole file or none
    finally:
        for proc, tmp in jobs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            if os.path.exists(tmp):
                os.unlink(tmp)
    build_log = "\n".join(logs)
    if failed:
        raise RuntimeError(f"nvcc failed building {', '.join(failed)}:\n{build_log}")
    build_seconds = time.perf_counter() - t0 if jobs else 0.0
    return outs


def load(sources: dict, build_dir: Path = BUILD_DIR) -> dict:
    """``build_sources``, then each library loaded with ``ctypes`` and the
    ``SIGNATURES`` of the symbols it has set: ``{name: CDLL}``."""
    libs = {n: ctypes.CDLL(str(path)) for n, path in build_sources(sources, build_dir).items()}
    for (lib, sym), (argtypes, restype) in SIGNATURES.items():
        if lib in libs and hasattr(libs[lib], sym):
            fn = getattr(libs[lib], sym)
            fn.argtypes, fn.restype = argtypes, restype
    return libs


def library(name: str):
    """The loaded library ``name`` (a key of ``SOURCES`` or ``HELPERS``);
    the first call builds and loads them all."""
    global _libs
    if _libs is None:
        _libs = load({**SOURCES, **HELPERS})
    return _libs[name]
