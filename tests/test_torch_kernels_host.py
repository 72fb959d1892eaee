"""The CUDA kernels of nfmc_torch/csrc/ compiled as C++ for the CPU and run
there against their plain PyTorch versions.

``tests/host_cuda/cuda_runtime.h`` emulates the few CUDA features the
kernels use (threads, warp barriers, shuffles, shared memory), so the
kernels' indexing, layouts, row blocking and the spline's hand-written VJP
are checked on every CPU run, without a card. The card's own compiler,
timing and memory model are not: ``tests/test_torch_kernels.py`` and
``chip_smoke.py`` cover those on an H100. The kernels run through their
C entry points, with the same arguments the wrappers pass.

Tolerances as on the card: the forward to 1e-4 * max(1, max|ref|); the
backward to 1e-4 (RealNVP) and 2e-4 (splines, whose steep maps amplify
rounding) times max(1, max|ref|)."""
import ctypes
import re
import shutil
import subprocess

import pytest
import torch

from nfmc_torch.flows.spline import n_params_per_dim
from nfmc_torch.ops import build
from nfmc_torch.ops import coupling as cops
from nfmc_torch.ops import spline as sops

SHIM = build.CSRC.parents[1] / "tests" / "host_cuda"
TOL, SPLINE_BWD_TOL = 1e-4, 2e-4


def _host_source(src) -> str:
    text = src.read_text()
    text = text.replace("extern __shared__ float smem[];", "float* smem = (float*)emu_smem;")
    text = re.sub(r"([\w:]+(?:<[^<>;]*>)?)<<<([^;]*?)>>>\(", r"emu_launch(EmuCfg{\2}, \1, ", text)
    return text.replace('#include "', f'#include "{build.CSRC}/')


@pytest.fixture(scope="module")
def host_libs(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to compile the kernels for the CPU")
    out = tmp_path_factory.mktemp("host_kernels")
    procs = {}
    for name, src in build.SOURCES.items():
        cpp = out / f"{name}.cpp"
        cpp.write_text(_host_source(src))
        procs[name] = subprocess.Popen(
            [gxx, "-std=c++20", "-O1", "-shared", "-fPIC", f"-I{SHIM}", "-o",
             str(out / f"{name}.so"), str(cpp), "-lpthread"],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    logs = {name: p.communicate()[0] for name, p in procs.items()}
    for name, p in procs.items():
        assert p.returncode == 0, logs[name]
    libs = {name: ctypes.CDLL(str(out / f"{name}.so")) for name in build.SOURCES}
    for (lib, sym), (argtypes, restype) in build.SIGNATURES.items():
        fn = getattr(libs[lib], sym)
        fn.argtypes, fn.restype = argtypes, restype
    return libs


def _params(n_par, d, hidden, n_layers, seed):
    """Random weights in the canonical layout: He-scaled hidden layers and
    every array moved by 0.05 N(0, 1), n_par outputs per transformed dim."""
    g = torch.Generator().manual_seed(seed)
    params = []
    for l in range(n_layers):
        da = (d + 1) // 2 if l % 2 == 0 else d // 2
        sizes = [da, hidden, hidden, n_par * (d - da)]
        ws = [(torch.randn(sizes[i:i + 2], generator=g) * (2.0 / sizes[i]) ** 0.5 if i < 2
               else torch.zeros(sizes[i:i + 2])) + 0.05 * torch.randn(sizes[i:i + 2], generator=g)
              for i in range(3)]
        bs = [0.05 * torch.randn(sizes[i + 1], generator=g) for i in range(3)]
        params.append({"w": ws, "b": bs})
    return params


def _rel_err(got, want):
    pairs = list(zip([got[0], *cops._leaves(got[1])], [want[0], *cops._leaves(want[1])]))
    scale = max(1.0, max(float(b.abs().max()) for _, b in pairs))
    return max(float((a - b).abs().max()) for a, b in pairs) / scale


def _run(libs, kind, n_bins, params, x, inverse):
    """Forward and backward of the stack through the kernels' C entries."""
    n, d = x.shape
    hidden, n_layers = params[0]["w"][1].shape[0], len(params)
    packed = cops.pack_weights(params)
    g = torch.Generator().manual_seed(n)
    gy, gld = torch.randn((n, d), generator=g), torch.randn((n,), generator=g)
    y, ld = torch.empty_like(x), torch.empty(n)
    gx, grads = torch.empty_like(x), torch.empty_like(packed)
    if kind == "affine":
        assert libs["coupling"].nfmc_coupling_stack(
            x.data_ptr(), packed.data_ptr(), y.data_ptr(), ld.data_ptr(), n, d, hidden, n_layers,
            3.0, int(inverse), None) == 0
        scratch = torch.full((libs["coupling_bwd"].nfmc_coupling_vjp_scratch_floats(
            n, d, hidden, n_layers),), float("nan"))
        assert libs["coupling_bwd"].nfmc_coupling_stack_vjp(
            x.data_ptr(), gy.data_ptr(), gld.data_ptr(), packed.data_ptr(), gx.data_ptr(),
            grads.data_ptr(), scratch.data_ptr(), n, d, hidden, n_layers, 3.0, int(inverse),
            None) == 0
        ref = cops.realnvp_stack_plain(params, x, 3.0, inverse)
        ref_vjp = cops.realnvp_stack_vjp_plain(params, x, gy, gld, 3.0, inverse)
    else:
        lrs = int(kind == "lrs")
        assert libs["spline"].nfmc_spline_stack(
            x.data_ptr(), packed.data_ptr(), y.data_ptr(), ld.data_ptr(), n, d, hidden, n_layers,
            n_bins, 5.0, int(inverse), lrs, None) == 0
        scratch = torch.full((libs["spline_bwd"].nfmc_spline_vjp_scratch_floats(
            n, d, hidden, n_layers, n_params_per_dim(kind, n_bins)),), float("nan"))
        assert libs["spline_bwd"].nfmc_spline_stack_vjp(
            x.data_ptr(), gy.data_ptr(), gld.data_ptr(), packed.data_ptr(), gx.data_ptr(),
            grads.data_ptr(), scratch.data_ptr(), n, d, hidden, n_layers, n_bins, 5.0,
            int(inverse), lrs, None) == 0
        ref = sops.spline_stack_plain(params, x, kind, n_bins, 5.0, inverse)
        ref_vjp = sops.spline_stack_vjp_plain(params, x, gy, gld, kind, n_bins, 5.0, inverse)
    return (y, ld), ref, (gx, cops.unpack_like(grads, params)), ref_vjp


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("kind,n_bins", [("affine", 0), ("rqs", 4), ("rqs", 8), ("lrs", 4),
                                         ("lrs", 8)])
@pytest.mark.parametrize("d,hidden,n_layers,rows", [(7, 16, 3, 37), (10, 32, 2, 70)])
def test_host_kernels_match_plain(host_libs, kind, n_bins, inverse, d, hidden, n_layers, rows):
    """An odd and an even d, a partial last block; inputs 3 N(0, 1), so
    that the splines' tails are hit."""
    n_par = 2 if kind == "affine" else n_params_per_dim(kind, n_bins)
    params = _params(n_par, d, hidden, n_layers, seed=d + n_bins)
    x = 3 * torch.randn((rows, d), generator=torch.Generator().manual_seed(1))
    (y, ld), (y_ref, ld_ref), got, want = _run(host_libs, kind, n_bins, params, x, inverse)
    scale = max(1.0, float(y_ref.abs().max()), float(ld_ref.abs().max()))
    assert float((y - y_ref).abs().max()) <= TOL * scale
    assert float((ld - ld_ref).abs().max()) <= TOL * scale
    assert _rel_err(got, want) <= (TOL if kind == "affine" else SPLINE_BWD_TOL)


@pytest.mark.parametrize("kind", ["affine", "rqs", "lrs"])
def test_host_kernels_with_several_rows_a_warp(host_libs, kind):
    """Enough rows that the launchers give each warp 2 rows (RealNVP: 4),
    the branch the larger batches on the card take."""
    n_par = 2 if kind == "affine" else n_params_per_dim(kind, 4)
    params = _params(n_par, 5, 8, 2, seed=3)
    rows = 4300 if kind != "affine" else 8500
    x = 3 * torch.randn((rows, 5), generator=torch.Generator().manual_seed(2))
    (y, ld), (y_ref, ld_ref), got, want = _run(host_libs, kind, 4, params, x, False)
    scale = max(1.0, float(y_ref.abs().max()), float(ld_ref.abs().max()))
    assert float((y - y_ref).abs().max()) <= TOL * scale
    assert float((ld - ld_ref).abs().max()) <= TOL * scale
    assert _rel_err(got, want) <= (TOL if kind == "affine" else SPLINE_BWD_TOL)
