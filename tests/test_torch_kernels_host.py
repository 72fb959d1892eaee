"""The CUDA kernels of nfmc_torch/csrc/ compiled as C++ for the CPU and run
there against their plain PyTorch versions.

``tests/host_cuda/cuda_runtime.h`` emulates the few CUDA features the
kernels use (threads, warp barriers, shuffles, shared memory), so the
kernels' indexing, layouts, row blocking and the spline's hand-written VJP
are checked on every CPU run, without a card. The emulated card has 2 SMs,
so the RealNVP launchers, which size their row tiles by the SM count, reach
every tile size below a few hundred rows. The card's own compiler,
timing and memory model are not: ``tests/test_torch_kernels.py`` and
``chip_smoke.py`` cover those on an H100. The kernels run through their
C entry points, with the same arguments the wrappers pass.

Tolerances as on the card: the forward to 1e-4 * max(1, max|ref|); the
backward to 1e-4 (RealNVP) and 2e-4 (splines, whose steep maps amplify
rounding) times max(1, max|ref|)."""
import ctypes
import math
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
H100_BLOCK_BYTES = 232448  # the shared memory one block can opt into


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


def _grids(lib):
    """grid.x of each launch of ``lib`` since ``_run`` began."""
    n = ctypes.c_int.in_dll(lib, "emu_launches").value
    return list((ctypes.c_uint * 16).in_dll(lib, "emu_grid_x")[:n])


def _run(libs, kind, n_bins, params, x, inverse):
    """Forward and backward of the stack through the kernels' C entries."""
    for lib in libs.values():
        ctypes.c_int.in_dll(lib, "emu_launches").value = 0
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
    _check(_run(host_libs, kind, n_bins, params, x, inverse), kind)


def _check(got_want, kind):
    (y, ld), (y_ref, ld_ref), got, want = got_want
    scale = max(1.0, float(y_ref.abs().max()), float(ld_ref.abs().max()))
    assert float((y - y_ref).abs().max()) <= TOL * scale
    assert float((ld - ld_ref).abs().max()) <= TOL * scale
    assert _rel_err(got, want) <= (TOL if kind == "affine" else SPLINE_BWD_TOL)


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("d,hidden,n_layers,rows", [
    (7, 16, 3, 1),      # one row: a tile of 8 with 7 rows of padding
    (9, 40, 2, 45),     # odd d; H=40, a partial 32-row slab; a partial last tile
    (11, 136, 2, 21),   # K=136 in 5 slabs, N=136 in two column passes
    (100, 128, 4, 37),  # full width: 4 slabs over H=128, N = 2 db = 100
])
def test_host_realnvp_tile_edges(host_libs, inverse, d, hidden, n_layers, rows):
    """The RealNVP kernels at the edges of their row tile and weight slabs."""
    params = _params(2, d, hidden, n_layers, seed=d + hidden)
    x = 3 * torch.randn((rows, d), generator=torch.Generator().manual_seed(5))
    _check(_run(host_libs, "affine", 0, params, x, inverse), "affine")


def _tile_bytes(libs, d, hidden, backward):
    if backward:
        return libs["coupling_bwd"].nfmc_coupling_vjp_tile_bytes(d, hidden)
    return libs["coupling"].nfmc_coupling_tile_bytes(d, hidden)


def _launch_one_row(libs, d, hidden, backward):
    """The launcher's return for one row of a one-layer stack."""
    params = _params(2, d, hidden, 1, seed=1)
    packed = cops.pack_weights(params)
    x = torch.randn((1, d), generator=torch.Generator().manual_seed(0))
    gx, y, ld = torch.empty_like(x), torch.empty_like(x), torch.empty(1)
    grads = torch.empty_like(packed)
    if backward:
        lib = libs["coupling_bwd"]
        scratch = torch.empty((lib.nfmc_coupling_vjp_scratch_floats(1, d, hidden, 1),))
        return lib.nfmc_coupling_stack_vjp(
            x.data_ptr(), x.data_ptr(), ld.fill_(1.0).data_ptr(), packed.data_ptr(), gx.data_ptr(),
            grads.data_ptr(), scratch.data_ptr(), 1, d, hidden, 1, 3.0, 0, None)
    return libs["coupling"].nfmc_coupling_stack(
        x.data_ptr(), packed.data_ptr(), y.data_ptr(), ld.data_ptr(), 1, d, hidden, 1, 3.0, 0, None)


@pytest.mark.parametrize("backward", [False, True])
def test_host_kernels_refuse_where_the_wrapper_does(host_libs, backward):
    """At the widest d whose 8-row tile fits an H100 block (H=8, one layer,
    one row) the launcher runs the kernel; one wider it refuses without a
    launch, and the wrapper turns that into an error naming the bytes."""
    d = max(n for n in range(2, 4000) if _tile_bytes(host_libs, n, 8, backward) <= H100_BLOCK_BYTES)
    lib = host_libs["coupling_bwd" if backward else "coupling"]
    assert _launch_one_row(host_libs, d, 8, backward) == 0
    ctypes.c_int.in_dll(lib, "emu_launches").value = 0
    err = _launch_one_row(host_libs, d + 1, 8, backward)
    assert err == cops.TILE_TOO_LARGE
    assert ctypes.c_int.in_dll(lib, "emu_launches").value == 0
    with pytest.raises(ValueError, match=f"{_tile_bytes(host_libs, d + 1, 8, backward)} bytes of "
                                         "shared memory"):
        cops.check_launch(err, d + 1, 8, backward, lib)


def test_kernel_launcher_names_the_shared_memory_it_needs(host_libs):
    """The launchers' count of a tile's bytes: 8 rows of state ([even | odd],
    52 + 52 floats at d=100; backward the state and its cotangent, 2 x 104),
    two activation buffers (128 each) and a log-det; two layers' biases
    (128 + 128 + 104); three weight slabs of 128 x 68 and the split-k partial
    tiles (64 x 128). Wide targets still fit: d=1024 at H=128, both ways."""
    fixed = 2 * 360 + 3 * 128 * 68 + 64 * 128
    assert _tile_bytes(host_libs, 100, 128, False) == 4 * (8 * (104 + 256 + 1) + fixed)
    assert _tile_bytes(host_libs, 100, 128, True) == 4 * (8 * (2 * 104 + 256 + 1) + fixed)
    for backward in (False, True):
        assert _tile_bytes(host_libs, 1024, 128, backward) <= H100_BLOCK_BYTES


@pytest.mark.parametrize("event_shape", [(5,), (100,), (8, 8)])
def test_registry_flows_fit_the_kernels_shared_memory(host_libs, event_shape):
    """The registry's RealNVP at its default widths fits the launchers' row
    tile, both ways (the spline flows: tests/test_torch_flows.py)."""
    from nfmc_torch.api.registry import create_flow_object

    flow = create_flow_object("realnvp", event_shape, seed=0)
    d, hidden = math.prod(event_shape), int(flow.params[0]["w"][1].shape[0])
    for backward in (False, True):
        assert _tile_bytes(host_libs, d, hidden, backward) <= H100_BLOCK_BYTES


@pytest.mark.parametrize("inverse", [False, True])
def test_host_realnvp_wide_target(host_libs, inverse):
    """d=784 at H=128: the conditioning half (392) and the output layer (784
    columns, 7 chunks) wider than the activation buffers."""
    params = _params(2, 784, 128, 2, seed=7)
    x = 3 * torch.randn((3, 784), generator=torch.Generator().manual_seed(8))
    _check(_run(host_libs, "affine", 0, params, x, inverse), "affine")


@pytest.mark.parametrize("kind,rows,tile", [
    pytest.param("affine", 10, 8, id="affine-r8"),
    pytest.param("affine", 60, 32, id="affine-r32"),
    pytest.param("affine", 200, 64, id="affine"),
    pytest.param("rqs", 4300, None, id="rqs"),
    pytest.param("lrs", 4300, None, id="lrs"),
])
def test_host_kernels_with_several_rows_a_warp(host_libs, kind, rows, tile):
    """The splines: enough rows that the launchers give each warp 2 rows
    (RQS: 4), the branch the larger batches on the card take. RealNVP: each
    row tile its launchers pick on the emulated 2 SMs (8 or 32 rows a block
    while 2 blocks hold the batch, else 64), checked from the launches'
    grids."""
    n_par = 2 if kind == "affine" else n_params_per_dim(kind, 4)
    params = _params(n_par, 5, 8, 2, seed=3)
    x = 3 * torch.randn((rows, 5), generator=torch.Generator().manual_seed(2))
    _check(_run(host_libs, kind, 4, params, x, False), kind)
    if kind == "affine":
        blocks = -(-rows // tile)
        assert _grids(host_libs["coupling"]) == [blocks]
        assert _grids(host_libs["coupling_bwd"])[0] == blocks
