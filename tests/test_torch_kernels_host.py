"""The CUDA kernels of nfmc_torch/csrc/ compiled as C++ for the CPU and run
there against their plain PyTorch versions.

``tests/host_cuda/cuda_runtime.h`` emulates the few CUDA features the
kernels use (threads, warp barriers, shuffles, shared memory), so the
kernels' indexing, layouts, row blocking and the spline's hand-written VJP
are checked on every CPU run, without a card. The emulated card has 2 SMs,
so the launchers, which size their row tiles by the SM count, reach every
tile size below a few hundred rows. The card's own compiler,
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
from nfmc_torch.utils import tree_leaves

SHIM = build.CSRC.parents[1] / "tests" / "host_cuda"
TOL, SPLINE_BWD_TOL = 1e-4, 2e-4
H100_BLOCK_BYTES = 232448  # the shared memory one block can opt into


def _host_source(src) -> str:
    text = src.read_text()
    text = text.replace("extern __shared__ float smem[];", "float* smem = (float*)emu_smem;")
    text = re.sub(r"([\w:]+(?:<[^<>;]*>)?)<<<([^;]*?)>>>\(", r"emu_launch(EmuCfg{\2}, \1, ", text)
    return text.replace('#include "', f'#include "{build.CSRC}/')


def host_build(names, out) -> dict:
    """Compile the sources ``names`` (keys of ``build.SOURCES``) for the CPU
    into ``out``, all g++ processes at once, and load them with the
    ``build.SIGNATURES`` of their symbols: ``{name: CDLL}``. Skips the
    calling test without g++."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to compile the kernels for the CPU")
    procs = {}
    for name in names:
        cpp = out / f"{name}.cpp"
        cpp.write_text(_host_source(build.SOURCES[name]))
        procs[name] = subprocess.Popen(
            [gxx, "-std=c++20", "-O1", "-shared", "-fPIC", f"-I{SHIM}", "-o",
             str(out / f"{name}.so"), str(cpp), "-lpthread"],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    logs = {name: p.communicate()[0] for name, p in procs.items()}
    for name, p in procs.items():
        assert p.returncode == 0, logs[name]
    libs = {name: ctypes.CDLL(str(out / f"{name}.so")) for name in names}
    for (lib, sym), (argtypes, restype) in build.SIGNATURES.items():
        if lib in libs:
            fn = getattr(libs[lib], sym)
            fn.argtypes, fn.restype = argtypes, restype
    return libs


@pytest.fixture(scope="module")
def host_libs(tmp_path_factory):
    return host_build(build.SOURCES, tmp_path_factory.mktemp("host_kernels"))


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
    pairs = list(zip([got[0], *tree_leaves(got[1])], [want[0], *tree_leaves(want[1])]))
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


def _spline_tile_bytes(libs, d, hidden, backward):
    if backward:
        return libs["spline_bwd"].nfmc_spline_vjp_tile_bytes(d, hidden)
    return libs["spline"].nfmc_spline_tile_bytes(d, hidden)


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
    """The launchers' count of their smallest tile's bytes, the one a
    refusal names: 8 rows of state ([even | odd], 52 + 52 floats at d=100;
    the backward's cotangent takes the state's buffer after its recompute),
    two activation buffers (128 each) and a log-det; two layers' hidden
    biases (128 + 128); a ring of two weight slabs of 128 x 68 and the
    split-k partial tiles (64 x 128). The spline launchers keep the same
    layout and add a group buffer of eight output chunks (8 x 8 x 128).
    Wide targets fit: d=3500 (RealNVP) and 2700 (splines) at H=128."""
    fixed = 2 * 256 + 2 * 128 * 68 + 64 * 128
    for backward in (False, True):
        assert _tile_bytes(host_libs, 100, 128, backward) == 4 * (8 * (104 + 256 + 1) + fixed)
        assert _tile_bytes(host_libs, 3500, 128, backward) <= H100_BLOCK_BYTES
        for d in (100, 1024, 2700):
            assert (_spline_tile_bytes(host_libs, d, 128, backward)
                    == _tile_bytes(host_libs, d, 128, backward) + 4 * 8 * 8 * 128
                    <= H100_BLOCK_BYTES)


@pytest.mark.parametrize("event_shape", [(5,), (100,), (8, 8)])
@pytest.mark.parametrize("name", ["realnvp", "c-rqnsf", "c-lrsnsf"])
def test_registry_flows_fit_the_kernels_shared_memory(host_libs, name, event_shape):
    """The registry's coupling flows at their default widths fit the
    launchers' row tile, both ways, by the launchers' own count of their
    smallest tile's bytes; a spline's raw values a dim fit an output chunk."""
    from nfmc_torch.api.registry import create_flow_object

    flow = create_flow_object(name, event_shape, seed=0)
    d, hidden = math.prod(event_shape), int(flow.params[0]["w"][1].shape[0])
    if name != "realnvp":
        kind = "rqs" if name == "c-rqnsf" else "lrs"
        assert n_params_per_dim(kind, flow.bijection.n_bins) <= 128
    tile_bytes = _tile_bytes if name == "realnvp" else _spline_tile_bytes
    for backward in (False, True):
        assert tile_bytes(host_libs, d, hidden, backward) <= H100_BLOCK_BYTES


@pytest.mark.parametrize("inverse", [False, True])
def test_host_realnvp_wide_target(host_libs, inverse):
    """d=784 at H=128: the conditioning half (392) and the output layer (784
    columns, 7 chunks) wider than the activation buffers."""
    params = _params(2, 784, 128, 2, seed=7)
    x = 3 * torch.randn((3, 784), generator=torch.Generator().manual_seed(8))
    _check(_run(host_libs, "affine", 0, params, x, inverse), "affine")


@pytest.mark.parametrize("kind,rows,tile,bwd_tile", [
    pytest.param("affine", 10, 8, 8, id="affine-r8"),
    pytest.param("affine", 60, 32, 32, id="affine-r32"),
    pytest.param("affine", 200, 64, 64, id="affine"),
    pytest.param("rqs", 10, 8, 8, id="rqs-r8"),
    pytest.param("lrs", 60, 32, 8, id="lrs-r32"),
    pytest.param("rqs", 200, 64, 8, id="rqs"),
    pytest.param("lrs", 200, 64, 8, id="lrs"),
])
def test_host_kernels_with_several_rows_a_warp(host_libs, kind, rows, tile, bwd_tile):
    """Each row tile the launchers pick on the emulated 2 SMs (8 or 32 rows
    a block while 2 blocks hold the batch, else 64; the spline backward
    takes 8 rows a block at every batch), checked from the launches'
    grids."""
    n_par = 2 if kind == "affine" else n_params_per_dim(kind, 4)
    params = _params(n_par, 5, 8, 2, seed=3)
    x = 3 * torch.randn((rows, 5), generator=torch.Generator().manual_seed(2))
    _check(_run(host_libs, kind, 4, params, x, False), kind)
    fwd, bwd = ("coupling", "coupling_bwd") if kind == "affine" else ("spline", "spline_bwd")
    assert _grids(host_libs[fwd]) == [-(-rows // tile)]
    assert _grids(host_libs[bwd])[0] == -(-rows // bwd_tile)


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("kind,n_bins,d,hidden,n_layers,rows", [
    ("rqs", 8, 13, 16, 2, 9),    # 5 dims a chunk (115 columns): chunks of 5 + 2 and 5 + 1
    ("lrs", 8, 15, 24, 3, 40),   # 4 dims a chunk (124 columns), R=32; odd d
    ("rqs", 4, 25, 16, 2, 16),   # 11 dims a chunk (121 columns): 11 + 2 and 11 + 1
    ("lrs", 4, 36, 8, 2, 3),     # 8 dims a chunk (120 columns): 8 + 8 + 2, one row
])
def test_host_spline_chunk_edges(host_libs, kind, n_bins, d, hidden, n_layers, rows, inverse):
    """The spline kernels where a layer's output layer takes several chunks
    of whole dims and the last chunk is partial, forward and VJP."""
    params = _params(n_params_per_dim(kind, n_bins), d, hidden, n_layers, seed=d + n_bins)
    x = 3 * torch.randn((rows, d), generator=torch.Generator().manual_seed(6))
    _check(_run(host_libs, kind, n_bins, params, x, inverse), kind)


def _launch_spline_one_row(libs, d, backward, n_bins=4):
    """The spline launcher's return for one row of a one-layer RQS stack at
    H=8."""
    params = _params(n_params_per_dim("rqs", n_bins), d, 8, 1, seed=1)
    packed = cops.pack_weights(params)
    x = torch.randn((1, d), generator=torch.Generator().manual_seed(0))
    gx, y, ld = torch.empty_like(x), torch.empty_like(x), torch.empty(1)
    grads = torch.empty_like(packed)
    if backward:
        lib = libs["spline_bwd"]
        scratch = torch.empty((lib.nfmc_spline_vjp_scratch_floats(
            1, d, 8, 1, n_params_per_dim("rqs", n_bins)),))
        return lib.nfmc_spline_stack_vjp(
            x.data_ptr(), x.data_ptr(), ld.fill_(1.0).data_ptr(), packed.data_ptr(), gx.data_ptr(),
            grads.data_ptr(), scratch.data_ptr(), 1, d, 8, 1, n_bins, 5.0, 0, 0, None)
    return libs["spline"].nfmc_spline_stack(
        x.data_ptr(), packed.data_ptr(), y.data_ptr(), ld.data_ptr(), 1, d, 8, 1, n_bins, 5.0, 0,
        0, None)


@pytest.mark.parametrize("backward", [False, True])
def test_host_spline_kernels_refuse_where_the_wrapper_does(host_libs, backward):
    """At the widest d whose smallest tile fits an H100 block the spline
    launcher runs (a ring of 2 stages); one wider it refuses without a
    launch, and the wrapper's error names the bytes. A dim of more than 128
    raw values is refused too."""
    d = max(n for n in range(2000, 4000)
            if _spline_tile_bytes(host_libs, n, 8, backward) <= H100_BLOCK_BYTES)
    lib = host_libs["spline_bwd" if backward else "spline"]
    ctypes.c_int.in_dll(lib, "emu_launches").value = 0
    assert _launch_spline_one_row(host_libs, d, backward) == 0
    assert ctypes.c_int.in_dll(lib, "emu_launches").value == 1 + backward
    ctypes.c_int.in_dll(lib, "emu_launches").value = 0
    err = _launch_spline_one_row(host_libs, d + 1, backward)
    assert err == cops.TILE_TOO_LARGE
    assert ctypes.c_int.in_dll(lib, "emu_launches").value == 0
    with pytest.raises(ValueError, match=f"{_spline_tile_bytes(host_libs, d + 1, 8, backward)} "
                                         "bytes of shared memory"):
        sops._check_launch(err, "rqs", 4, d + 1, 8, backward, lib)
    err = _launch_spline_one_row(host_libs, 20, backward, n_bins=44)
    assert err == sops.INVALID_VALUE and ctypes.c_int.in_dll(lib, "emu_launches").value == 0
    with pytest.raises(ValueError, match="at most 128 raw values"):
        sops._check_launch(err, "rqs", 44, 20, 8, backward, lib)
