"""Checkpoint and resume of sampler state, as ``nfmc_tpu/checkpoint.py``.

A sampler's resumable state (chain positions, the tuned kernel state of
every nested sampler, the flow's parameters, the run's base seed) is a tree
of tensors, arrays and Python scalars. A checkpoint is that tree's leaves
and a JSON metadata dict in one ``numpy.savez`` file, written atomically;
its structure is checked against the loader's by a signature of every
leaf's key path. :func:`sample_resumable` runs a sampler in checkpointed
segments and resumes after a crash, bit-exactly: segment i is seeded with
:func:`segment_seed` of the run's base seed, which the checkpoint stores.
With ``save_samples=True`` each segment's draws go to a ``.seg<i>.npy``
sidecar beside the npz.

The JAX package's Orbax backend (``save_checkpoint_orbax``) has no
counterpart: Orbax is a JAX library.
"""
from __future__ import annotations

import copy
import dataclasses
import glob
import json
import os
import warnings
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from .core.chains import ChainShard, is_sharded
from .core.rng import next_seed

# The on-disk format: a key-path tree signature is required, and a file
# without one is refused.
CHECKPOINT_FORMAT_VERSION = 1

_SCALARS = (bool, int, float, np.generic)


def _children(node):
    """``[(path entry, child)]`` of a tree node, or None for a leaf: dicts by
    sorted key, lists and tuples by index, dataclasses by field; None has
    no children and no leaf."""
    if isinstance(node, dict):
        return [(["k", str(k)], node[k]) for k in sorted(node)]
    if isinstance(node, (list, tuple)):
        return [(["i", i], v) for i, v in enumerate(node)]
    if dataclasses.is_dataclass(node) and not isinstance(node, type):
        return [(["a", f.name], getattr(node, f.name)) for f in dataclasses.fields(node)]
    if node is None:
        return []
    if isinstance(node, (torch.Tensor, np.ndarray) + _SCALARS):
        return None
    raise TypeError(f"not a checkpoint tree node: {type(node).__name__}")


def _flatten(tree) -> List[Tuple[list, Any]]:
    """``[(key path, leaf)]`` in a fixed order."""
    kids = _children(tree)
    if kids is None:
        return [([], tree)]
    return [([entry, *path], leaf) for entry, child in kids for path, leaf in _flatten(child)]


def _unflatten(like, leaves):
    """The tree shaped like ``like`` holding ``leaves`` in :func:`_flatten`'s
    order, each converted to its ``like`` leaf's kind: a tensor on the like
    leaf's device (in the saved dtype), a Python scalar, or an array."""
    it = iter(leaves)

    def build(node):
        kids = _children(node)
        if kids is None:
            a = next(it)
            if isinstance(node, torch.Tensor):
                return torch.from_numpy(np.array(a)).to(node.device)
            if isinstance(node, bool):
                return bool(a)
            if isinstance(node, int):
                return int(a)
            if isinstance(node, float):
                return float(a)
            return np.array(a)
        built = [build(child) for _, child in kids]
        if isinstance(node, dict):
            by_key = dict(zip(sorted(node), built))
            return {k: by_key[k] for k in node}
        if isinstance(node, (list, tuple)):
            return list(built) if isinstance(node, list) else tuple(built)
        if node is None:
            return None
        new = copy.copy(node)
        for (entry, _), value in zip(kids, built):
            object.__setattr__(new, entry[1], value)
        return new

    return build(like)


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    if isinstance(leaf, bool):
        return np.asarray(leaf, dtype=np.bool_)
    if isinstance(leaf, int):
        return np.asarray(leaf, dtype=np.int64)
    if isinstance(leaf, float):
        return np.asarray(leaf, dtype=np.float64)
    return np.asarray(leaf)


def _tree_signature(state: Any) -> str:
    """The structure of a tree as the JSON list of its leaves' key paths:
    two trees match iff every leaf sits at the same path."""
    return json.dumps([path for path, _ in _flatten(state)], separators=(",", ":"))


def _npz_path(path) -> str:
    path = str(path)
    return path if path.endswith(".npz") else path + ".npz"


def _save_state_npz(path: str, state: Any, metadata: Optional[Dict] = None,
                    extra_arrays: Optional[Dict[str, np.ndarray]] = None) -> None:
    """The one writer of the format: ``leaf_<i>`` arrays in flatten order,
    any extra arrays, the signature as ``__tree_signature__`` bytes and as a
    metadata field, and ``__meta__`` as JSON bytes; atomic (a temporary
    file and ``os.replace``)."""
    path = _npz_path(path)
    arrays = {f"leaf_{i}": _to_numpy(leaf) for i, (_, leaf) in enumerate(_flatten(state))}
    if extra_arrays:
        arrays.update(extra_arrays)
    sig = _tree_signature(state)
    arrays["__tree_signature__"] = np.frombuffer(sig.encode(), dtype=np.uint8)
    meta = dict(metadata or {})
    meta.setdefault("tree_signature", sig)
    meta.setdefault("format_version", CHECKPOINT_FORMAT_VERSION)
    arrays["__meta__"] = np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8)
    tmp = path + ".tmp.npz"
    np.savez(tmp, **arrays)
    os.replace(tmp, path)  # a crash mid-save keeps the old file


def _meta(data) -> Dict:
    return json.loads(bytes(data["__meta__"].tobytes()).decode())


def _saved_signature(path: str, data, meta: Dict) -> Optional[str]:
    """The file's signature; refuses a file of another format version."""
    if meta.get("format_version") != CHECKPOINT_FORMAT_VERSION:
        raise ValueError(f"checkpoint {path} has format_version {meta.get('format_version')}, "
                         f"this package reads {CHECKPOINT_FORMAT_VERSION}: re-create it")
    if "__tree_signature__" in data.files:
        return bytes(data["__tree_signature__"].tobytes()).decode()
    return meta.get("tree_signature")


def save_checkpoint(path: str, state: Any, metadata: Optional[Dict] = None) -> None:
    """Save a tree of tensors / arrays / scalars (and JSON metadata) to
    ``path`` (.npz)."""
    _save_state_npz(path, state, metadata)


def load_checkpoint(path: str, like: Any) -> Tuple[Any, Dict]:
    """Load a checkpoint of :func:`save_checkpoint` into the structure of
    ``like`` (whose leaves are replaced; tensors land on their ``like``
    leaf's device). Refuses a file whose signature differs from ``like``'s
    (same-shaped leaves would load into the wrong slots) or that carries
    none."""
    path = _npz_path(path)
    data = np.load(path)
    meta = _meta(data)
    saved_sig = _saved_signature(path, data, meta)
    if saved_sig is None:
        raise ValueError(f"checkpoint {path} carries no key-path tree signature: its structure "
                         "cannot be validated. Re-create it.")
    sig = _tree_signature(like)
    if saved_sig != sig:
        raise ValueError(f"checkpoint {path} does not match `like`'s structure (saved leaf "
                         f"paths {saved_sig}, like {sig})")
    n = len(_flatten(like))
    state = _unflatten(like, [data[f"leaf_{i}"] for i in range(n)])
    # the writer's own fields; the caller's metadata round-trips unchanged
    meta.pop("tree_signature", None)
    meta.pop("format_version", None)
    return state, meta


def sampler_state(sampler, x, seed: int) -> Dict[str, Any]:
    """A sampler's resumable state: the chains ``x``, the run's base
    ``seed``, the kernel's ``make_state``, the flow's parameters, and the
    same for a nested ``inner_sampler`` (NeuTra and the jump samplers hold
    the tuned Metropolis state there)."""
    state: Dict[str, Any] = {"x": x, "seed": int(seed)}
    kernel = sampler.kernel
    if hasattr(kernel, "make_state"):
        state["kernel"] = kernel.make_state(getattr(sampler, "device", "cpu"))
    flow = getattr(kernel, "flow", None)
    if flow is not None:
        state["flow_params"] = flow.params
    inner = getattr(sampler, "inner_sampler", None)
    if inner is not None:
        state["inner"] = sampler_state(inner, x, seed)
        del state["inner"]["x"], state["inner"]["seed"]  # kept at the top only
    return state


def _apply_sampler_level(sampler, state: Dict[str, Any]) -> None:
    """Apply one level's kernel and flow state, then recurse into
    ``state["inner"]``, as deep as :func:`sampler_state` walks."""
    kernel = sampler.kernel
    if "kernel" in state and hasattr(kernel, "sync_from_state"):
        kernel.sync_from_state(state["kernel"])
    if "flow_params" in state and getattr(kernel, "flow", None) is not None:
        kernel.flow.params = state["flow_params"]
    inner = getattr(sampler, "inner_sampler", None)
    if inner is not None and "inner" in state:
        _apply_sampler_level(inner, state["inner"])


def restore_sampler_state(sampler, state: Dict[str, Any]):
    """Apply a saved state to a sampler; returns ``(x, seed)``."""
    _apply_sampler_level(sampler, state)
    return state["x"], int(state["seed"])


def segment_seed(base_seed: int, i: int) -> int:
    """Segment ``i``'s seed: a fixed function of the run's base seed and
    ``i`` (the JAX package folds ``i`` into its base key)."""
    return int(np.random.SeedSequence([int(base_seed) % 2**63, int(i)]).generate_state(
        1, dtype=np.uint64)[0] >> np.uint64(2))


# --------------------------------------------------------------------------
# segmented, resumable sampling
# --------------------------------------------------------------------------

def _numeric_stats(stats) -> Dict[str, float]:
    """The additive numeric fields of a statistics object: the counters
    (with a subclass's own) and the elapsed time."""
    out = {}
    for f in dataclasses.fields(stats):
        v = getattr(stats, f.name)
        if isinstance(v, (int, float)) and not isinstance(v, bool):
            out[f.name] = v
    return out


def _merge_segment_stats(combined: Optional[Dict], stats, event_shape) -> Dict:
    """Fold one segment's statistics into ``combined``: counters add, the
    moments average weighted by the draws each saw."""
    fm = stats.expectations["first_moment"]
    sm = stats.expectations["second_moment"]
    seg = {
        "counters": _numeric_stats(stats),
        "fm": np.broadcast_to(np.asarray(fm.running_value, dtype=np.float64), event_shape).copy(),
        "sm": np.broadcast_to(np.asarray(sm.running_value, dtype=np.float64), event_shape).copy(),
        "n_seen": int(fm.n_seen),
    }
    if combined is None:
        return seg
    total = combined["n_seen"] + seg["n_seen"]
    if total > 0:
        w0, w1 = combined["n_seen"] / total, seg["n_seen"] / total
        combined["fm"] = w0 * combined["fm"] + w1 * seg["fm"]
        combined["sm"] = w0 * combined["sm"] + w1 * seg["sm"]
        combined["n_seen"] = total
    for k, v in seg["counters"].items():
        combined["counters"][k] = combined["counters"].get(k, 0) + v
    return combined


def _load_combined_into(stats, combined) -> None:
    """Overwrite a statistics object's counters and moments with ``combined``."""
    for k, v in combined["counters"].items():
        if hasattr(stats, k):
            setattr(stats, k, type(getattr(stats, k))(v))
    for name, key in (("first_moment", "fm"), ("second_moment", "sm")):
        exp = stats.expectations[name]
        exp.running_value = np.asarray(combined[key], dtype=np.float64)
        exp.n_seen = int(combined["n_seen"])


def _collect_extras(sampler, prefix: str = "") -> Dict[str, np.ndarray]:
    """Tuned state outside ``make_state`` / ``sync_from_state``: a sampler's
    ``extra_resumable_state()`` (ESS's ellipse, PT's hot rungs,
    AdaptiveIMH's schedule position), through nested samplers with dotted
    prefixes."""
    out: Dict[str, np.ndarray] = {}
    fn = getattr(sampler, "extra_resumable_state", None)
    if fn is not None:
        for k, v in fn().items():
            out[f"{prefix}{k}"] = _to_numpy(v)
    inner = getattr(sampler, "inner_sampler", None)
    if inner is not None:
        out.update(_collect_extras(inner, prefix + "inner."))
    return out


def _restore_extras(sampler, extras: Dict[str, np.ndarray], prefix: str = "") -> None:
    own = {k[len(prefix):]: v for k, v in extras.items()
           if k.startswith(prefix) and "." not in k[len(prefix):]}
    fn = getattr(sampler, "restore_extra_resumable_state", None)
    if fn is not None and own:
        fn(own)
    inner = getattr(sampler, "inner_sampler", None)
    if inner is not None:
        _restore_extras(inner, extras, prefix + "inner.")


def _seg_samples_path(path: str, i: int) -> str:
    return f"{path}.seg{i}.npy"


def discard_resumable_checkpoint(path: str) -> None:
    """Remove a :func:`sample_resumable` checkpoint, its segment sidecars
    (by glob, so that orphans of a crash go too) and a leftover temporary
    npz of a crash mid-save."""
    path = _npz_path(path)
    for f in glob.glob(glob.escape(path) + ".seg*.npy"):
        os.remove(f)
    for f in (path + ".tmp.npz", path):
        if os.path.exists(f):
            os.remove(f)


def _load_segment_blocks(path, sample_segments, mem_blocks=None) -> List[np.ndarray]:
    """Each segment's draws, this process's copies first; a missing sidecar
    is a warning (the statistics cover the run without it)."""
    blocks = []
    for i in sample_segments:
        if mem_blocks is not None and i in mem_blocks:
            blocks.append(mem_blocks[i])
            continue
        f = _seg_samples_path(path, i)
        if os.path.exists(f):
            blocks.append(np.load(f))
        else:
            warnings.warn(f"resumable checkpoint sidecar {f} is missing; the output omits that "
                          "segment's stored draws (the statistics cover the whole run)")
    return blocks


def _set_draws(rs, draws: np.ndarray, device) -> None:
    """Make ``draws`` (iterations, chains, *event) a sample store's whole
    history, on the device when it stores there."""
    t = torch.from_numpy(draws)
    rs._running = [t.to(device) if rs.on_device else t]
    rs.n_samples = len(draws)


def _rebuild_completed_output(sampler, x, combined, sample_segments, path, event_shape):
    """The output of a run whose checkpoint is already complete (the process
    died between the last segment's save and the caller's cleanup)."""
    from .core import statistics as _statistics
    from .core.output import MCMCOutput

    stats_cls = getattr(_statistics, combined.get("stats_class", "MCMCStatistics"),
                        _statistics.MCMCStatistics)
    blocks = _load_segment_blocks(path, sample_segments)
    out = MCMCOutput(event_shape, statistics=stats_cls(event_shape), kernel=sampler.kernel,
                     store_samples=bool(blocks),
                     on_device=bool(getattr(sampler.params, "store_samples_on_device", False)))
    _load_combined_into(out.statistics, combined)
    out.running_samples.last_sample = x
    if blocks:
        _set_draws(out.running_samples, np.concatenate(blocks, axis=0), sampler.device)
    return out


def checkpoint_writer(x0, shard_fn=None) -> bool:
    """Whether this process writes a run's checkpoint files: always, unless
    the run is chain-sharded (``x0`` a DTensor, or a ``shard_fn``) over a
    process group, where global rank 0 alone writes the files that every
    rank would write alike."""
    import torch.distributed as dist

    sharded = is_sharded(x0) or shard_fn is not None
    return not (sharded and dist.is_available() and dist.is_initialized()) or dist.get_rank() == 0


def sample_resumable(sampler, x0, checkpoint_path: str, *, segment_iterations: Optional[int] = None,
                     generator: Optional[torch.Generator] = None, seed: Optional[int] = None,
                     show_progress: bool = False, save_samples: Optional[bool] = None,
                     shard_fn=None):
    """Run ``sampler.sample`` as checkpointed segments; resume after a crash.

    ``sampler.params.n_iterations`` is cut into segments of
    ``segment_iterations`` (default: about 10 segments). After each segment
    the whole resumable state (:func:`sampler_state`, every nested
    sampler's ``extra_resumable_state``, the merged statistics and the base
    seed) is written atomically to ``checkpoint_path``. A call with the same
    arguments resumes after the last completed segment. Segment i runs with
    ``segment_seed(base, i)``; the base seed is ``seed``, else drawn from
    ``generator`` or the global stream, and on a resume it comes from the
    checkpoint, so a resumed run equals an uninterrupted segmented one bit
    for bit. The first segment enters through ``sample``, every later one
    through ``sample_continue``.

    ``save_samples=True`` keeps every segment's draws in a ``.seg<i>.npy``
    sidecar. None means False on a fresh run and, on a resume, the
    checkpoint's own setting; an explicit value that contradicts the
    checkpoint raises. Without sidecars the last segment's draws ride in the
    npz when small (8 MB stored on the device, 64 MB on the host), so that a
    completed checkpoint rebuilds the same output.

    The checkpoint stays on disk after completion: a re-call rebuilds the
    finished output from it. Delete it with
    :func:`discard_resumable_checkpoint` (``sample()`` does so on success).

    ``shard_fn`` maps the chains (all of them, as a plain tensor) to what a
    segment starts from; it is applied between segments and on resume.
    ``sample(..., mesh=...)`` passes :func:`nfmc_torch.parallel.shard_chains`
    on its mesh, so that every segment runs chain-sharded (``x0`` is then a
    DTensor too); the checkpoint holds all the chains, and only global rank
    0 writes it.
    """
    n_total = int(sampler.params.n_iterations)
    if segment_iterations is None:
        segment_iterations = max(1, -(-n_total // 10))
    n_segments = -(-n_total // segment_iterations)
    event_shape = tuple(sampler.event_shape)
    path = _npz_path(checkpoint_path)
    writer = checkpoint_writer(x0, shard_fn)
    if seed is not None:
        base_seed = int(seed)
    elif generator is not None:
        base_seed = int(torch.randint(0, 2**62, (1,), generator=generator,
                                      device=generator.device).item())
    else:
        base_seed = next_seed()
    if is_sharded(x0):
        # x: what a segment starts from; x_all: all the chains
        base_seed = ChainShard(x0.device_mesh).agree_seed(base_seed)
        x, x_all = x0, x0.full_tensor().to(sampler.device)
    else:
        x = x_all = torch.as_tensor(x0, dtype=torch.float32, device=sampler.device)
    start_segment = 0
    combined: Optional[Dict] = None
    sample_segments: list = []

    if n_segments == 0:
        return sampler.sample(x, show_progress=show_progress, seed=base_seed)

    if os.path.exists(path):
        data = np.load(path, allow_pickle=False)
        meta = _meta(data)
        # every check of the configuration before the sampler is touched
        if meta.get("n_total") != n_total or meta.get("segment_iterations") != segment_iterations:
            raise ValueError(
                f"checkpoint {path} was written for n_iterations={meta.get('n_total')} / "
                f"segment_iterations={meta.get('segment_iterations')} but this call uses "
                f"{n_total} / {segment_iterations}: delete it (discard_resumable_checkpoint) "
                "or match the original configuration")
        if meta.get("x_shape") is not None and tuple(meta["x_shape"]) != tuple(x.shape):
            raise ValueError(
                f"checkpoint {path} holds chains of shape {tuple(meta['x_shape'])} but this call "
                f"passed x0 of shape {tuple(x.shape)}: delete it (discard_resumable_checkpoint) "
                "or match the original run")
        saved_flag = bool(meta.get("save_samples"))
        if meta.get("sampler_store_samples") is not None and (
                bool(meta["sampler_store_samples"]) != bool(sampler.params.store_samples)):
            raise ValueError(
                f"checkpoint {path} was written by a sampler with params.store_samples="
                f"{meta['sampler_store_samples']} but this sampler has "
                f"{bool(sampler.params.store_samples)}: rebuild the sampler to match or delete "
                "the checkpoint (discard_resumable_checkpoint)")
        if save_samples is None:
            save_samples = saved_flag
        elif bool(save_samples) != saved_flag:
            raise ValueError(
                f"checkpoint {path} was written with save_samples={saved_flag} but this call "
                f"passed save_samples={bool(save_samples)}: a flip would drop whole segments "
                "from the stored draws; pass None to adopt the checkpoint's setting, or delete "
                "the checkpoint (discard_resumable_checkpoint)")
        # the extra state first: it can change the kernel state's structure
        # (ESS: no Cholesky factor -> one), which the signature must see
        _restore_extras(sampler, {k[len("extra__"):]: data[k] for k in data.files
                                  if k.startswith("extra__")})
        like = sampler_state(sampler, x_all, base_seed)
        saved_sig = _saved_signature(path, data, meta)
        if saved_sig is None:
            raise ValueError(f"checkpoint {path} carries no key-path tree signature: delete it "
                             "(discard_resumable_checkpoint) and restart")
        if saved_sig != _tree_signature(like):
            raise ValueError(
                f"checkpoint {path} does not match this sampler's state structure (saved "
                f"{saved_sig}, got {_tree_signature(like)}): was it written by a differently "
                "configured sampler? Its extra resumable state was already applied; rebuild "
                "the sampler before reusing it.")
        state = _unflatten(like, [data[f"leaf_{i}"] for i in range(len(_flatten(like)))])
        x, base_seed = restore_sampler_state(sampler, state)
        x = x_all = torch.as_tensor(x, dtype=torch.float32, device=sampler.device)
        if shard_fn is not None:
            x = shard_fn(x)
        start_segment = int(meta["segment"])
        combined = {"counters": meta["counters"], "fm": data["fm"], "sm": data["sm"],
                    "n_seen": int(meta["n_seen"]),
                    "stats_class": meta.get("stats_class", "MCMCStatistics")}
        sample_segments = list(meta.get("sample_segments", []))
        if start_segment >= n_segments:
            out = _rebuild_completed_output(sampler, x_all, combined, sample_segments, path,
                                            event_shape)
            if not sample_segments and "last_seg_samples" in data.files:
                # without sidecars the normal return carries the last
                # segment's draws: so does the rebuild
                out.store_samples = out.running_samples.store_samples = True
                _set_draws(out.running_samples, data["last_seg_samples"], sampler.device)
            return out

    save_samples = bool(save_samples)
    if save_samples and not sampler.params.store_samples:
        raise ValueError("save_samples=True but the sampler has params.store_samples=False: the "
                         "segments would have no draws to save; enable store_samples or pass "
                         "save_samples=False")
    out = None
    mem_blocks: Dict[int, np.ndarray] = {}
    for i in range(start_segment, n_segments):
        sampler.params.n_iterations = min(segment_iterations, n_total - i * segment_iterations)
        try:
            # the first segment enters the run (ESS's prior redraw, DLMC's
            # first step happen once); every later one continues it
            entry = sampler.sample if i == 0 else sampler.sample_continue
            out = entry(x, show_progress=show_progress, seed=segment_seed(base_seed, i))
        finally:
            sampler.params.n_iterations = n_total
        x = x_all = torch.as_tensor(out.running_samples.last_sample, dtype=torch.float32,
                                    device=sampler.device)
        if shard_fn is not None:
            x = shard_fn(x)
        combined = _merge_segment_stats(combined, out.statistics, event_shape)
        combined["stats_class"] = type(out.statistics).__name__

        last_seg_draws = None
        rs = out.running_samples
        if rs.n_samples > 0 and save_samples:
            seg_draws = rs.as_tensor().cpu().numpy()
            if writer:
                tmp = _seg_samples_path(path, i) + ".tmp.npy"
                np.save(tmp, seg_draws)
                os.replace(tmp, _seg_samples_path(path, i))
            mem_blocks[i] = seg_draws
            sample_segments.append(i)
        elif rs.n_samples > 0 and i == n_segments - 1:
            est_bytes = rs.n_samples * int(np.prod(rs.last_sample.shape)) * 4
            if est_bytes <= (8 if rs.on_device else 64) * 2**20:
                last_seg_draws = rs.as_tensor().cpu().numpy()

        extra_arrays = {f"extra__{k}": v for k, v in _collect_extras(sampler).items()}
        extra_arrays["fm"], extra_arrays["sm"] = combined["fm"], combined["sm"]
        if last_seg_draws is not None:
            extra_arrays["last_seg_samples"] = last_seg_draws
        if not writer:
            continue
        _save_state_npz(path, sampler_state(sampler, x_all, base_seed), metadata={
            "segment": i + 1, "n_segments": n_segments, "n_total": n_total,
            "segment_iterations": segment_iterations, "x_shape": list(x.shape),
            "save_samples": save_samples,
            "sampler_store_samples": bool(sampler.params.store_samples),
            "counters": combined["counters"], "n_seen": combined["n_seen"],
            "stats_class": combined["stats_class"], "sample_segments": sample_segments,
        }, extra_arrays=extra_arrays)

    _load_combined_into(out.statistics, combined)
    if save_samples and sample_segments:
        blocks = _load_segment_blocks(path, sample_segments, mem_blocks)
        if blocks:
            _set_draws(out.running_samples, np.concatenate(blocks, axis=0), sampler.device)
    return out
