"""Flow registry and the ``"<name>%<json kwargs>"`` flow-string DSL
(e.g. ``'realnvp%{"n_layers": 10}'``). Ported so far: RealNVP and the coupling
spline flows ``c-rqnsf`` and ``c-lrsnsf`` (with the aliases of
``nfmc_tpu/api/registry.py``); every other flow of ``nfmc_tpu``'s registry is
ROADMAP 1.7."""
from __future__ import annotations

import hashlib
import json

from ..flows import CouplingLRS, CouplingRQNSF, Flow, RealNVP

REALNVP_NAMES = ("realnvp", "real_nvp", "rnvp")
# name (and its aliases) -> bijection class
FLOWS = {
    **{n: RealNVP for n in REALNVP_NAMES},
    **{n: CouplingRQNSF for n in ("c-rqnsf", "c-rqsnsf")},
    **{n: CouplingLRS for n in ("c-lrsnsf", "c-lrnsf")},
}


def _stable_hash(s: str) -> int:
    return int.from_bytes(hashlib.sha256(s.encode()).digest()[:8], "big")


def parse_flow_string(flow_string: str) -> dict:
    """``"<name>%<json>"`` or ``"<name>"``."""
    if flow_string is None:
        return {"name": None, "kwargs": {}, "hash": _stable_hash("None")}
    if "%" not in flow_string:
        return {"name": flow_string, "kwargs": {}, "hash": _stable_hash(flow_string)}
    flow_name = flow_string.split("%")[0]
    kwargs = json.loads(flow_string.split("%", 1)[1])
    return {"name": flow_name, "kwargs": kwargs, "hash": _stable_hash(flow_name + str(kwargs))}


def create_flow_object(flow_string: str, event_shape, **kwargs) -> Flow:
    """Build a Flow from a registry name (+ DSL kwargs)."""
    flow_data = parse_flow_string(flow_string)
    flow_name = flow_data["name"]
    kwargs = {**kwargs, **flow_data["kwargs"]}
    if not isinstance(flow_name, str):
        raise ValueError(f"bad flow name: {flow_name!r}")
    if flow_name not in FLOWS:
        raise NotImplementedError(
            f"flow {flow_name!r} is not ported to nfmc_torch yet (ROADMAP 1.7); "
            f"ported: {', '.join(FLOWS)}")
    seed = kwargs.pop("seed", None)
    return Flow(FLOWS[flow_name](event_shape, **kwargs), seed=seed)


# Strategies of nfmc_tpu's registry that the port does not run yet, with the
# ROADMAP item that ports each: none left.
UNPORTED_STRATEGIES: dict = {}
# the MCMC and the NFMC lists of nfmc_tpu/api/registry.py, in their order
PORTED_STRATEGIES = ("hmc", "uhmc", "ula", "mala", "mh", "ess", "nuts", "pt_mala", "pt_mh",
                     "pt_hmc", "aies", "chees_hmc", "dense_hmc", "dense_mala",
                     "imh", "fixed_imh", "adaptive_imh", "jump_mala", "jump_ula", "jump_hmc",
                     "jump_uhmc", "jump_ess", "jump_mh", "jump_nuts", "jump_aies", "jump_chees",
                     "neutra_mh", "neutra_hmc", "neutra_chees", "tess", "dlmc")
