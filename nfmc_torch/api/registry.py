"""Flow and sampler registries and the ``"<name>%<json kwargs>"`` flow-string
DSL (e.g. ``'realnvp%{"n_layers": 10}'``), the counterpart of
``nfmc_tpu/api/registry.py``: the same canonical flow names, aliases and
family taxonomy, and the same strategy lists. ``create_flow_object`` builds
every one of the 48 canonical names (``PORTED_FLOWS``) and their aliases; a
name the registry does not know raises ``ValueError``, as in the JAX
package."""
from __future__ import annotations

import hashlib
import json
from typing import Dict, List

from ..flows import (
    FFJORD,
    IAF,
    MAF,
    NICE,
    RNODE,
    AffineGlow,
    ConvolutionalDDB,
    ConvolutionalFFJORD,
    ConvolutionalInvertibleResNet,
    ConvolutionalResFlow,
    ConvolutionalRNODE,
    DeepDenseSigmoidGlow,
    DeepDiffeomorphicBijection,
    DeepSigmoidGlow,
    DenseSigmoidGlow,
    LRSGlow,
    MultiscaleDeepDenseSigmoid,
    MultiscaleDeepSigmoid,
    MultiscaleDenseSigmoid,
    MultiscaleLRSNSF,
    MultiscaleNICE,
    MultiscaleRealNVP,
    MultiscaleRQNSF,
    OTFlow,
    RQSGlow,
    ShiftGlow,
    CouplingDeepDenseSF,
    CouplingDeepSF,
    CouplingDenseSF,
    CouplingLRS,
    CouplingRQNSF,
    Flow,
    InverseAutoregressiveDeepDenseSF,
    InverseAutoregressiveDeepSF,
    InverseAutoregressiveDenseSF,
    InverseAutoregressiveLRS,
    InverseAutoregressiveRQNSF,
    InvertibleResNet,
    MaskedAutoregressiveDeepDenseSF,
    MaskedAutoregressiveDeepSF,
    MaskedAutoregressiveDenseSF,
    MaskedAutoregressiveLRS,
    MaskedAutoregressiveRQNSF,
    PlanarFlow,
    ProximalResFlow,
    RadialFlow,
    RealNVP,
    ResFlow,
    SylvesterFlow,
)

FLOW_REFERENCE_DATA = {
    "realnvp": {"alt": ["realnvp", "real_nvp", "rnvp"], "family": ("autoregressive", "coupling", "affine")},
    "ms-realnvp": {"alt": ["ms-realnvp", "multiscale-realnvp"], "family": ("autoregressive", "multiscale", "affine")},
    "glow-realnvp": {"alt": ["affine-glow", "glow-affine", "glow"], "family": ("autoregressive", "multiscale", "affine")},
    "maf": {"alt": [], "family": ("autoregressive", "masked", "affine")},
    "iaf": {"alt": [], "family": ("autoregressive", "masked", "affine")},
    "nice": {"alt": [], "family": ("autoregressive", "coupling", "affine")},
    "ms-nice": {"alt": ["ms-nice", "multiscale-nice"], "family": ("autoregressive", "multiscale", "affine")},
    "glow-nice": {"alt": ["shift-glow", "glow-shift"], "family": ("autoregressive", "multiscale", "affine")},
    "c-rqnsf": {"alt": ["c-rqsnsf"], "family": ("autoregressive", "coupling", "spline")},
    "ms-rqnsf": {"alt": ["ms-rqnsf", "multiscale-rqnsf"], "family": ("autoregressive", "multiscale", "spline")},
    "glow-rqnsf": {"alt": ["rqs-glow", "glow-rqs"], "family": ("autoregressive", "multiscale", "spline")},
    "ma-rqnsf": {"alt": ["ma-rqsnsf", "maf-rqsnsf", "maf-rqnsf"], "family": ("autoregressive", "masked", "spline")},
    "ia-rqnsf": {"alt": ["ia-rqsnsf", "iaf-rqsnsf", "iaf-rqnsf"], "family": ("autoregressive", "masked", "spline")},
    "c-lrsnsf": {"alt": ["c-lrnsf"], "family": ("autoregressive", "coupling", "spline")},
    "ms-lrsnsf": {"alt": ["ms-lrsnsf", "multiscale-lrsnsf"], "family": ("autoregressive", "multiscale", "spline")},
    "glow-lrsnsf": {"alt": ["lrs-glow", "glow-lrs"], "family": ("autoregressive", "multiscale", "spline")},
    "ma-lrsnsf": {"alt": ["ma-lrnsf", "maf-lrsnsf", "maf-lrnsf"], "family": ("autoregressive", "masked", "spline")},
    "ia-lrsnsf": {"alt": ["ia-lrnsf", "iaf-lrsnsf", "iaf-lrnsf"], "family": ("autoregressive", "masked", "spline")},
    "c-naf-deep": {"alt": [], "family": ("autoregressive", "coupling", "nn")},
    "ms-naf-deep": {"alt": ["ms-naf-deep", "multiscale-naf-deep"], "family": ("autoregressive", "multiscale", "nn")},
    "glow-naf-deep": {"alt": ["naf-deep-glow", "glow-naf-deep"], "family": ("autoregressive", "multiscale", "nn")},
    "ma-naf-deep": {"alt": ["maf-naf-deep"], "family": ("autoregressive", "masked", "nn")},
    "ia-naf-deep": {"alt": ["iaf-naf-deep"], "family": ("autoregressive", "masked", "nn")},
    "c-naf-deep-dense": {"alt": [], "family": ("autoregressive", "coupling", "nn")},
    "ms-naf-deep-dense": {"alt": ["ms-naf-deep-dense", "multiscale-naf-deep-dense"], "family": ("autoregressive", "multiscale", "nn")},
    "glow-naf-deep-dense": {"alt": ["naf-deep-dense-glow", "glow-naf-deep-dense"], "family": ("autoregressive", "multiscale", "nn")},
    "ma-naf-deep-dense": {"alt": ["maf-naf-deep-dense"], "family": ("autoregressive", "masked", "nn")},
    "ia-naf-deep-dense": {"alt": ["iaf-naf-deep-dense"], "family": ("autoregressive", "masked", "nn")},
    "c-naf-dense": {"alt": [], "family": ("autoregressive", "coupling", "nn")},
    "ms-naf-dense": {"alt": ["ms-naf-dense", "multiscale-naf-dense"], "family": ("autoregressive", "multiscale", "nn")},
    "glow-naf-dense": {"alt": ["naf-dense-glow", "glow-naf-dense"], "family": ("autoregressive", "multiscale", "nn")},
    "ma-naf-dense": {"alt": ["maf-naf-dense"], "family": ("autoregressive", "masked", "nn")},
    "ia-naf-dense": {"alt": ["iaf-naf-dense"], "family": ("autoregressive", "masked", "nn")},
    "i-resnet": {"alt": ["iresnet", "invertible resnet", "invertible-resnet", "i-resnet"], "family": ("residual", "iterative", "standard")},
    "conv-i-resnet": {"alt": ["conv-iresnet", "convolutional invertible resnet", "conv-invertible-resnet", "conv-i-resnet"], "family": ("residual", "iterative", "convolutional")},
    "resflow": {"alt": ["resflow", "residual flow", "residual-flow", "res-flow"], "family": ("residual", "iterative", "standard")},
    "conv-resflow": {"alt": ["conv-resflow", "convolutional residual flow", "conv-residual-flow", "conv-res-flow"], "family": ("residual", "iterative", "convolutional")},
    "proximal-resflow": {"alt": ["proximal-resflow", "p-resflow", "presflow", "proximal resflow"], "family": ("residual", "iterative", "standard")},
    "planar": {"alt": [], "family": ("residual", "matrix-det")},
    "radial": {"alt": [], "family": ("residual", "matrix-det")},
    "sylvester": {"alt": [], "family": ("residual", "matrix-det")},
    "ot-flow": {"alt": ["ot-flow", "otflow", "ot flow"], "family": ("continuous", "standard")},
    "ffjord": {"alt": ["ffjord"], "family": ("continuous", "standard")},
    "conv-ffjord": {"alt": ["conv-ffjord"], "family": ("continuous", "convolutional")},
    # Quirk kept for parity: the reference reuses 'ddnf' as conv-ddb's alias
    # and 'rnode' as conv-rnode's (``nfmc/util.py:68-71``), so those aliases
    # resolve to the NON-conv canonical names and the conv variants are only
    # reachable by their canonical names.
    "ddb": {"alt": ["ddnf"], "family": ("continuous", "standard")},
    "conv-ddb": {"alt": ["ddnf"], "family": ("continuous", "convolutional")},
    "rnode": {"alt": ["rnode"], "family": ("continuous", "standard")},
    "conv-rnode": {"alt": ["rnode"], "family": ("continuous", "convolutional")},
}


def get_flow_family(flow: str):
    try:
        return FLOW_REFERENCE_DATA[flow]["family"]
    except KeyError:
        for key in FLOW_REFERENCE_DATA:
            if flow in FLOW_REFERENCE_DATA[key]["alt"]:
                return FLOW_REFERENCE_DATA[key]["family"]
    raise KeyError(f"Flow {flow} not found in reference data")


def _subset(pred) -> Dict[str, List[str]]:
    return {
        k: [k] + FLOW_REFERENCE_DATA[k]["alt"]
        for k in FLOW_REFERENCE_DATA
        if pred(FLOW_REFERENCE_DATA[k]["family"])
    }


COUPLING_FLOW_NAMES = _subset(lambda f: f[0] == "autoregressive" and f[1] == "coupling")
AFFINE_AUTOREGRESSIVE_FLOW_NAMES = _subset(
    lambda f: f[0] == "autoregressive" and f[2:] and f[2] == "affine" and f[1] in ("coupling", "masked")
)
SPLINE_AUTOREGRESSIVE_FLOW_NAMES = _subset(
    lambda f: f[0] == "autoregressive" and f[2:] and f[2] == "spline" and f[1] in ("coupling", "masked")
)
NEURAL_AUTOREGRESSIVE_FLOW_NAMES = _subset(
    lambda f: f[0] == "autoregressive" and f[2:] and f[2] == "nn" and f[1] in ("coupling", "masked")
)
MULTISCALE_FLOW_NAMES = _subset(lambda f: f[0] == "autoregressive" and f[1] == "multiscale")
AUTOREGRESSIVE_FLOW_NAMES = {
    **AFFINE_AUTOREGRESSIVE_FLOW_NAMES,
    **SPLINE_AUTOREGRESSIVE_FLOW_NAMES,
    **NEURAL_AUTOREGRESSIVE_FLOW_NAMES,
    **MULTISCALE_FLOW_NAMES,
}
CONTINUOUS_FLOW_NAMES = _subset(lambda f: f[0] == "continuous")
RESIDUAL_FLOW_NAMES = _subset(lambda f: f[0] == "residual")
RESIDUAL_MATRIX_DET_FLOW_NAMES = _subset(lambda f: f[0] == "residual" and f[1] == "matrix-det")
RESIDUAL_CONTRACTIVE_FLOW_NAMES = _subset(lambda f: f[0] == "residual" and f[1] != "matrix-det")

FLOW_NAMES: Dict[str, List[str]] = {
    **AUTOREGRESSIVE_FLOW_NAMES,
    **CONTINUOUS_FLOW_NAMES,
    **RESIDUAL_FLOW_NAMES,
}


def flatten_name_dictionary(d: Dict[str, List[str]]) -> List[str]:
    flat = list(d.keys())
    for value in d.values():
        flat.extend(value)
    return sorted(set(flat))


def is_flow_supported(flow_name: str) -> bool:
    return flow_name in flatten_name_dictionary(FLOW_NAMES)


def get_supported_autoregressive_flows(synonyms: bool = True):
    return flatten_name_dictionary(AUTOREGRESSIVE_FLOW_NAMES) if synonyms else sorted(AUTOREGRESSIVE_FLOW_NAMES)


def get_supported_residual_flows(synonyms: bool = True):
    return flatten_name_dictionary(RESIDUAL_FLOW_NAMES) if synonyms else sorted(RESIDUAL_FLOW_NAMES)


def get_supported_continuous_flows(synonyms: bool = True):
    return flatten_name_dictionary(CONTINUOUS_FLOW_NAMES) if synonyms else sorted(CONTINUOUS_FLOW_NAMES)


def get_supported_normalizing_flows(synonyms: bool = True):
    return sorted(
        set(
            get_supported_autoregressive_flows(synonyms)
            + get_supported_residual_flows(synonyms)
            + get_supported_continuous_flows(synonyms)
        )
    )


# canonical name -> constructor, for every canonical name of the registry
PORTED_FLOWS = {
    "realnvp": RealNVP,
    "nice": NICE,
    "maf": MAF,
    "iaf": IAF,
    "c-rqnsf": CouplingRQNSF,
    "ma-rqnsf": MaskedAutoregressiveRQNSF,
    "ia-rqnsf": InverseAutoregressiveRQNSF,
    "c-lrsnsf": CouplingLRS,
    "ma-lrsnsf": MaskedAutoregressiveLRS,
    "ia-lrsnsf": InverseAutoregressiveLRS,
    "c-naf-deep": CouplingDeepSF,
    "c-naf-deep-dense": CouplingDeepDenseSF,
    "c-naf-dense": CouplingDenseSF,
    "ia-naf-deep": InverseAutoregressiveDeepSF,
    "ia-naf-deep-dense": InverseAutoregressiveDeepDenseSF,
    "ia-naf-dense": InverseAutoregressiveDenseSF,
    "ma-naf-deep": MaskedAutoregressiveDeepSF,
    "ma-naf-deep-dense": MaskedAutoregressiveDeepDenseSF,
    "ma-naf-dense": MaskedAutoregressiveDenseSF,
    "i-resnet": InvertibleResNet,
    "resflow": ResFlow,
    "proximal-resflow": ProximalResFlow,
    "planar": PlanarFlow,
    "radial": RadialFlow,
    "sylvester": SylvesterFlow,
    "ot-flow": OTFlow,
    "ffjord": FFJORD,
    "ddb": DeepDiffeomorphicBijection,
    "rnode": RNODE,
    "ms-realnvp": MultiscaleRealNVP,
    "ms-nice": MultiscaleNICE,
    "ms-rqnsf": MultiscaleRQNSF,
    "ms-lrsnsf": MultiscaleLRSNSF,
    "ms-naf-deep": MultiscaleDeepSigmoid,
    "ms-naf-deep-dense": MultiscaleDeepDenseSigmoid,
    "ms-naf-dense": MultiscaleDenseSigmoid,
    "glow-realnvp": AffineGlow,
    "glow-nice": ShiftGlow,
    "glow-rqnsf": RQSGlow,
    "glow-lrsnsf": LRSGlow,
    "glow-naf-deep": DeepSigmoidGlow,
    "glow-naf-dense": DenseSigmoidGlow,
    "glow-naf-deep-dense": DeepDenseSigmoidGlow,
    "conv-i-resnet": ConvolutionalInvertibleResNet,
    "conv-resflow": ConvolutionalResFlow,
    "conv-ffjord": ConvolutionalFFJORD,
    "conv-rnode": ConvolutionalRNODE,
    "conv-ddb": ConvolutionalDDB,
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


def canonical_flow_name(flow_name: str) -> str:
    """The canonical name of a registry name or alias (``ValueError`` for a
    name the registry does not know), resolved as the JAX package does."""
    if not isinstance(flow_name, str):
        raise ValueError(f"bad flow name: {flow_name!r}")
    if not is_flow_supported(flow_name):
        raise ValueError(f"unsupported flow: {flow_name!r}")
    if flow_name in FLOW_REFERENCE_DATA:
        return flow_name
    return next(key for key, names in FLOW_NAMES.items() if flow_name in names)


def create_flow_object(flow_string: str, event_shape, **kwargs) -> Flow:
    """Build a Flow from a registry name or alias (+ DSL kwargs)."""
    flow_data = parse_flow_string(flow_string)
    kwargs = {**kwargs, **flow_data["kwargs"]}
    canonical = canonical_flow_name(flow_data["name"])
    seed = kwargs.pop("seed", None)
    return Flow(PORTED_FLOWS[canonical](event_shape, **kwargs), seed=seed)


# Strategies of nfmc_tpu's registry that the port does not run yet, with the
# ROADMAP item that ports each: none left.
UNPORTED_STRATEGIES: dict = {}
# the MCMC and the NFMC lists of nfmc_tpu/api/registry.py, in their order
MCMC_STRATEGIES = ("hmc", "uhmc", "ula", "mala", "mh", "ess", "nuts", "pt_mala", "pt_mh",
                   "pt_hmc", "aies", "chees_hmc", "dense_hmc", "dense_mala")
NFMC_STRATEGIES = ("imh", "fixed_imh", "adaptive_imh", "jump_mala", "jump_ula", "jump_hmc",
                   "jump_uhmc", "jump_ess", "jump_mh", "jump_nuts", "jump_aies", "jump_chees",
                   "neutra_mh", "neutra_hmc", "neutra_chees", "tess", "dlmc")
PORTED_STRATEGIES = MCMC_STRATEGIES + NFMC_STRATEGIES


def get_supported_mcmc_samplers() -> List[str]:
    return list(MCMC_STRATEGIES)


def get_supported_nfmc_samplers() -> List[str]:
    return list(NFMC_STRATEGIES)


def get_supported_samplers() -> List[str]:
    return get_supported_mcmc_samplers() + get_supported_nfmc_samplers()
