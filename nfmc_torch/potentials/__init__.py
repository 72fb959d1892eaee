"""Target potentials: batched torch callables ``U: (B, *event) -> (B,)``."""
from .applied import BayesianLogisticRegression, EightSchools, Phi4Lattice, StudentT
from .base import CallablePotential, Potential, as_potential
from .synthetic import (
    DiagonalGaussian,
    DiagonalGaussian1,
    DoubleWell,
    FullRankGaussian,
    Funnel,
    GaussianMixture,
    Rosenbrock,
    StandardGaussian,
)

__all__ = ["Potential", "CallablePotential", "as_potential", "StandardGaussian",
           "DiagonalGaussian", "DiagonalGaussian1", "FullRankGaussian", "Funnel", "Rosenbrock",
           "GaussianMixture", "DoubleWell", "BayesianLogisticRegression", "EightSchools",
           "Phi4Lattice", "StudentT"]
