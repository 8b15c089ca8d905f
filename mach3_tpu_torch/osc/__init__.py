from .pmns import (
    MATTER_A,
    OSC_PHASE,
    hamiltonian_per_km,
    hamiltonian_real,
    mass_matrix,
    pmns_matrix,
    pmns_matrix_real,
)
from .prob import OscParams, probabilities_const_density, probabilities_layered

__all__ = [
    "MATTER_A",
    "OSC_PHASE",
    "hamiltonian_per_km",
    "hamiltonian_real",
    "mass_matrix",
    "pmns_matrix",
    "pmns_matrix_real",
    "OscParams",
    "probabilities_const_density",
    "probabilities_layered",
]
