"""Model zoo: analytical supernova light-curve models on torch tensors.

Public surface mirrors ``lightcurve_fitting_tpu.models`` for the models this
slice of the port covers.
"""

from ..core.constants import k_B, c1, c2, c3, c4  # noqa: F401
from ..ops.mathx import power  # noqa: F401
from .base import Model, LogLikelihood, format_unit  # noqa: F401
from .priors import (Prior, UniformPrior, LogUniformPrior, GaussianPrior,  # noqa: F401
                     KDEPrior)
from .blackbody import (planck_fast, planck, blackbody_to_filters, planck_lnu,  # noqa: F401
                        bandflux_pointwise, bandflux_outer)
from .shock_cooling import BaseShockCooling, ShockCooling2, ShockCooling3  # noqa: F401
from .companion_shocking import (BaseCompanionShocking, CompanionShocking,  # noqa: F401
                                 CompanionShocking2, CompanionShocking3, sifto, M_chandra)
