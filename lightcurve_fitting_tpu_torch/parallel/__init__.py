"""Samplers: the stretch-move ensemble sampler, its host (numpy) copy, and
the population fit (many transients, an ensemble each)."""

from .host_sampler import HostEnsembleSampler  # noqa: F401
from .sampler import EnsembleSampler, make_stretch_kernel  # noqa: F401
from .population import (pack_population, fit_population,  # noqa: F401
                         population_goodness_of_fit, population_information_criteria,
                         population_compare_elpd)
