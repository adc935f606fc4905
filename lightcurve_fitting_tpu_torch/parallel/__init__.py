"""Samplers: the stretch-move ensemble sampler, its host (numpy) copy, the
population fit (many transients, an ensemble each) and the simulation-based
calibration that runs on it."""

from .host_sampler import HostEnsembleSampler  # noqa: F401
from .sampler import EnsembleSampler, make_stretch_kernel  # noqa: F401
from .population import (pack_population, fit_population,  # noqa: F401
                         population_goodness_of_fit, population_information_criteria,
                         population_compare_elpd)
from .sbc import (simulation_based_calibration, rank_statistic,  # noqa: F401
                  uniformity_pvalues, plot_sbc)
