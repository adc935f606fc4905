"""Samplers: the stretch-move ensemble sampler, and its host (numpy) copy."""

from .host_sampler import HostEnsembleSampler  # noqa: F401
from .sampler import EnsembleSampler, make_stretch_kernel  # noqa: F401
