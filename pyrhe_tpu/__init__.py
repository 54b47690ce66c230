"""pyrhe_tpu — randomized Haseman-Elston regression on an accelerator.

A from-scratch JAX implementation of genome-wide heritability
estimation with the capabilities of sriramlab/PyRHE: RHE (additive),
RHE-DOM (additive+dominance) and GENIE (gene-environment) models, each with
in-memory and streaming execution, jackknife standard errors, covariate
projection, multi-trait phenotypes, enrichment/liability reporting and
SUMRHE trace-summary export.
"""
__version__ = "0.1.0"

from .models import (GENIE, RHE, RHE_DOM, StreamingGENIE, StreamingRHE,
                     StreamingRHE_DOM)
from .utils.logger import Logger

__all__ = ["RHE", "StreamingRHE", "RHE_DOM", "StreamingRHE_DOM", "GENIE",
           "StreamingGENIE", "Logger", "__version__"]
