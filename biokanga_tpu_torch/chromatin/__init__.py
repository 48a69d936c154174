"""Port of biokanga_tpu/chromatin/__init__.py: the DNA-conformation and
chromatin subsystem, with the same exports.

The octamer parameter model (CConformation/CTwister,
libbiokanga/Conformation.h, Twister.h) and the MNase site-preference
model shared by prednucleosomes / SimulateMNase / DNAseqSitePotential.
A per-sequence profile is one gather over the octamer table on the
caller's device (`conformation_profile`); the nucleosome models are
host numpy.
"""
from .conformation import (OCT_PARAM_NAMES, load_octamer_params,
                           oligo_indices, step_octamer_indices,
                           conformation_profile)
from .nucleosomes import (load_mnase_prefs, mnase_window_scores,
                          moving_average, baseline_normalise, call_dyads)

__all__ = [
    "OCT_PARAM_NAMES", "load_octamer_params", "oligo_indices",
    "step_octamer_indices", "conformation_profile", "load_mnase_prefs",
    "mnase_window_scores", "moving_average", "baseline_normalise",
    "call_dyads",
]
