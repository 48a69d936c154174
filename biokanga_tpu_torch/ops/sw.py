"""Scoring defaults and move codes of the banded Smith-Waterman.

Copied from biokanga_tpu/ops/sw.py:30-40 (that module imports jax).
"""
NEG = -(10**7)

# default PacBio-ish scoring (cf. SSW.h defaults: match 1, mismatch -1,
# gap open -3, gap extend -1 in the reference's SW service)
DEFAULT_MATCH = 1
DEFAULT_MISMATCH = -1
DEFAULT_GAP_OPEN = -3
DEFAULT_GAP_EXT = -1

# traceback codes
TB_STOP, TB_DIAG, TB_UP, TB_LEFT = 0, 1, 2, 3
