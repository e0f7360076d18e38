"""Runtime configuration (the analog of the reference's layered flag system,
reference SURVEY §5: DIST_DEBUG_LEVEL / DIST_THROW_ON_ERROR compile flags +
env vars).  Everything is env-var driven and read once at import:

  DISTRIBUTIONS_TPU_DEBUG      0 (off, default) .. 3 (paranoid)
                               — gates debug.validate_* checks
  DISTRIBUTIONS_TPU_DPD_CAP    default dense value capacity for dpd
  DISTRIBUTIONS_TPU_BLOCK      default Gibbs tile size
"""

import os


def _int_env(name, default):
    try:
        return int(os.environ.get(name, default))
    except ValueError:
        return default


DEBUG_LEVEL = _int_env('DISTRIBUTIONS_TPU_DEBUG', 0)
DPD_CAPACITY = _int_env('DISTRIBUTIONS_TPU_DPD_CAP', 64)
DEFAULT_BLOCK = _int_env('DISTRIBUTIONS_TPU_BLOCK', 8192)
