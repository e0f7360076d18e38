"""distributions_tpu: a JAX-native probabilistic-inference engine.

A from-scratch JAX/XLA implementation of the capabilities of
`forcedotcom/distributions` (the reference): special numerical
functions, samplers, conjugate component models, clustering priors
(Pitman-Yor/CRP and low-entropy MDL), and vectorized mixture machinery with
collapsed Gibbs sampling as the core kernel.

Where the reference offers three "flavors" (dbg: pure python, hp: cython,
lp: C++ wrappers; reference doc/overview.rst:18-34), this package offers one
functional JAX core that runs in three modes filling the same roles:

- eager (un-jitted, interpretable, pdb-able)     ~ dbg
- jit (XLA compiled, single definition)          ~ hp
- fused batched kernels over [rows, K] tiles     ~ lp (see ops/, mixture.py)

plus `distributions_tpu.compat`, an object-oriented facade mirroring the
reference's `Shared/Group/Sampler/Scorer/Mixture` class API so existing users
can switch with minimal edits.

All entropy is explicit: functions consuming randomness take a
`jax.random` key (counter-based, layout-independent), replacing the
reference's single sequential `global_rng` (reference src/random.cc:33).
"""

__version__ = '0.1.0'

from distributions_tpu import special  # noqa: F401
from distributions_tpu import random  # noqa: F401
from distributions_tpu import util  # noqa: F401
