"""One module per kind of traffic, named by the traffic file's
``driver``.  A driver has

- ``prepare(graph, params, seed)``: the run's state, drawn from the seed
  (the sources, for example);
- ``trial(program, A, state, i)``: the i-th call of the program, from the
  call until its result is on the host; returns that result;
- ``check(graph, state, kept, device)``: compares the kept results
  ``[(i, result)]`` with the plain reference and returns
  ``(checks, failed)``: ``{name: {"value": v, "limit": l}}``, where a run
  is correct when every value is at most its limit, and the number of
  kept results that were wrong;
- ``control(graph, state, i, device)``: what the reference gives for the
  i-th trial where it breaks one guarantee of the configuration, in the
  form ``trial`` returns (``gbbench/control.py`` shows that ``check``
  fails it).
"""

import numpy as np


def rng(seed, stream):
    """A numpy Generator for one use of the seed (``stream`` names it)."""
    return np.random.default_rng([int(seed) % (1 << 64), stream])
