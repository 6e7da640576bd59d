"""Data-graph generators, one module each, found by the name a
configuration's ``graph.generator`` gives.  Each has ``generate(**params)``
returning a dict with ``n``, ``edges`` ((E, 2) canonical u < v, sorted),
``coords`` (n, 2), and the generator's own ``features`` and ``labels``."""
