"""Traffic: each mix a data file, ``<traffic>.json``, found by the name
``BENCHMARK.json`` gives a cell's ``traffic``, holding the ``generator``
that reads it and its ``params``; each generator a module,
``<generator>.py``.  A generator has ``Traffic(system, seed, params)``
(its set-up: inputs and weights from the seed, the program's entry made
and warmed up), whose ``train`` says whether a step trains (the whole
step's FLOPs count the backward and the update), ``call(k)`` is one step
of the window, ``window(result)`` the end-to-end metrics of a window,
``release()`` drops the program's entry, and ``check(limits)`` is the
comparison with the plain reference once the program has been released.
A generator over the GNN layout also gives ``mode``, the forward's
aggregation path, for the readers of that layer."""
