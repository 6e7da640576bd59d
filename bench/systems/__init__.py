"""Systems under test, one module each, found by the name a configuration
gives under ``"system"`` (``bench/systems/<system>.py``; ``layout`` where
it gives none).  A module imports the program it drives, so the harness's
import of it is the program's import, timed in set-up.  Its interface is
in ``bench/harness.py``'s docstring."""
