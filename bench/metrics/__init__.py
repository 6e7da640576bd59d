"""Per-layer metric readers, one module each, found by the metric's name
(or by its name up to the last dot, for a reader that serves every
suffix).  A reader's ``read(ctx, name)`` returns the metric's value, or
None where the run gave it nothing to read: the harness then leaves the
metric out of the result."""
