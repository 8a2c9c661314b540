"""One driver per traffic ``kind`` (``prefill``, ``a2a``):
``run(cell, seed, seconds, trace, start=...)`` builds the program from the
cell's files, warms it up, runs the measured (or the traced) window,
frees the program and judges its outputs against the reference.  It
returns a dict that ``run.py`` turns into the result line."""
